// The single-tile checks of the flash kernels' wgmma layouts, for the
// cuda tests only (tests/test_torch_cuda_kernels.py::test_sm90_tile_*
// build and load it; chip_smoke.py and the port's wrappers never do).  It
// includes flash_attention.cu, so it runs the kernels' own TMA maps,
// descriptors, product issues and S -> P re-pack on one tile, against
// torch.matmul: the forward's (k2_maps, qk_issue, pv_issue, sm90::s_to_a)
// and the backward's (bwd_maps, ss_chain, rs_chain), and the fused splash
// backward's dQ form (splash_backward.cu's k5_wgmma: sm90::store_a_sw128,
// sm90::ss_chain_mn over 2-D tensor maps, sm90::encode_bf16_2d).
// cuda_build.py hashes the included source with this one.
//
//   int bf_flash_tile_check(a, b, v, s_out, o_out, D, stream)
//   int bf_flash_bwd_tile_check(a, b, c, s_out, o_out, D, N, stream)
//   int bf_splash_dq_tile_check(a, b, c, s_out, o_out, D, KEYS, N, stream)

#include "flash_attention.cu"

namespace {

// ---------------------------------------------------------------------------
// One consumer warpgroup, one thread issuing the loads.  a [64, D],
// b [128, D] and v [128, D] bf16 (row-major, contiguous); writes
// s = a·bᵀ [64, 128] f32 and o = bf16(s)·v [64, D] f32.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(128)
    k2_tile_check(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tv,
                  float* __restrict__ s_out, float* __restrict__ o_out) {
  using L = WgSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* As = align1024(smem_raw);
  unsigned char* Bs = As + L::Q;
  unsigned char* Vs = Bs + L::KV;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Vs + L::KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(bar, L::Q + 2 * L::KV);
    for (int nb = 0; nb < L::NB; ++nb) {
      sm90::tma_load_4d(As + nb * L::QBOX, &ta, bar, nb * 64, 0, 0, 0);
      sm90::tma_load_4d(Bs + nb * L::KBOX, &tb, bar, nb * 64, 0, 0, 0);
      sm90::tma_load_4d(Vs + nb * L::KBOX, &tv, bar, nb * 64, 0, 0, 0);
    }
  }
  sm90::mbar_wait(bar, 0);
  float sc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] = 0.f;
  qk_issue<D>(sc, As, Bs);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t pf[kBkW / 16][4];
  sm90::s_to_a<kBkW / 8>(pf, sc);
  pv_issue<D>(o, pf, Vs);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  const int row = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < kBkW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s_out[(row + (e >> 1) * 8) * kBkW + n * 8 + 2 * t + (e & 1)] =
          sc[4 * n + e];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_out[(row + (e >> 1) * 8) * D + n * 8 + 2 * t + (e & 1)] = o[4 * n + e];
}

// ---------------------------------------------------------------------------
// The backward's forms on one tile.  a [64, D], b [N, D], c [N, D] bf16;
// writes s = a·bᵀ [64, N] (ss_chain: both K-major; N = 64 is the n64 SS
// form of K3b's Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, N = 128 K3a's S and dP over a
// key tile) and o = bf16(s)·c [64, D] (rs_chain, c MN-major from a tile
// of N rows: K3b's Pᵀ·dO and dSᵀ·Q read dO and Q so, K3a's dS·K reads K).
// ---------------------------------------------------------------------------
template <int D, int N>
__global__ void __launch_bounds__(128)
    bwd_tile_check(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tc,
                   float* __restrict__ s_out, float* __restrict__ o_out) {
  constexpr int NB = D / 64, ABOX = kWgRows * 128, BBOX = N * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* As = align1024(smem_raw);
  unsigned char* Bs = As + NB * ABOX;
  unsigned char* Cs = Bs + NB * BBOX;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Cs + NB * BBOX);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(bar, NB * (ABOX + 2 * BBOX));
    for (int nb = 0; nb < NB; ++nb) {
      sm90::tma_load_4d(As + nb * ABOX, &ta, bar, nb * 64, 0, 0, 0);
      sm90::tma_load_4d(Bs + nb * BBOX, &tb, bar, nb * 64, 0, 0, 0);
      sm90::tma_load_4d(Cs + nb * BBOX, &tc, bar, nb * 64, 0, 0, 0);
    }
  }
  sm90::mbar_wait(bar, 0);
  float sc[N / 2];
  sm90::wgmma_fence();
  ss_chain<D, N>(sc, As, ABOX, Bs, BBOX);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  uint32_t pf[N / 16][4];
  sm90::s_to_a<N / 8>(pf, sc);
  sm90::fence_regs(o);
  sm90::wgmma_fence();
  rs_chain<D, N / 16>(o, pf, Cs, BBOX);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  const int row = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s_out[(row + (e >> 1) * 8) * N + n * 8 + 2 * t + (e & 1)] =
          sc[4 * n + e];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_out[(row + (e >> 1) * 8) * D + n * 8 + 2 * t + (e & 1)] = o[4 * n + e];
}

template <int D, int N>
int launch_bwd_tile_check(const CUtensorMap (&maps)[4], float* so, float* oo,
                          cudaStream_t st) {
  constexpr int bytes =
      (D / 64) * (kWgRows * 128 + 2 * N * 128) + 8 + 1024;
  const int err = set_smem(bwd_tile_check<D, N>, bytes);
  if (err) return err;
  bwd_tile_check<D, N><<<1, 128, bytes, st>>>(maps[0], maps[2], maps[3], so,
                                              oo);
  return 0;
}

// ---------------------------------------------------------------------------
// K5's dQ form on one tile.  a [KEYS, D] (keys, as K), b [64, D] (queries,
// as Q), c [KEYS, D] bf16; writes s = a·bᵀ [KEYS, 64] (sᵀ of K5's
// scores: an n64 SS product of two K-major tiles per 64 keys) and o =
// bf16(s)ᵀ·c [64, D] (the bf16 A operands stored into a swizzled tile with
// keys as rows, then read MN-major as A, with c MN-major as B, N columns
// of c per chain: N = 64 a whole box, N = 32 half a box, its second half
// 64 bytes into the swizzled rows).  KEYS is 64 or 128 (K5's block holds
// 128 keys), N 32 or 64 (its consumers' dQ columns at D 64 and 128).
// ---------------------------------------------------------------------------
template <int D, int KEYS, int N>
__global__ void __launch_bounds__(128)
    k5_dq_tile_check(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb,
                     const __grid_constant__ CUtensorMap tc,
                     float* __restrict__ s_out, float* __restrict__ o_out) {
  constexpr int NB = D / 64, BOX = 64 * 128, TILE = NB * BOX;
  constexpr int G = KEYS / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* As = align1024(smem_raw);  // [group][box][64][64]
  unsigned char* Bs = As + G * TILE;        // [box][64][64]
  unsigned char* Cs = Bs + TILE;            // [group][box][64][64]
  unsigned char* dS = Cs + G * TILE;        // [KEYS][64] swizzled
  uint64_t* bar = reinterpret_cast<uint64_t*>(dS + KEYS * 128);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(bar, (2 * G + 1) * TILE);
    for (int nb = 0; nb < NB; ++nb) {
      sm90::tma_load_2d(Bs + nb * BOX, &tb, bar, nb * 64, 0);
      for (int gi = 0; gi < G; ++gi) {
        sm90::tma_load_2d(As + gi * TILE + nb * BOX, &ta, bar, nb * 64,
                          gi * 64);
        sm90::tma_load_2d(Cs + gi * TILE + nb * BOX, &tc, bar, nb * 64,
                          gi * 64);
      }
    }
  }
  sm90::mbar_wait(bar, 0);
  for (int gi = 0; gi < G; ++gi) {
    float st[32];
    sm90::wgmma_fence();
    ss_chain<D, 64>(st, As + gi * TILE, BOX, Bs, BOX);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    const int row = gi * 64 + warp * 16 + g;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s_out[(row + (e >> 1) * 8) * 64 + n * 8 + 2 * t + (e & 1)] =
            st[4 * n + e];
    uint32_t sf[4][4];
    sm90::s_to_a<8>(sf, st);
    sm90::store_a_sw128(dS, sf, gi * 64);
  }
  sm90::fence_proxy_async();
  sm90::named_barrier(1, 128);
  const int row = warp * 16 + g;
  for (int col0 = 0; col0 < D; col0 += N) {
    float o[N / 2];
    sm90::wgmma_fence();
    sm90::ss_chain_mn<KEYS / 16, N>(
        o, dS, Cs + (col0 / 64) * BOX + (col0 % 64) * 2, TILE);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o_out[(row + (e >> 1) * 8) * D + col0 + n * 8 + 2 * t + (e & 1)] =
            o[4 * n + e];
  }
}

template <int D, int KEYS, int N>
int launch_k5_dq_tile_check(const void* a, const void* b, const void* c,
                            float* so, float* oo, cudaStream_t st) {
  constexpr int TILE = (D / 64) * 64 * 128;
  constexpr int bytes = (2 * (KEYS / 64) + 1) * TILE + KEYS * 128 + 8 + 1024;
  CUtensorMap maps[3];
  int err = sm90::encode_bf16_2d(&maps[0], a, D, KEYS, D * 2, 64, 64);
  if (!err) err = sm90::encode_bf16_2d(&maps[1], b, D, 64, D * 2, 64, 64);
  if (!err) err = sm90::encode_bf16_2d(&maps[2], c, D, KEYS, D * 2, 64, 64);
  if (!err) err = set_smem(k5_dq_tile_check<D, KEYS, N>, bytes);
  if (err) return err;
  k5_dq_tile_check<D, KEYS, N><<<1, 128, bytes, st>>>(maps[0], maps[1],
                                                     maps[2], so, oo);
  return 0;
}

}  // namespace

// a [64, D], b [128, D], v [128, D] bf16; s [64, 128] = a·bᵀ and
// o [64, D] = bf16(s)·v, both f32.  D is 64 or 128.
extern "C" int bf_flash_tile_check(const void* a, const void* b,
                                   const void* v, void* s_out, void* o_out,
                                   int D, void* stream) {
  if (D != 64 && D != 128) return cudaErrorInvalidValue;
  // a as the q of one head (T = 64), b and v as one kv head (S = 128)
  const Shape s = make_shape(1, kWgRows, kBkW, 1, 1, 0, 0, 0, 1.f);
  CUtensorMap maps[3];
  int err = k2_maps(maps, a, b, v, s, D);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* so = static_cast<float*>(s_out);
  float* oo = static_cast<float*>(o_out);
  if (D == 64) {
    constexpr int bytes = WgSmem<64>::Q + 2 * WgSmem<64>::KV + 8 + 1024;
    err = set_smem(k2_tile_check<64>, bytes);
    if (err) return err;
    k2_tile_check<64><<<1, 128, bytes, st>>>(maps[0], maps[1], maps[2], so,
                                             oo);
  } else {
    constexpr int bytes = WgSmem<128>::Q + 2 * WgSmem<128>::KV + 8 + 1024;
    err = set_smem(k2_tile_check<128>, bytes);
    if (err) return err;
    k2_tile_check<128><<<1, 128, bytes, st>>>(maps[0], maps[1], maps[2], so,
                                              oo);
  }
  return static_cast<int>(cudaGetLastError());
}

// a [64, D], b [N, D], c [N, D] bf16; s [64, N] = a·bᵀ and o [64, D] =
// bf16(s)·c, both f32, through the backward's own maps and product issues.
// D and N are 64 or 128.
extern "C" int bf_flash_bwd_tile_check(const void* a, const void* b,
                                       const void* c, void* s_out,
                                       void* o_out, int D, int N,
                                       void* stream) {
  if ((D != 64 && D != 128) || (N != 64 && N != 128))
    return cudaErrorInvalidValue;
  // a as the q (and dO) of one head (T = 64), b and c as the k and v of
  // one kv head (S = N) in boxes of N rows
  const Shape s = make_shape(1, kWgRows, N, 1, 1, 0, 0, 0, 1.f);
  CUtensorMap maps[4];
  int err = bwd_maps(maps, a, a, b, c, s, D, N);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* so = static_cast<float*>(s_out);
  float* oo = static_cast<float*>(o_out);
  if (D == 64)
    err = N == 64 ? launch_bwd_tile_check<64, 64>(maps, so, oo, st)
                  : launch_bwd_tile_check<64, 128>(maps, so, oo, st);
  else
    err = N == 64 ? launch_bwd_tile_check<128, 64>(maps, so, oo, st)
                  : launch_bwd_tile_check<128, 128>(maps, so, oo, st);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// a [KEYS, D], b [64, D], c [KEYS, D] bf16; s [KEYS, 64] = a·bᵀ and
// o [64, D] = bf16(s)ᵀ·c, both f32, through K5's dQ form, N columns a
// chain.  D is 64 or 128, KEYS 64 or 128, N 32 or 64.
extern "C" int bf_splash_dq_tile_check(const void* a, const void* b,
                                       const void* c, void* s_out,
                                       void* o_out, int D, int KEYS, int N,
                                       void* stream) {
  if ((D != 64 && D != 128) || (KEYS != 64 && KEYS != 128) ||
      (N != 32 && N != 64))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* so = static_cast<float*>(s_out);
  float* oo = static_cast<float*>(o_out);
  int err;
  const int form = (D == 128) * 4 + (KEYS == 128) * 2 + (N == 64);
  switch (form) {
    case 0: err = launch_k5_dq_tile_check<64, 64, 32>(a, b, c, so, oo, st); break;
    case 1: err = launch_k5_dq_tile_check<64, 64, 64>(a, b, c, so, oo, st); break;
    case 2: err = launch_k5_dq_tile_check<64, 128, 32>(a, b, c, so, oo, st); break;
    case 3: err = launch_k5_dq_tile_check<64, 128, 64>(a, b, c, so, oo, st); break;
    case 4: err = launch_k5_dq_tile_check<128, 64, 32>(a, b, c, so, oo, st); break;
    case 5: err = launch_k5_dq_tile_check<128, 64, 64>(a, b, c, so, oo, st); break;
    case 6: err = launch_k5_dq_tile_check<128, 128, 32>(a, b, c, so, oo, st); break;
    default: err = launch_k5_dq_tile_check<128, 128, 64>(a, b, c, so, oo, st);
  }
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
