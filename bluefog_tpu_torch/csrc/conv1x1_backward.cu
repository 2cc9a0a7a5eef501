// Fused 1x1-convolution backward for Hopper (sm_90a): dx and dw of
// y = x2d @ w in one wrapper call.
//
// Replaces the Pallas TPU kernel bluefog_tpu/parallel/pallas_conv.py:80
// (_bwd_kernel).  For x2d [N, ci], dy2d [N, co], w [ci, co]:
//
//     dx[N, ci]  = dy · wᵀ                  (x's type, f32 accumulation)
//     dw[ci, co] = Σ_N xᵀ · dy              (f32)
//
// What bounds it on the card: at ResNet-50's shapes (N = 6,272-401,408,
// ci 64-1024, co 256-2048) the work is 4·N·ci·co operations over
// 2·N·(2ci + co) bytes, i.e. 4·ci·co / (4·ci + 2·co) operations per byte:
// 43 at 64→256, far below the card's ~295 bf16 operations per byte, so the
// early stages are bound by bytes and only 512→2048 and 1024→2048 reach the
// tensor cores' limit.  The design therefore streams x and dy once per
// output tile and keeps the products on the tensor cores.
//
// Why the TPU design does not carry over: the TPU grid walks the N tiles in
// order into one VMEM accumulator for dw.  Blocks on the card run in
// parallel and in no order, and dw (4-8 MB in f32 at the deep layers) does
// not fit on chip.  So:
//
//   * dx is a tiled GEMM over (N-tile, ci-tile) with K = co streamed through
//     shared memory;
//   * dw is a split-N GEMM: block (ci-tile, co-tile, s) sums its N range
//     into an f32 partial [ci-tile, co-tile] in scratch the wrapper
//     allocates; a second pass sums the partials in a fixed order (s = 0, 1,
//     ...).  No atomics: dw is bit-identical from run to run.  With one
//     split the first pass writes dw itself.
//
// bf16 inputs whose ci and co are multiples of 8 (and 16-byte aligned) run
// on the tensor cores (WMMA 16x16x16 fragments, f32 accumulators) with a
// three-stage cp.async ring; every other case (f32, ragged widths) runs a
// plain FMA tile.  N, ci and co are masked in every dimension.
//
// C interface, bound with ctypes by bluefog_tpu_torch/parallel/conv1x1.py:
//   int bf_conv1x1_tile(cfg, *bm, *bn)
//   int bf_conv1x1_backward(x, dy, w, dx, dw, scratch, n, ci, co, dtype,
//                           splits, chunk, cfg_dx, cfg_dw, stream)
// dtype: 0 = float32, 1 = bfloat16; cfg_dx/cfg_dw: the tensor-core tile
// configuration of each product (launch_tc), -1 for the FMA path.  The
// wrapper sizes the dw split (splits, chunk) from bf_conv1x1_tile's block
// tile.  Both return 0 on success, else a CUDA error code (the backward:
// cudaGetLastError() after the launches).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// 16-byte asynchronous copy global -> shared; copies zeros when !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 f32 values of shared memory -> 8 bf16 in one 16-byte store.
__device__ __forceinline__ void store8_bf16(bf16* dst, const float* src) {
  __align__(16) bf16 v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __float2bfloat16(src[i]);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16, ci % 8 == 0, co % 8 == 0): one WMMA GEMM template
// for both products, a block tile BM x BN, warp tiles WM x WN of 16x16x16
// fragments with f32 accumulators, and a STAGES-deep cp.async ring of
// BK-wide slices in shared memory.
//
//   DW = false (dx):  out[M, N] = A · Bᵀ with A = dy [M = rows, K = co] and
//                     B = w [N = ci, K = co], both K-contiguous; bf16 out.
//   DW = true  (dw):  out[s][M, N] = Σ_{k in split s} A(m, k) · B(k, n) with
//                     A(m, k) = x[k, m] (M = ci) and B(k, n) = dy[k, n]
//                     (N = co), both contiguous along m / n; f32 partials.
// ---------------------------------------------------------------------------
template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool DW>
struct Tile {
  static constexpr int WARPS = (BM / WM) * (BN / WN);
  static constexpr int THREADS = WARPS * 32;
  static constexpr int LDA = DW ? BM + 8 : BK + 8;  // dw: As[k][m], dx: As[m][k]
  static constexpr int LDB = DW ? BN + 8 : BK + 8;  // dw: Bs[k][n], dx: Bs[n][k]
  static constexpr int A_ELEMS = DW ? BK * LDA : BM * LDA;
  static constexpr int B_ELEMS = DW ? BK * LDB : BN * LDB;
  static constexpr int LDC = BN + 4;
  static constexpr int PIPE = STAGES * (A_ELEMS + B_ELEMS) * 2;
  static constexpr int CBYTES = BM * LDC * 4;
  static constexpr int SMEM = PIPE > CBYTES ? PIPE : CBYTES;
};

template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool DW>
__global__ void __launch_bounds__(
    (Tile<BM, BN, BK, WM, WN, STAGES, DW>::THREADS))
    k1_wmma(const bf16* __restrict__ a, const bf16* __restrict__ b,
            void* __restrict__ out, int M, int N, int K, int chunk) {
  using T = Tile<BM, BN, BK, WM, WN, STAGES, DW>;
  using LA = typename std::conditional<DW, wmma::col_major,
                                       wmma::row_major>::type;
  using LB = typename std::conditional<DW, wmma::row_major,
                                       wmma::col_major>::type;
  constexpr int FM = WM / 16, FN = WN / 16, WARPS_N = BN / WN;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * T::A_ELEMS;
  float* Cs = reinterpret_cast<float*>(smem);

  // dw: blocks of one split are adjacent (they share its rows in L2);
  // dx: blocks of one row tile are adjacent (they share its dy rows)
  const int m0 = (DW ? blockIdx.x : blockIdx.y) * BM;
  const int n0 = (DW ? blockIdx.y : blockIdx.x) * BN;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(K, kbeg + chunk);
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  auto load = [&](int stage, int k0) {
    bf16* as = As + stage * T::A_ELEMS;
    bf16* bs = Bs + stage * T::B_ELEMS;
    if (DW) {
      constexpr int MC = BM / 8, NC = BN / 8;
      for (int c = tid; c < BK * MC; c += T::THREADS) {
        const int k = c / MC, mc = (c % MC) * 8;
        const int gk = k0 + k, gm = m0 + mc;
        const bool ok = gk < kend && gm < M;
        cp_async16(as + k * T::LDA + mc, ok ? a + (size_t)gk * M + gm : a,
                   ok);
      }
      for (int c = tid; c < BK * NC; c += T::THREADS) {
        const int k = c / NC, nc = (c % NC) * 8;
        const int gk = k0 + k, gn = n0 + nc;
        const bool ok = gk < kend && gn < N;
        cp_async16(bs + k * T::LDB + nc, ok ? b + (size_t)gk * N + gn : b,
                   ok);
      }
    } else {
      constexpr int KC = BK / 8;
      for (int c = tid; c < BM * KC; c += T::THREADS) {
        const int r = c / KC, kc = (c % KC) * 8;
        const int gr = m0 + r, gk = k0 + kc;
        const bool ok = gr < M && gk < kend;
        cp_async16(as + r * T::LDA + kc, ok ? a + (size_t)gr * K + gk : a,
                   ok);
      }
      for (int c = tid; c < BN * KC; c += T::THREADS) {
        const int r = c / KC, kc = (c % KC) * 8;
        const int gr = n0 + r, gk = k0 + kc;
        const bool ok = gr < N && gk < kend;
        cp_async16(bs + r * T::LDB + kc, ok ? b + (size_t)gr * K + gk : b,
                   ok);
      }
    }
  };

  const int KT = (kend - kbeg + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, kbeg + s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // slice kt has landed
    __syncthreads();              // ... for every thread; slice kt-1 is free
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(nk % STAGES, kbeg + nk * BK);
    cp_async_commit();
    const bf16* as = As + (kt % STAGES) * T::A_ELEMS;
    const bf16* bs = Bs + (kt % STAGES) * T::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(
            fa[i],
            DW ? as + kk * T::LDA + wm + i * 16 : as + (wm + i * 16) * T::LDA + kk,
            T::LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(
            fb[j],
            DW ? bs + kk * T::LDB + wn + j * 16 : bs + (wn + j * 16) * T::LDB + kk,
            T::LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is dead; Cs reuses its memory
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * T::LDC + wn + j * 16,
                              acc[i][j], T::LDC, wmma::mem_row_major);
  __syncthreads();
  if (DW) {
    float* o = static_cast<float*>(out) + (size_t)blockIdx.z * M * N;
    constexpr int NC4 = BN / 4;
    for (int c = tid; c < BM * NC4; c += T::THREADS) {
      const int r = c / NC4, nc = (c % NC4) * 4;
      if (m0 + r < M && n0 + nc < N)
        *reinterpret_cast<float4*>(o + (size_t)(m0 + r) * N + n0 + nc) =
            *reinterpret_cast<const float4*>(Cs + r * T::LDC + nc);
    }
  } else {
    bf16* o = static_cast<bf16*>(out);
    constexpr int NC8 = BN / 8;
    for (int c = tid; c < BM * NC8; c += T::THREADS) {
      const int r = c / NC8, nc = (c % NC8) * 8;
      if (m0 + r < M && n0 + nc < N)
        store8_bf16(o + (size_t)(m0 + r) * N + n0 + nc, Cs + r * T::LDC + nc);
    }
  }
}

// Returns 0 or the CUDA error of the launch set-up.
template <int BM, int BN, int BK, int WM, int WN, int STAGES, bool DW>
int launch_wmma(const bf16* a, const bf16* b, void* out, int M, int N,
                int K, int splits, int chunk, cudaStream_t st) {
  using T = Tile<BM, BN, BK, WM, WN, STAGES, DW>;
  auto kernel = k1_wmma<BM, BN, BK, WM, WN, STAGES, DW>;
  // above 48 KB only after this attribute; it is per device, so it is set
  // on every launch (a host-side call of a few microseconds)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  dim3 grid(DW ? mt : nt, DW ? nt : mt, DW ? splits : 1);
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid, T::THREADS, T::SMEM, st>>>(a, b, out, M, N, K, chunk);
  return 0;
}

// Tile configurations (block BM x BN, warp WM x WN, 3 stages of BK = 32),
// picked per product from the shape by the wrapper: 0 and 1 for ci = 64,
// where one block spans ci (dx) or ci x half of co (dw); 2 above, where
// 64 x 64 warp tiles load half the fragments per product of 32 x 32 ones.
// On an H100 2 ran 1.2-1.8x faster than 0/1 at every deeper ResNet-50
// shape.  This is the one table of block tiles: the wrapper's split plan
// reads it through bf_conv1x1_tile.
template <int CFG> struct Cfg;
template <> struct Cfg<0> { static constexpr int BM = 128, BN = 64, WM = 32, WN = 32; };
template <> struct Cfg<1> { static constexpr int BM = 64, BN = 128, WM = 32, WN = 32; };
template <> struct Cfg<2> { static constexpr int BM = 128, BN = 128, WM = 64, WN = 64; };
constexpr int kTcBK = 32, kTcStages = 3;

template <int CFG, bool DW>
int launch_cfg(const bf16* a, const bf16* b, void* out, int M, int N, int K,
               int splits, int chunk, cudaStream_t st) {
  using C = Cfg<CFG>;
  return launch_wmma<C::BM, C::BN, kTcBK, C::WM, C::WN, kTcStages, DW>(
      a, b, out, M, N, K, splits, chunk, st);
}

template <bool DW>
int launch_tc(int cfg, const bf16* a, const bf16* b, void* out, int M, int N,
              int K, int splits, int chunk, cudaStream_t st) {
  switch (cfg) {
    case 0: return launch_cfg<0, DW>(a, b, out, M, N, K, splits, chunk, st);
    case 1: return launch_cfg<1, DW>(a, b, out, M, N, K, splits, chunk, st);
    case 2: return launch_cfg<2, DW>(a, b, out, M, N, K, splits, chunk, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// FMA path (f32, or bf16 with ragged widths).  C[M, N] over the K range of
// split blockIdx.z: C(m, n) = Σ_k A(m, k) · B(k, n), A(m, k) = a[m*sam +
// k*sak], B(k, n) = b[k*sbk + n*sbn].  64x64 tile, 4x4 per thread.
// ---------------------------------------------------------------------------
constexpr int kFmaTile = 64;

template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
    k1_gemm_fma(const T* __restrict__ a, const T* __restrict__ b,
                TO* __restrict__ c, int M, int N, int K, int chunk,
                long long sam, long long sak, long long sbk, long long sbn) {
  constexpr int BM = kFmaTile, BN = kFmaTile, BK = 16;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, s = blockIdx.z;
  const int kbeg = s * chunk;
  const int kend = min(K, kbeg + chunk);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    for (int e = tid; e < BK * BM; e += kThreads) {
      const int k = e / BM, m = e % BM;
      const int gk = k0 + k, gm = m0 + m;
      As[k][m] = (gk < kend && gm < M) ? to_f(a[gm * sam + gk * sak]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int k = e / BN, n = e % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < kend && gn < N) ? to_f(b[gk * sbk + gn * sbn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  TO* out = c + (size_t)s * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[(size_t)gm * N + gn] = from_f<TO>(acc[i][j]);
    }
  }
}

// dw[i] = Σ_s part[s][i], s in order: the deterministic second pass.
__global__ void __launch_bounds__(kThreads)
    k1_reduce_splits(const float* __restrict__ part, float* __restrict__ dw,
                     long long total, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part[(size_t)s * total + i];
    dw[i] = acc;
  }
}

template <typename T>
void launch_fma(const T* x, const T* dy, const T* w, T* dx, float* part,
                int n, int ci, int co, int splits, int chunk,
                cudaStream_t st) {
  // dx[n, ci]: A(m=row, k=c) = dy[row*co + c], B(k=c, n=i) = w[i*co + c]
  constexpr int t = kFmaTile;
  dim3 gdx((n + t - 1) / t, (ci + t - 1) / t, 1);
  k1_gemm_fma<T, T><<<gdx, kThreads, 0, st>>>(dy, w, dx, n, ci, co, co,
                                               co, 1, 1, co);
  // dw partials [s][ci, co]: A(m=i, k=row) = x[row*ci + i],
  // B(k=row, n=c) = dy[row*co + c]
  dim3 gdw((ci + t - 1) / t, (co + t - 1) / t, splits);
  k1_gemm_fma<T, float><<<gdw, kThreads, 0, st>>>(x, dy, part, ci, co, n,
                                                   chunk, 1, ci, co, 1);
}

}  // namespace

// Block tile (BM, BN) of configuration cfg (-1: the FMA tile); returns 0,
// or cudaErrorInvalidValue for an unknown configuration.
extern "C" int bf_conv1x1_tile(int cfg, int* bm, int* bn) {
  switch (cfg) {
    case -1: *bm = kFmaTile; *bn = kFmaTile; return 0;
    case 0: *bm = Cfg<0>::BM; *bn = Cfg<0>::BN; return 0;
    case 1: *bm = Cfg<1>::BM; *bn = Cfg<1>::BN; return 0;
    case 2: *bm = Cfg<2>::BM; *bn = Cfg<2>::BN; return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int bf_conv1x1_backward(const void* x, const void* dy,
                                   const void* w, void* dx, void* dw,
                                   void* scratch, int n, int ci, int co,
                                   int dtype, int splits, int chunk,
                                   int cfg_dx, int cfg_dw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(scratch)
                           : static_cast<float*>(dw);
  if (dtype == 1 && cfg_dx >= 0) {  // tensor cores
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* dyb = static_cast<const bf16*>(dy);
    int err = launch_tc<false>(cfg_dx, dyb, static_cast<const bf16*>(w), dx,
                               n, ci, co, 1, co, st);
    if (err == 0)
      err = launch_tc<true>(cfg_dw, xb, dyb, part, ci, co, n, splits, chunk,
                            st);
    if (err != 0) return err;
  } else if (dtype == 1) {
    launch_fma<bf16>(static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
                     static_cast<const bf16*>(w), static_cast<bf16*>(dx),
                     part, n, ci, co, splits, chunk, st);
  } else if (dtype == 0) {
    launch_fma<float>(static_cast<const float*>(x),
                      static_cast<const float*>(dy),
                      static_cast<const float*>(w), static_cast<float*>(dx),
                      part, n, ci, co, splits, chunk, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1) {
    const long long total = (long long)ci * co;
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 4096) blocks = 4096;
    k1_reduce_splits<<<(unsigned)blocks, kThreads, 0, st>>>(
        part, static_cast<float*>(dw), total, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
