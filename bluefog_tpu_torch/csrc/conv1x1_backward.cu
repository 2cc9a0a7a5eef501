// Fused 1x1-convolution backward for Hopper (sm_90a): dx and dw of
// y = x2d @ w in one wrapper call (K1).
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
// early stages are bound by bytes (dy, the largest operand, most of all)
// and only 512→2048 and 1024→2048 reach the tensor cores' limit.
//
// The TPU grid walks the N tiles in order and reads each tile of x and dy
// once for both products, summing dw in one VMEM accumulator.  Blocks on
// the card run in parallel and in no order, and dw (4-8 MB in f32 at the
// deep layers) does not fit on chip.  So, in bf16 where ci and co are
// multiples of 64 (every ResNet-50 shape), with 2-D TMA tensor maps
// (128-byte swizzle, zeros out of bounds), mbarrier rings and wgmma:
//
//   * ci = 64, co = 256 (stage 1, 4 of the 20 launches of a ResNet-50
//     rank-step, the heaviest): k1_fused, the TPU kernel's fusion.  A
//     persistent block owns a contiguous range of N (split_plan's chunk);
//     w (32 KB) stays in shared memory; each 64-row tile of x and dy
//     arrives once by TMA through a four-stage ring; one consumer
//     warpgroup issues the tile's dx = dy·wᵀ (A = dy and B = w both
//     K-major), the other adds xᵀ·dy into a 64 x 256 f32 dw accumulator
//     held in its registers (A = xᵀ and B = dy both MN-major through the
//     transpose bits; the same floating-point work as dx).  x and dy are
//     each read once per call.  Each block writes its dw partial.
//   * every other such shape: k1_gemm, one wgmma GEMM per product (128 x
//     128 block tiles, two consumers of 64 rows, a four-stage ring of
//     64-deep K slices): dx over (N-tile, ci-tile), dw split over N
//     (split_plan) into f32 partials.
//   * f32, and bf16 with other widths: a plain FMA tile, as before.
//
// A second pass sums the dw partials in block order (s = 0, 1, ...): no
// atomics, dw bit-identical from run to run; with one split the first
// pass writes dw itself.  N, ci and co are masked in every dimension.
//
// C interface, bound with ctypes by bluefog_tpu_torch/parallel/conv1x1.py:
//   int bf_conv1x1_tile(cfg, *bm, *bn)
//   int bf_conv1x1_backward(x, dy, w, dx, dw, scratch, n, ci, co, dtype,
//                           splits, chunk, cfg, stream)
// dtype: 0 = float32, 1 = bfloat16; cfg: 0 k1_fused, 1 k1_gemm, -1 the
// FMA path.  The wrapper sizes the dw split (splits, chunk) from
// bf_conv1x1_tile's dw block tile (the persistent kernel's: all of
// [ci, co]).  Both return 0 on success, else a CUDA error code (the
// backward: cudaGetLastError() after the launches).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// ---------------------------------------------------------------------------
// wgmma paths: warpgroup 0 the producer (one thread issues the TMA loads),
// two consumer warpgroups of 64 output rows each.
// ---------------------------------------------------------------------------
constexpr int kBox = 64 * 128;  // a box of 64 rows of 64 bf16 (8 KB)
constexpr int kWgThreads = 384;

// The accumulator of m64nN (N / 2 floats, thread t = 32w + 4g + q of the
// warpgroup): d[4j + e] at row 16w + g + 8(e / 2), column 8j + 2q + e % 2.
template <int N>
__device__ __forceinline__ void store_bf16(const float (&d)[N / 2], bf16* out,
                                           long long ld, int row0, int rows,
                                           int col0, int cols) {
  const int t = threadIdx.x % 128, w = t / 32, g = (t % 32) / 4, q = t % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 16 * w + g + 8 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = col0 + 8 * j + 2 * q;
      if (c < cols)
        *reinterpret_cast<__nv_bfloat162*>(out + r * ld + c) =
            __floats2bfloat162_rn(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
    }
  }
}
template <int N>
__device__ __forceinline__ void store_f32(const float (&d)[N / 2], float* out,
                                          long long ld, int row0, int rows,
                                          int col0, int cols) {
  const int t = threadIdx.x % 128, w = t / 32, g = (t % 32) / 4, q = t % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + 16 * w + g + 8 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = col0 + 8 * j + 2 * q;
      if (c < cols)
        *reinterpret_cast<float2*>(out + r * ld + c) =
            make_float2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
    }
  }
}

// Issues acc[64 x N] (+)= A[64 x 64] · B[N x 64]ᵀ over one 64-deep slice,
// both K-major: a is a box of 64 rows, b N rows of 128 bytes (SBO 1024
// bytes = 8 rows; the k-th 16-column step 32·k bytes in).
template <int N>
__device__ __forceinline__ void slice_kk(float (&acc)[N / 2], const void* a,
                                         const void* b, bool first) {
  const uint64_t da = sm90::desc_sw128(a, 16, 1024);
  const uint64_t db = sm90::desc_sw128(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (N == 128)
      sm90::wgmma_ss_n128(acc, sm90::desc_add(da, 32 * kk),
                          sm90::desc_add(db, 32 * kk), !first || kk > 0);
    else
      sm90::wgmma_ss_n64(acc, sm90::desc_add(da, 32 * kk),
                         sm90::desc_add(db, 32 * kk), !first || kk > 0);
  }
}

// Issues acc[64 x 128] (+)= A[64 x 16·KS] · B[16·KS x 128], both MN-major
// (the transpose bits) over tiles of 128-byte rows along the reduction
// axis (SBO 1024 bytes = 8 rows, the k-th step of 16 rows 2048·k bytes
// in): A's rows in boxes of 64 rows, `abox` bytes apart; B's two 64-column
// halves `bhalf` bytes apart (LBO), its rows in boxes of `brows` rows,
// `bbox` bytes apart.
template <int KS>
__device__ __forceinline__ void slice_mn(float (&acc)[64], const void* a,
                                         int abox, const unsigned char* b,
                                         int bhalf, int brows, int bbox,
                                         bool first) {
  const uint64_t da = sm90::desc_sw128(a, 8192, 1024);
  const uint64_t db = sm90::desc_sw128(b, bhalf, 1024);
  constexpr int per = 4;  // 16-row steps per 64-row box of A
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t ka = sm90::desc_add(da, (kk / per) * abox +
                                               (kk % per) * 2048);
    const int bs = brows / 16;
    const uint64_t kb = sm90::desc_add(db, (kk / bs) * bbox +
                                               (kk % bs) * 2048);
    sm90::wgmma_ss_n128<1, 1>(acc, ka, kb, !first || kk > 0);
  }
}

// ---------------------------------------------------------------------------
// k1_fused: ci = 64, co = 256.  grid (splits): block s owns rows
// [s·chunk, min(n, (s + 1)·chunk)) in tiles of 64 rows (chunk is a
// multiple of 128).  Shared memory: w as 4 boxes (64 co columns each) of
// its 64 rows; a four-stage ring, per stage x as 1 box of 64 rows and dy
// as 4 boxes (64 co columns each) of 64 rows.  A two-stage ring of
// 128-row tiles, both consumers doing half of each product, ran 5%
// slower on the H100.
// ---------------------------------------------------------------------------
constexpr int kFusedCi = 64, kFusedCo = 256, kFusedRows = 64;
constexpr int kFusedStages = 4;
constexpr int kFusedW = 4 * kBox;                     // 32 KB
constexpr int kFusedX = kFusedRows / 64 * kBox;       // 16 KB
constexpr int kFusedDyBox = kFusedRows * 128;         // 16 KB
constexpr int kFusedDy = 4 * kFusedDyBox;             // 64 KB
constexpr int kFusedBytes = kFusedW + kFusedStages * (kFusedX + kFusedDy) +
                            8 * (1 + 2 * kFusedStages) + 1024;

__global__ void __launch_bounds__(kWgThreads, 1)
    k1_fused(const __grid_constant__ CUtensorMap tx,
             const __grid_constant__ CUtensorMap tdy,
             const __grid_constant__ CUtensorMap tw, bf16* __restrict__ dx,
             float* __restrict__ part, int n, int chunk) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ws = sm90::align1024(smem_raw);
  unsigned char* Xs = Ws + kFusedW;                 // [stage][2][64][64]
  unsigned char* Ys = Xs + kFusedStages * kFusedX;  // [stage][4][128][64]
  uint64_t* full_w = reinterpret_cast<uint64_t*>(Ys + kFusedStages * kFusedDy);
  uint64_t* full = full_w + 1;
  uint64_t* empty = full + kFusedStages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int r0 = blockIdx.x * chunk, r1 = min(n, r0 + chunk);
  const int tiles = r1 > r0 ? (r1 - r0 + kFusedRows - 1) / kFusedRows : 0;

  if (threadIdx.x == 0) {
    sm90::mbar_init(full_w, 1);
    for (int i = 0; i < kFusedStages; ++i) {
      sm90::mbar_init(full + i, 1);
      sm90::mbar_init(empty + i, 2);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::setmaxnreg_dec<40>();
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(full_w, kFusedW);
      for (int cb = 0; cb < 4; ++cb)
        sm90::tma_load_2d(Ws + cb * kBox, &tw, full_w, 64 * cb, 0);
      int stage = 0, phase = 1;
      for (int i = 0; i < tiles; ++i) {
        const int row = r0 + i * kFusedRows;
        sm90::mbar_wait(empty + stage, phase);
        sm90::mbar_arrive_expect_tx(full + stage, kFusedX + kFusedDy);
        unsigned char* xs = Xs + stage * kFusedX;
        unsigned char* ys = Ys + stage * kFusedDy;
        for (int h = 0; h < kFusedRows / 64; ++h)
          sm90::tma_load_2d(xs + h * kBox, &tx, full + stage, 0, row + 64 * h);
        for (int cb = 0; cb < 4; ++cb)
          sm90::tma_load_2d(ys + cb * kFusedDyBox, &tdy, full + stage, 64 * cb,
                            row);
        if (++stage == kFusedStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int c = wg - 1;
    // consumer 0: each tile's dx (64 rows, K = co over four boxes);
    // consumer 1: dw (64 x 256 in two n128 halves, K = the tile's rows).
    // Each walks the whole ring in a loop of its own (a product issued
    // under a branch inside one loop is serialized by ptxas).
    sm90::mbar_wait(full_w, 0);
    int stage = 0, phase = 0;
    auto next = [&]() {
      if (tid == 0) sm90::mbar_arrive(empty + stage);
      if (++stage == kFusedStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    if (c == 0) {
      float dxa[32];
      for (int i = 0; i < tiles; ++i) {
        sm90::mbar_wait(full + stage, phase);
        const unsigned char* ys = Ys + stage * kFusedDy;
        sm90::wgmma_fence();
#pragma unroll
        for (int cb = 0; cb < 4; ++cb)
          slice_kk<64>(dxa, ys + cb * kFusedDyBox, Ws + cb * kBox, cb == 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dxa);
        next();
        store_bf16<64>(dxa, dx, kFusedCi, r0 + i * kFusedRows, r1, 0,
                       kFusedCi);
      }
    } else {
      float dw0[64], dw1[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) dw0[i] = dw1[i] = 0.f;
      for (int i = 0; i < tiles; ++i) {
        sm90::mbar_wait(full + stage, phase);
        const unsigned char* xs = Xs + stage * kFusedX;
        const unsigned char* ys = Ys + stage * kFusedDy;
        sm90::wgmma_fence();
        slice_mn<4>(dw0, xs, kBox, ys, kFusedDyBox, 64, 0, false);
        slice_mn<4>(dw1, xs, kBox, ys + 2 * kFusedDyBox, kFusedDyBox, 64, 0,
                    false);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dw0);
        sm90::fence_regs(dw1);
        next();
      }
      float* o = part + (size_t)blockIdx.x * kFusedCi * kFusedCo;
      store_f32<128>(dw0, o, kFusedCo, 0, kFusedCi, 0, kFusedCo);
      store_f32<128>(dw1, o, kFusedCo, 0, kFusedCi, 128, kFusedCo);
    }
  }
}

// ---------------------------------------------------------------------------
// k1_gemm: out[M, N] = A · B over K in 64-deep slices, a 128 x 128 block
// tile, four stages.  DW = false (dx): A = dy [M = n, K = co] and B = w
// [N = ci, K = co], both K-major; bf16 out.  grid (ci tiles, n tiles).
// DW = true (dw): A = xᵀ (x [K = n, M = ci]) and B = dy [K = n, N = co],
// both MN-major; split blockIdx.z sums rows [z·chunk, (z + 1)·chunk) into
// f32 partial z.  grid (ci tiles, co tiles, splits).
// ---------------------------------------------------------------------------
constexpr int kGemmStages = 4;
constexpr int kGemmA = 2 * kBox, kGemmB = 2 * kBox;  // 16 KB each
constexpr int kGemmBytes = kGemmStages * (kGemmA + kGemmB) +
                           8 * 2 * kGemmStages + 1024;

template <bool DW>
__global__ void __launch_bounds__(kWgThreads, 1)
    k1_gemm(const __grid_constant__ CUtensorMap ta,
            const __grid_constant__ CUtensorMap tb, void* __restrict__ out,
            int M, int N, int K, int chunk) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* As = sm90::align1024(smem_raw);
  unsigned char* Bs = As + kGemmStages * kGemmA;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + kGemmStages * kGemmB);
  uint64_t* empty = full + kGemmStages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m0 = (DW ? blockIdx.x : blockIdx.y) * 128;
  const int n0 = (DW ? blockIdx.y : blockIdx.x) * 128;
  const int kbeg = DW ? blockIdx.z * chunk : 0;
  const int kend = DW ? min(K, kbeg + chunk) : K;
  const int steps = (kend - kbeg + 63) / 64;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kGemmStages; ++i) {
      sm90::mbar_init(full + i, 1);
      sm90::mbar_init(empty + i, 2);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::setmaxnreg_dec<40>();
    if (tid == 0) {
      int stage = 0, phase = 1;
      for (int i = 0; i < steps; ++i) {
        const int k = kbeg + 64 * i;
        sm90::mbar_wait(empty + stage, phase);
        sm90::mbar_arrive_expect_tx(full + stage, kGemmA + kGemmB);
        unsigned char* as = As + stage * kGemmA;
        unsigned char* bs = Bs + stage * kGemmB;
        if (DW) {
          // xᵀ: x's rows k.. by ci columns m0 + 64h..; dy's rows k.. by co
          // columns n0 + 64h..
          for (int h = 0; h < 2; ++h) {
            sm90::tma_load_2d(as + h * kBox, &ta, full + stage, m0 + 64 * h, k);
            sm90::tma_load_2d(bs + h * kBox, &tb, full + stage, n0 + 64 * h, k);
          }
        } else {
          // dy's rows m0 + 64h.. and w's rows n0.. (128), co columns k..
          for (int h = 0; h < 2; ++h)
            sm90::tma_load_2d(as + h * kBox, &ta, full + stage, k, m0 + 64 * h);
          sm90::tma_load_2d(bs, &tb, full + stage, k, n0);
        }
        if (++stage == kGemmStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int c = wg - 1;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // one slice's products stay in flight while the next is issued; a
    // stage is released once the products that read it have completed
    int stage = 0, phase = 0, prev = 0;
    for (int i = 0; i < steps; ++i) {
      sm90::mbar_wait(full + stage, phase);
      const unsigned char* as = As + stage * kGemmA;
      const unsigned char* bs = Bs + stage * kGemmB;
      sm90::wgmma_fence();
      if (DW)
        slice_mn<4>(acc, as + c * kBox, kBox, bs, kBox, 64, 0, false);
      else
        slice_kk<128>(acc, as + c * kBox, bs, false);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      if (i > 0 && tid == 0) sm90::mbar_arrive(empty + prev);
      prev = stage;
      if (++stage == kGemmStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    if (DW)
      store_f32<128>(acc,
                     static_cast<float*>(out) + (size_t)blockIdx.z * M * N, N,
                     m0 + 64 * c, M, n0, N);
    else
      store_bf16<128>(acc, static_cast<bf16*>(out), N, m0 + 64 * c, M, n0, N);
  }
}

// The tensor maps of a call: x [n, ci], dy [n, co] and w [ci, co] as 2-D
// row-major maps; boxes of 64 columns by `xrows`, `dyrows`, `wrows` rows.
int k1_maps(CUtensorMap* tx, CUtensorMap* tdy, CUtensorMap* tw,
            const void* x, const void* dy, const void* w, int n, int ci,
            int co, int xrows, int dyrows, int wrows) {
  int err = 0;
  if (tx) err = sm90::encode_bf16_2d(tx, x, ci, n, ci * 2, 64, xrows);
  if (!err && tdy)
    err = sm90::encode_bf16_2d(tdy, dy, co, n, co * 2, 64, dyrows);
  if (!err && tw) err = sm90::encode_bf16_2d(tw, w, co, ci, co * 2, 64, wrows);
  return err;
}

int launch_fused(const bf16* x, const bf16* dy, const bf16* w, bf16* dx,
                 float* part, int n, int splits, int chunk, cudaStream_t st) {
  if (chunk % kFusedRows) return cudaErrorInvalidValue;
  CUtensorMap tx, tdy, tw;
  int err = k1_maps(&tx, &tdy, &tw, x, dy, w, n, kFusedCi, kFusedCo, 64,
                    kFusedRows, 64);
  if (!err)
    err = static_cast<int>(cudaFuncSetAttribute(
        k1_fused, cudaFuncAttributeMaxDynamicSharedMemorySize, kFusedBytes));
  if (err) return err;
  k1_fused<<<splits, kWgThreads, kFusedBytes, st>>>(tx, tdy, tw, dx, part, n,
                                                    chunk);
  return 0;
}

int launch_gemms(const bf16* x, const bf16* dy, const bf16* w, bf16* dx,
                 float* part, int n, int ci, int co, int splits, int chunk,
                 cudaStream_t st) {
  if (chunk % 64) return cudaErrorInvalidValue;
  const int nt = (n + 127) / 128, it = (ci + 127) / 128, ot = (co + 127) / 128;
  if (nt > 65535 || splits > 65535) return cudaErrorInvalidValue;
  // dx: dy in boxes of 64 rows, w in boxes of 128 rows
  CUtensorMap tdy_k, tw;
  int err = k1_maps(nullptr, &tdy_k, &tw, x, dy, w, n, ci, co, 0, 64, 128);
  // dw: x and dy in boxes of 64 rows (the reduction axis)
  CUtensorMap tx, tdy_m;
  if (!err) err = k1_maps(&tx, &tdy_m, nullptr, x, dy, w, n, ci, co, 64, 64, 0);
  if (!err)
    err = static_cast<int>(cudaFuncSetAttribute(
        k1_gemm<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kGemmBytes));
  if (!err)
    err = static_cast<int>(cudaFuncSetAttribute(
        k1_gemm<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kGemmBytes));
  if (err) return err;
  k1_gemm<false><<<dim3(it, nt), kWgThreads, kGemmBytes, st>>>(
      tdy_k, tw, dx, n, ci, co, 0);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  k1_gemm<true><<<dim3(it, ot, splits), kWgThreads, kGemmBytes, st>>>(
      tx, tdy_m, part, ci, co, n, chunk);
  return 0;
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

// dw block tile (BM, BN) of configuration cfg: 0 k1_fused (all of [64,
// 256]), 1 k1_gemm, -1 the FMA tile; returns 0, or cudaErrorInvalidValue
// for an unknown configuration.
extern "C" int bf_conv1x1_tile(int cfg, int* bm, int* bn) {
  switch (cfg) {
    case -1: *bm = kFmaTile; *bn = kFmaTile; return 0;
    case 0: *bm = kFusedCi; *bn = kFusedCo; return 0;
    case 1: *bm = 128; *bn = 128; return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int bf_conv1x1_backward(const void* x, const void* dy,
                                   const void* w, void* dx, void* dw,
                                   void* scratch, int n, int ci, int co,
                                   int dtype, int splits, int chunk, int cfg,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(scratch)
                           : static_cast<float*>(dw);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dyb = static_cast<const bf16*>(dy);
  const bf16* wb = static_cast<const bf16*>(w);
  int err = 0;
  if (dtype == 1 && cfg == 0) {
    if (ci != kFusedCi || co != kFusedCo) return cudaErrorInvalidValue;
    err = launch_fused(xb, dyb, wb, static_cast<bf16*>(dx), part, n, splits,
                       chunk, st);
  } else if (dtype == 1 && cfg == 1) {
    if (ci % 64 || co % 64) return cudaErrorInvalidValue;
    err = launch_gemms(xb, dyb, wb, static_cast<bf16*>(dx), part, n, ci, co,
                       splits, chunk, st);
  } else if (dtype == 1 && cfg == -1) {
    launch_fma<bf16>(xb, dyb, wb, static_cast<bf16*>(dx), part, n, ci, co,
                     splits, chunk, st);
  } else if (dtype == 0 && cfg == -1) {
    launch_fma<float>(static_cast<const float*>(x),
                      static_cast<const float*>(dy),
                      static_cast<const float*>(w), static_cast<float*>(dx),
                      part, n, ci, co, splits, chunk, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err) return err;
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (splits > 1) {
    const long long total = (long long)ci * co;
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 4096) blocks = 4096;
    k1_reduce_splits<<<(unsigned)blocks, kThreads, 0, st>>>(
        part, static_cast<float*>(dw), total, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
