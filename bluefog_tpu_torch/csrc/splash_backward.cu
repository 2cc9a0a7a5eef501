// Splash attention's fused one-pass backward for Hopper (sm_90a): K5.
//
// Replaces the library kernel that bluefog_tpu/parallel/splash.py:98
// (splash_attention) wraps: jax.experimental.pallas.ops.tpu.
// splash_attention built at splash.py:72-95 with use_fused_bwd_kernel=
// True, causal attention's dQ, dK and dV in one pass over the live
// (query, key) tiles.  The forward is K2 (flash_attention.cu), whose lse
// is the residual; delta = rowsum(dO·O) comes from the caller, as for
// K3a/K3b.
//
// Layouts are the JAX package's: q, dO, dQ [B, T, H, D]; k, v, dK, dV
// [B, T, KV, D]; lse and delta [B, H, T] f32.  Query head h reads kv head
// h / (H / KV).  Causal with no offsets (splash has none): row i sees
// keys j <= i.
//
// One block per (batch, kv head, 64-key tile), 4 warps of 16 keys.  It
// loops over (32-row query tile, group member) pairs from the tile that
// holds its first key to the last (the causal live set), and per pair:
//   S = Q·Kᵀ, P = exp(S·scale - lse)   (-1e30 mask; p = 0 at <= -5e29)
//   dV += Pᵀ·dO                        (P rounded to dO's type)
//   dP = dO·Vᵀ, dS = P·(dP - delta)
//   dK += dSᵀ·Q                        (dS rounded to q's type)
//   dQ_j = dS·K                        (dS rounded to k's type)
// dK and dV stay in f32 registers and are written once (·scale for dK),
// as in K3b, whose loop this is.  dQ needs dS with the query rows as the
// product's M dimension, where the registers hold dSᵀ: each warp writes
// its 16 keys of dS to a bf16 [32 x 64] tile in shared memory, and after
// a barrier the warps read it back as A fragments (ldmatrix), each
// warp 16 rows by D/2 columns over the tile's 64 keys.
//
// dQ without atomics: every key tile at or before a row adds to that
// row.  Block j writes its contribution to partial j of an f32 buffer
// [groups, B, T, H, D] (groups = ceil(T / 64), a function of the shape
// only), each (row, head) once.  A second kernel sums each row's live
// partials, j = 0 .. i / 64 in that order, times scale, and casts to q's
// type.  dQ, dK and dV are bit-equal from run to run.  The splash
// library does the same (one dq partial per kv block, summed
// afterwards) with its partials in q's type; here they are f32.
//
// What bounds it on this card: operations, 5 products of 2·D per live
// (query, key) pair and head: 10·B·H·T(T+1)/2·D, 0.174 ms at the
// Llama-1B training shape (B=4, T=2048, H=32, KV=8, D=64) at 989 TFLOP/s.
// The partials add traffic the bound does not count: each live (row,
// key tile) pair writes D f32 and the sum reads it back, ~1.1 GB each way
// at that shape (~0.66 ms at 3.35 TB/s).  Grouping several key tiles per
// partial cuts it in proportion; wgmma and TMA are later work.
//
// T need not be a multiple of 64: rows and keys past T are masked per
// element (the Python wrapper refuses T % 128 for parity with the JAX
// one).  D is 16, 32, 64 or 128.  bf16 runs on the tensor cores; f32
// takes a plain FMA path (one thread per key, the dQ partial of each row
// through shared memory) with the same masking rules.
//
// Plain C interface, bound with ctypes (bluefog_tpu_torch/parallel/
// splash.py), which validates shapes, types and alignment:
//   int bf_splash_key_tile()  // keys per block = per dQ partial
//   int bf_splash_backward(q, k, v, dout, lse, delta, part, dq, dk, dv,
//                          B, T, H, KV, D, scale, dtype, stream)
// dtype: 0 = float32, 1 = bfloat16.  part is the f32 partial buffer
// [groups, B, T, H, D].  Returns 0 or a CUDA error code.

#include "mma_tile.cuh"

namespace {

struct Dims {
  int B, T, H, KV, rep;
  float scale;
};

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBk = 16 * kWarps;  // keys per block: one dQ partial
constexpr int kBq = 32;           // query rows per step
constexpr int kLdS = kBk + 8;     // padded row of the dS tile

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // padded row: ldmatrix is conflict-free
  // K, V; Q, dO double-buffered; lse, delta double-buffered; dS
  static constexpr int BYTES =
      (2 * kBk + 4 * kBq) * LD * 2 + 4 * kBq * 4 + kBq * kLdS * 2;
};

// dQ's split over the warps: the step's two 16-row halves by D / QC
// column groups (QC >= 16: warp_ab takes 8-column tiles in pairs)
template <int D>
struct DqSplit {
  static constexpr int QC = D >= 32 ? D / 2 : D;
  static constexpr int WARPS = 2 * (D / QC);
};

// ---------------------------------------------------------------------------
// Tensor-core path.  grid (key tiles, B * KV).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
    k5_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ part, bf16* __restrict__ dk,
          bf16* __restrict__ dv, Dims s) {
  constexpr int LD = Smem<D>::LD, NQ = kBq / 8, ND = D / 8;
  constexpr int QC = DqSplit<D>::QC;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBk * LD;
  bf16* Qs = Vs + kBk * LD;       // [2][kBq][LD]
  bf16* dOs = Qs + 2 * kBq * LD;  // [2][kBq][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kBq * LD);  // [2][kBq]
  float* Ds = Ls + 2 * kBq;                                  // [2][kBq]
  bf16* dSs = reinterpret_cast<bf16*>(Ds + 2 * kBq);         // [kBq][kLdS]

  const int j = blockIdx.x;
  const int b = blockIdx.y / s.KV, kvh = blockIdx.y % s.KV;
  const int k0 = j * kBk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long qs = (long long)s.H * D, ks = (long long)s.KV * D;
  const long long koff = ((long long)b * s.T * s.KV + kvh) * D;
  // this block's dQ partial: [B, T, H, D] slice j, batch b
  float* pg = part + ((long long)j * s.B + b) * s.T * s.H * D;
  const int nq = (s.T + kBq - 1) / kBq;
  // causal: the first query tile holding a row >= k0 (every later one too)
  const int p_begin = (k0 / kBq) * s.rep, p_end = nq * s.rep;

  // (query tile, group member) pair p into buffer buf
  auto load_pair = [&](int p, int buf) {
    const int qi = p / s.rep, h = kvh * s.rep + p % s.rep;
    const long long qoff = ((long long)b * s.T * s.H + h) * D;
    load_rows<kBq, D, kThreads>(Qs + buf * kBq * LD, q + qoff, qs, qi * kBq,
                                s.T, tid);
    load_rows<kBq, D, kThreads>(dOs + buf * kBq * LD, dout + qoff, qs,
                                qi * kBq, s.T, tid);
    if (tid < kBq) {
      const int row = qi * kBq + tid;
      const bool ok = row < s.T;
      const long long at = ok ? ((long long)b * s.H + h) * s.T + row : 0;
      cp_async4(Ls + buf * kBq + tid, lse + at, ok);
      cp_async4(Ds + buf * kBq + tid, delta + at, ok);
    }
  };

  load_rows<kBk, D, kThreads>(Ks, k + koff, ks, k0, s.T, tid);
  load_rows<kBk, D, kThreads>(Vs, v + koff, ks, k0, s.T, tid);
  if (p_begin < p_end) load_pair(p_begin, 0);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  for (int p = p_begin; p < p_end; ++p) {
    const int buf = (p - p_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // pair p is in; the other buffer and dS are free
    if (p + 1 < p_end) load_pair(p + 1, buf ^ 1);
    cp_async_commit();
    const int q0 = (p / s.rep) * kBq, h = kvh * s.rep + p % s.rep;
    const bf16* qt = Qs + buf * kBq * LD;
    const bf16* dot = dOs + buf * kBq * LD;
    const float* lt = Ls + buf * kBq;
    const float* dt = Ds + buf * kBq;

    float pt[NQ][4], dpt[NQ][4];  // Pᵀ and dPᵀ: rows keys, cols queries
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pt[n][e] = dpt[n][e] = 0.f;
    warp_abt<NQ, D>(pt, Ks + warp * 16 * LD, qt, LD, lane);
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1), row = q0 + col;
        const int key = key0 + (e >> 1) * 8;
        float x = pt[n][e] * s.scale;
        if (row >= s.T || key >= s.T || row < key) x = kNegInf;
        pt[n][e] = x <= kDead ? 0.f : __expf(x - lt[col]);
      }
    uint32_t af[NQ / 2][4];
    c_to_a<NQ>(af, pt);  // P in dO's type
    warp_ab<ND, NQ / 2>(dva, af, dot, LD, lane);
    warp_abt<NQ, D>(dpt, Vs + warp * 16 * LD, dot, LD, lane);
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pt[n][e] *= dpt[n][e] - dt[n * 8 + 2 * t + (e & 1)];  // dSᵀ
    c_to_a<NQ>(af, pt);  // dS in q's type
    warp_ab<ND, NQ / 2>(dka, af, qt, LD, lane);
    // dS in k's type, query rows first, for the dQ product
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dSs[(n * 8 + 2 * t + (e & 1)) * kLdS + warp * 16 + g + (e >> 1) * 8] =
            __float2bfloat16_rn(pt[n][e]);
    __syncthreads();
    if (warp < DqSplit<D>::WARPS) {
      const int r0 = (warp & 1) * 16, c0 = (warp >> 1) * QC;
      uint32_t sf[kBk / 16][4];
#pragma unroll
      for (int kc = 0; kc < kBk / 16; ++kc)
        load_a(sf[kc], dSs + r0 * kLdS + kc * 16, kLdS, lane);
      float acc[QC / 8][4];
#pragma unroll
      for (int n = 0; n < QC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      warp_ab<QC / 8, kBk / 16>(acc, sf, Ks + c0, LD, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = q0 + r0 + g + i * 8;
        if (row >= s.T) continue;
        float* dst = pg + ((long long)row * s.H + h) * D + c0 + 2 * t;
#pragma unroll
        for (int n = 0; n < QC / 8; ++n)
          *reinterpret_cast<float2*>(dst + n * 8) =
              make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + i * 8;
    if (key >= s.T) continue;
    const long long at = (((long long)b * s.T + key) * s.KV + kvh) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dka[n][2 * i] * s.scale,
                                dka[n][2 * i + 1] * s.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 FMA path: one thread per key of the block's tile, the same masking,
// f32 products and exact expf; each (row, head)'s dQ partial is the dot
// of the tile's dS column (through shared memory) with K.
// ---------------------------------------------------------------------------
constexpr int kThreadsFma = kBk;

template <int D>
__global__ void __launch_bounds__(kThreadsFma)
    k5_fma(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ part, float* __restrict__ dk,
           float* __restrict__ dv, Dims s) {
  __shared__ float Kt[kBk][D + 1];  // +1: conflict-free row and column reads
  __shared__ float dss[kBk];
  const int j = blockIdx.x;
  const int b = blockIdx.y / s.KV, kvh = blockIdx.y % s.KV;
  const int k0 = j * kBk, tid = threadIdx.x, key = k0 + tid;
  const bool live = key < s.T;
  const long long ka = (((long long)b * s.T + (live ? key : 0)) * s.KV + kvh)
                       * D;
  float* pg = part + ((long long)j * s.B + b) * s.T * s.H * D;
  float dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    Kt[tid][d] = live ? k[ka + d] : 0.f;
    dka[d] = dva[d] = 0.f;
  }
  __syncthreads();
  for (int i = k0; i < s.T; ++i) {
    for (int r = 0; r < s.rep; ++r) {
      const int h = kvh * s.rep + r;
      const long long qa = (((long long)b * s.T + i) * s.H + h) * D;
      const long long ra = ((long long)b * s.H + h) * s.T + i;
      float ds = 0.f;
      if (live && key <= i) {
        float sd = 0.f, pd = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          sd = fmaf(q[qa + d], Kt[tid][d], sd);
          pd = fmaf(dout[qa + d], v[ka + d], pd);
        }
        const float p = expf(sd * s.scale - lse[ra]);
        ds = p * (pd - delta[ra]);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dva[d] = fmaf(p, dout[qa + d], dva[d]);
          dka[d] = fmaf(ds, q[qa + d], dka[d]);
        }
      }
      dss[tid] = ds;
      __syncthreads();
      for (int d = tid; d < D; d += kThreadsFma) {
        float acc = 0.f;
        for (int kk = 0; kk < kBk; ++kk) acc = fmaf(dss[kk], Kt[kk][d], acc);
        pg[((long long)i * s.H + h) * D + d] = acc;
      }
      __syncthreads();
    }
  }
  if (!live) return;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[ka + d] = dka[d] * s.scale;
    dv[ka + d] = dva[d];
  }
}

// ---------------------------------------------------------------------------
// The dQ sum: each row's live partials j = 0 .. row / kBk, in that order,
// times scale, cast to q's type; four values per thread.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(bf16* p, float4 x) {
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(p);
  o[0] = __floats2bfloat162_rn(x.x, x.y);
  o[1] = __floats2bfloat162_rn(x.z, x.w);
}

template <typename OutT>
__global__ void k5_sum(const float* __restrict__ part, OutT* __restrict__ dq,
                       long long n4, int T, int HD, int groups, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const long long e = i * 4, n = n4 * 4;
  const int row = static_cast<int>((e / HD) % T);
  const int live = min(groups, row / kBk + 1);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g = 0; g < live; ++g) {
    const float4 x = *reinterpret_cast<const float4*>(part + g * n + e);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  store4(dq + e, make_float4(acc.x * scale, acc.y * scale, acc.z * scale,
                             acc.w * scale));
}

constexpr int kThreadsSum = 256;

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* part, void* dq,
           void* dk, void* dv, const Dims& s, int dtype, cudaStream_t st) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* pt = static_cast<float*>(part);
  const int groups = (s.T + kBk - 1) / kBk;
  const dim3 grid(groups, s.B * s.KV);
  const long long n4 = (long long)s.B * s.T * s.H * D / 4;
  const unsigned sum_blocks =
      static_cast<unsigned>((n4 + kThreadsSum - 1) / kThreadsSum);
  if (dtype == kBF16) {
    const int err = set_smem(k5_tc<D>, Smem<D>::BYTES);
    if (err) return err;
    k5_tc<D><<<grid, kThreads, Smem<D>::BYTES, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, dl,
        pt, static_cast<bf16*>(dk), static_cast<bf16*>(dv), s);
    const int lerr = static_cast<int>(cudaGetLastError());
    if (lerr) return lerr;
    k5_sum<bf16><<<sum_blocks, kThreadsSum, 0, st>>>(
        pt, static_cast<bf16*>(dq), n4, s.T, s.H * D, groups, s.scale);
  } else {
    k5_fma<D><<<grid, kThreadsFma, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        pt, static_cast<float*>(dk), static_cast<float*>(dv), s);
    const int lerr = static_cast<int>(cudaGetLastError());
    if (lerr) return lerr;
    k5_sum<float><<<sum_blocks, kThreadsSum, 0, st>>>(
        pt, static_cast<float*>(dq), n4, s.T, s.H * D, groups, s.scale);
  }
  return 0;
}

}  // namespace

extern "C" int bf_splash_key_tile() { return kBk; }

extern "C" int bf_splash_backward(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* part, void* dq,
                                  void* dk, void* dv, int B, int T, int H,
                                  int KV, int D, float scale, int dtype,
                                  void* stream) {
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  if (B < 1 || T < 1 || KV < 1 || H % KV) return cudaErrorInvalidValue;
  if ((long long)B * KV > 65535) return cudaErrorInvalidValue;
  Dims s;
  s.B = B;
  s.T = T;
  s.H = H;
  s.KV = KV;
  s.rep = H / KV;
  s.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  BF_DISPATCH_D(D, launch<kD>(q, k, v, dout, lse, delta, part, dq, dk, dv, s,
                              dtype, st));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
