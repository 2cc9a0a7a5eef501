// One-token GQA decode attention over a KV-head-major K/V cache, for
// Hopper (sm_90a): split-KV flash-decoding.
//
// Replaces bluefog_tpu/parallel/pallas_decode.py::_decode_kernel (the
// TPU kernel behind decode_attention and decode_attention_int8).  It
// computes the same function: the single query of each (batch row,
// query head) attends over cache positions 0..idx[b] of its kv head
// (idx clamped to S - 1), with an f32 online softmax, the TPU kernel's
// max(l, 1e-30) guard on the denominator, and, for the int8 cache, the
// key scale applied to the score columns and the value scale folded into
// float probabilities after the denominator is summed (never
// re-quantized).
//
// What bounds it on this card: device-memory bytes.  A call must read
// 2 * B * KV * (idx + 1) * D * elem bytes of cache (plus 2 * B * KV *
// (idx + 1) * 4 bytes of scales for int8) and does 2 * rep flops per
// cache element it reads (4 per byte of a bf16 cache at rep = 4), far
// below the card's ~20 flops per byte at which f32 arithmetic would
// become the limit, so the dots stay on CUDA cores.  What the design does
// about it:
//
// * The split.  The positions of each (row, kv head) pair are cut into
//   splits of `split` positions (a multiple of 32, a pure function of S,
//   B * KV and the SM count, chosen by the wrapper so that a full-length
//   cache gives ~4 blocks per SM).  Block (j, pair, z) serves query rows
//   4z..4z + 3 of the pair over positions [j * split, (j + 1) * split) up
//   to idx[b]; a block whose range starts past idx[b] exits at once, so
//   only live splits read anything, and the longest row's positions are
//   spread over as many blocks as its splits (one block per pair would
//   give 64 blocks at the serving shape, the row at idx 2047 reading
//   1 MB alone).
// * Each block writes an unnormalised f32 partial (m, l, acc[rows][D])
//   to scratch the wrapper allocates; a second kernel merges a pair's
//   live partials in split order: out = sum_j e^(m_j - M) acc_j /
//   max(sum_j e^(m_j - M) l_j, 1e-30), M the largest m_j.  No atomics on
//   data: the result is bit-equal from run to run.  For int8 acc_j
//   already carries the value scales and l_j does not, so the merge keeps
//   the fold exact.
// * Inside a block, each warp streams its own batches of positions (warp
//   w takes batches w, w + 4, ...) through its own ring of three stages
//   in shared memory, filled by cp.async: a stage holds the batch's K and
//   V tiles ([positions][D], in the cache's native type) and, for int8,
//   their scales.  A lane copies one chunk of a cache row (16 bytes of
//   bf16 or f32, 8 of int8), so a warp step moves 32 / chunks whole rows,
//   coalesced, and reads back the same bytes it copied (lane-contiguous:
//   no bank conflicts); int8 scales are copied one a lane and shared
//   through a __syncwarp.  Two batches stay in flight while the third is
//   computed on, converted to f32 in registers.  No __syncthreads in the
//   loop: the warps run apart.  (A first version
//   staged 32-position tiles through a block-wide cp.async ring, with two
//   barriers a tile and q read from shared memory for every product; it
//   was latency-bound on the H100, most at long caches.)  The lanes of a
//   row sum their partial dots with shuffles; the online softmax keeps
//   one running maximum per query row and warp, updated once per batch;
//   the four warps' states are merged through shared memory at the end.
//   The dots stay on CUDA cores (2 * rep flops per element read).  Query
//   heads past 4 per kv head take further blocks (grid z), each reading
//   the cache again: the repo's Llama presets have 4 and 2.
//
// idx is a [B] int32 device tensor: one launch pair serves every row at
// its own position (the serving engine's slots), with no host sync.
//
// Plain C interface, bound with ctypes (bluefog_tpu_torch/parallel/
// decode_attention.py); the wrapper validates shapes, types and
// alignment, chooses the split and allocates the scratch before it calls
// bf_decode_attention, which launches both kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = 4;       // warp steps per batch
constexpr int kStages = 3;      // batches in a warp's ring
constexpr int kRows = 4;        // query rows per block
constexpr int kMaxRep = 16;     // query heads per kv head
constexpr int kSplitUnit = 32;  // a split is a multiple of 32 positions
constexpr float kNegInf = -1e30f;

// dtype codes shared with the Python wrapper
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One lane's chunk of a cache row: 16 bytes of f32 or bf16, 8 of int8
// (so that every type gives at most 8 values a lane), unpacked to f32 with
// shifts.
template <typename KT>
struct Chunk;
template <>
struct Chunk<float> {
  using T = uint4;
  static constexpr int N = 4;
};
template <>
struct Chunk<__nv_bfloat16> {
  using T = uint4;
  static constexpr int N = 8;
};
template <>
struct Chunk<int8_t> {
  using T = uint2;
  static constexpr int N = 8;
};

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 pairs: low half first
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint2& r, float (&f)[8]) {
  const uint32_t w[2] = {r.x, r.y};
#pragma unroll
  for (int i = 0; i < 8; ++i)  // int8, low byte first
    f[i] = static_cast<float>(
        static_cast<int8_t>((w[i / 4] >> (8 * (i % 4))) & 0xffu));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// cp.async of BYTES (16, 8 or 4) from global to shared memory; 16-byte
// copies bypass L1.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One stage of a warp's ring: the K and V tiles of a batch, BATCH
// positions x D in the cache's type, stored as the lanes copy them (step
// st, lane: chunk bytes at (st * 32 + lane) * chunk), then for int8 the
// batch's k scales and v scales (BATCH floats each, in position order).
template <typename KT, int D>
struct Ring {
  static constexpr int CB = sizeof(typename Chunk<KT>::T);
  static constexpr int BATCH = 32 / (D / Chunk<KT>::N) * kSteps;
  static constexpr int TILE = kSteps * 32 * CB;
  static constexpr int SCALES = std::is_same<KT, int8_t>::value
                                    ? BATCH * 4 : 0;
  static constexpr int STAGE = 2 * TILE + 2 * SCALES;
  static constexpr int BYTES = kWarps * kStages * STAGE;  // the block's
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The scratch of one (pair, split): acc [rep][D], then m and l [rep][2].
__host__ __device__ __forceinline__ long long part_floats(int rep, int d) {
  return static_cast<long long>(rep) * (d + 2);
}

// grid (splits, B * KV, ceil(rep / kRows)): block (j, pair, z) serves
// query rows z * kRows.. of the pair over split j's live positions.
template <typename QT, typename KT, bool kQuant, int D>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                        const KT* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int32_t* __restrict__ idx,
                        float* __restrict__ part, int n_kv, int seq_len,
                        int rep, int split, float scale) {
  using C = Chunk<KT>;
  constexpr int N = C::N;             // values a lane holds of a row
  constexpr int CH = D / N;           // lanes a cache row spans
  constexpr int PS = 32 / CH;         // positions a warp step covers
  constexpr int BATCH = PS * kSteps;  // positions a warp batch covers
  using R = Ring<KT, D>;
  // each warp's ring; after the loop its first kRows * D floats hold the
  // warp's accumulators for the block's merge
  extern __shared__ __align__(16) unsigned char ring_raw[];
  static_assert(kRows * D * 4 <= kStages * R::STAGE, "merge buffer");
  __shared__ float ml_s[kWarps][kRows][2];

  const int j = blockIdx.x, pair = blockIdx.y, r0 = blockIdx.z * kRows;
  const int b = pair / n_kv;
  int last = idx[b];
  if (last > seq_len - 1) last = seq_len - 1;
  const int start = j * split;
  if (start > last) return;  // nothing live in this split
  const int end = min(start + split, last + 1);
  const int nr = min(kRows, rep - r0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunk = lane % CH, sub = lane / CH;
  const size_t row_q = (static_cast<size_t>(b) * n_kv + pair % n_kv) * rep;
  const KT* k_bh = k + static_cast<size_t>(pair) * seq_len * D + chunk * N;
  const KT* v_bh = v + static_cast<size_t>(pair) * seq_len * D + chunk * N;
  const float* ks_bh = kQuant ? k_scale + static_cast<size_t>(pair) * seq_len
                              : nullptr;
  const float* vs_bh = kQuant ? v_scale + static_cast<size_t>(pair) * seq_len
                              : nullptr;

  // this lane's slice of the block's query rows, and its running state
  float qv[kRows][N], acc[kRows][N], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const QT* qr = q + (row_q + r0 + r) * D + chunk * N;
#pragma unroll
    for (int x = 0; x < N; ++x) {
      qv[r][x] = r < nr ? to_float(qr[x]) : 0.f;
      acc[r][x] = 0.f;
    }
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  // warp w takes batches w, w + kWarps, ... of the block's range; lane
  // (sub, chunk) copies chunk `chunk` of position p0 + st * PS + sub (a
  // position past the range copies the range's first, and is masked)
  unsigned char* ring = ring_raw + warp * kStages * R::STAGE;
  const int stride = kWarps * BATCH;
  auto issue = [&](int p0, int stage) {
    unsigned char* dst = ring + stage * R::STAGE;
    if (p0 < end) {
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int pos = p0 + st * PS + sub;
        const int src = pos < end ? pos : start;
        const size_t from = static_cast<size_t>(src) * D;
        const int at = (st * 32 + lane) * R::CB;
        cp_async<R::CB>(dst + at, k_bh + from);
        cp_async<R::CB>(dst + R::TILE + at, v_bh + from);
      }
      if (kQuant) {  // the batch's 2 * BATCH scales, one a lane a round
        float* scl = reinterpret_cast<float*>(dst + 2 * R::TILE);
#pragma unroll
        for (int i = lane; i < 2 * BATCH; i += 32) {
          const int pos = p0 + i % BATCH;
          const int src = pos < end ? pos : start;
          cp_async<4>(scl + i, (i < BATCH ? ks_bh : vs_bh) + src);
        }
      }
    }
    cp_async_commit();  // an empty group past the range keeps the count
  };
  int p_next = start + warp * BATCH;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i, p_next += stride) issue(p_next, i);
  int stage = 0;
  for (int p0 = start + warp * BATCH; p0 < end; p0 += stride) {
    __syncwarp();  // the stage refilled next was read by every lane
    issue(p_next, (stage + kStages - 1) % kStages);
    p_next += stride;
    cp_async_wait<kStages - 1>();  // this lane's copies have landed,
    __syncwarp();                  // and the other lanes' scales
    const unsigned char* cur = ring + stage * R::STAGE;
    stage = (stage + 1) % kStages;
    typename C::T kr[kSteps], vr[kSteps];
    float ksc[kSteps], vsc[kSteps];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int at = (st * 32 + lane) * R::CB;
      kr[st] = *reinterpret_cast<const typename C::T*>(cur + at);
      vr[st] = *reinterpret_cast<const typename C::T*>(cur + R::TILE + at);
      if (kQuant) {
        const float* scl = reinterpret_cast<const float*>(cur + 2 * R::TILE);
        ksc[st] = scl[st * PS + sub];
        vsc[st] = scl[BATCH + st * PS + sub];
      }
    }
    // scores: the lanes of a row each dot their chunk, then sum
    float x[kSteps][kRows];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      float kf[N];
      unpack(kr[st], kf);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < N; ++e) dot = fmaf(qv[r][e], kf[e], dot);
#pragma unroll
        for (int o = 1; o < CH; o <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        float sc = dot * scale;
        if (kQuant) sc *= ksc[st];
        x[st][r] = p0 + st * PS + sub < end ? sc : kNegInf;
      }
    }
    // online softmax over the batch: one maximum per row for the warp
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float bm = x[0][r];
#pragma unroll
      for (int st = 1; st < kSteps; ++st) bm = fmaxf(bm, x[st][r]);
#pragma unroll
      for (int o = CH; o < 32; o <<= 1)
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, o));
      const float m_new = fmaxf(m[r], bm);
      const float corr = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < N; ++e) acc[r][e] *= corr;
    }
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      float vf[N];
      unpack(vr[st], vf);
      const bool live = p0 + st * PS + sub < end;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float p = live ? expf(x[st][r] - m[r]) : 0.f;
        l[r] += p;
        // the denominator takes the unscaled p; the value scale only
        // rescales the values
        if (kQuant) p *= vsc[st];
#pragma unroll
        for (int e = 0; e < N; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  }

  cp_async_wait<0>();  // the empty groups past the range

  // the warp's sums over its position lanes (m is warp-uniform)
#pragma unroll
  for (int o = CH; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
      for (int e = 0; e < N; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
    }
  }
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int e = 0; e < N; ++e)
        reinterpret_cast<float*>(ring)[r * D + chunk * N + e] = acc[r][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ml_s[warp][r][0] = m[r];
      ml_s[warp][r][1] = l[r];
    }
  }
  __syncthreads();

  // the block's partial: its warps merged in warp order (a warp with no
  // position has m = -1e30 and weighs 0; warp 0 always has one)
  float* pp = part + (static_cast<long long>(pair) * gridDim.x + j) *
                         part_floats(rep, D);
  for (int e = threadIdx.x; e < nr * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml_s[w][r][0]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(ml_s[w][r][0] - mx);
      const float* acc_w = reinterpret_cast<const float*>(
          ring_raw + w * kStages * R::STAGE);
      num = fmaf(wt, acc_w[r * D + d], num);
      den = fmaf(wt, ml_s[w][r][1], den);
    }
    pp[(r0 + r) * D + d] = num;
    if (d == 0) {
      pp[rep * D + 2 * (r0 + r)] = mx;
      pp[rep * D + 2 * (r0 + r) + 1] = den;
    }
  }
}

// The merge: grid (B * KV, ceil(rep * D / kThreads)), one thread per
// output entry, the pair's live splits summed in split order (loads
// unrolled so that a thread keeps several in flight).  A row with no live
// position (idx < 0) gives 0.
template <typename QT, int D>
__global__ void __launch_bounds__(kThreads)
    decode_merge_kernel(const float* __restrict__ part,
                        const int32_t* __restrict__ idx,
                        QT* __restrict__ out, int n_kv, int seq_len, int rep,
                        int split, int n_splits) {
  const int pair = blockIdx.x;
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= rep * D) return;
  const int b = pair / n_kv, r = e / D;
  int last = idx[b];
  if (last > seq_len - 1) last = seq_len - 1;
  const int n_live = last < 0 ? 0 : last / split + 1;
  const long long stride = part_floats(rep, D);
  const float* pp = part + static_cast<long long>(pair) * n_splits * stride;
  const float* ml = pp + rep * D + 2 * r;  // (m, l) of row r, split 0
  float mx = kNegInf;
#pragma unroll 8
  for (int j = 0; j < n_live; ++j) mx = fmaxf(mx, ml[j * stride]);
  float num = 0.f, den = 0.f;
#pragma unroll 8
  for (int j = 0; j < n_live; ++j) {
    const float w = expf(ml[j * stride] - mx);
    num = fmaf(w, pp[j * stride + e], num);
    den = fmaf(w, ml[j * stride + 1], den);
  }
  store(out + (static_cast<size_t>(b) * n_kv * rep +
               static_cast<size_t>(pair % n_kv) * rep) * D + e,
        num / fmaxf(den, 1e-30f));
}

template <typename QT, typename KT, bool kQuant, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale, const void* idx,
                   void* out, void* part, int batch, int n_kv, int seq_len,
                   int rep, int split, cudaStream_t stream) {
  const int n_splits = (seq_len + split - 1) / split;
  const dim3 grid(n_splits, batch * n_kv, (rep + kRows - 1) / kRows);
  // the rings' shared memory (48 KB for a bf16 or f32 cache, four blocks
  // an SM), set on every launch as the default limit leaves no room for
  // the static merge buffer beside it
  const auto kernel = decode_split_kernel<QT, KT, kQuant, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<KT, D>::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, Ring<KT, D>::BYTES, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(idx),
      static_cast<float*>(part), n_kv, seq_len, rep, split,
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 merge_grid(batch * n_kv, (rep * D + kThreads - 1) / kThreads);
  decode_merge_kernel<QT, D><<<merge_grid, kThreads, 0, stream>>>(
      static_cast<const float*>(part), static_cast<const int32_t*>(idx),
      static_cast<QT*>(out), n_kv, seq_len, rep, split, n_splits);
  return cudaGetLastError();
}

template <typename QT, typename KT, bool kQuant>
int by_head_dim(int head_dim, const void* q, const void* k, const void* v,
                const void* ks, const void* vs, const void* idx, void* out,
                void* part, int batch, int n_kv, int seq_len, int rep,
                int split, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<QT, KT, kQuant, 16>(q, k, v, ks, vs, idx, out, part,
                                        batch, n_kv, seq_len, rep, split,
                                        stream);
    case 32:
      return launch<QT, KT, kQuant, 32>(q, k, v, ks, vs, idx, out, part,
                                        batch, n_kv, seq_len, rep, split,
                                        stream);
    case 64:
      return launch<QT, KT, kQuant, 64>(q, k, v, ks, vs, idx, out, part,
                                        batch, n_kv, seq_len, rep, split,
                                        stream);
    case 128:
      return launch<QT, KT, kQuant, 128>(q, k, v, ks, vs, idx, out, part,
                                         batch, n_kv, seq_len, rep, split,
                                         stream);
    default:
      return -1;
  }
}

template <typename QT>
int by_cache_dtype(int kv_dtype, int head_dim, const void* q, const void* k,
                   const void* v, const void* ks, const void* vs,
                   const void* idx, void* out, void* part, int batch,
                   int n_kv, int seq_len, int rep, int split,
                   cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return by_head_dim<QT, float, false>(head_dim, q, k, v, ks, vs, idx,
                                           out, part, batch, n_kv, seq_len,
                                           rep, split, stream);
    case kBF16:
      return by_head_dim<QT, __nv_bfloat16, false>(
          head_dim, q, k, v, ks, vs, idx, out, part, batch, n_kv, seq_len,
          rep, split, stream);
    case kI8:
      return by_head_dim<QT, int8_t, true>(head_dim, q, k, v, ks, vs, idx,
                                           out, part, batch, n_kv, seq_len,
                                           rep, split, stream);
    default:
      return -1;
  }
}

}  // namespace

// q [B, n_q, D] (head order kv-major: query head h * rep + r belongs to kv
// head h), k/v [B, KV, S, D], k_scale/v_scale [B, KV, S] f32 (int8 cache
// only, else null), idx [B] int32, out [B, n_q, D] in q's type, part f32
// scratch of B * KV * ceil(S / split) * rep * (D + 2) values; all
// contiguous on the current device.  split is a positive multiple of 32.
// Returns 0, a CUDA error code, or -1 for an unsupported type, head dim
// or split.
extern "C" int bf_decode_attention(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const void* idx,
                                   void* out, void* part, int batch, int n_kv,
                                   int seq_len, int rep, int head_dim,
                                   int split, int q_dtype, int kv_dtype,
                                   void* stream) {
  if (rep < 1 || rep > kMaxRep || batch < 1 || n_kv < 1 || seq_len < 1 ||
      split < kSplitUnit || split % kSplitUnit)
    return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32:
      return by_cache_dtype<float>(kv_dtype, head_dim, q, k, v, k_scale,
                                   v_scale, idx, out, part, batch, n_kv,
                                   seq_len, rep, split, s);
    case kBF16:
      return by_cache_dtype<__nv_bfloat16>(kv_dtype, head_dim, q, k, v,
                                           k_scale, v_scale, idx, out, part,
                                           batch, n_kv, seq_len, rep, split,
                                           s);
    default:
      return -1;
  }
}
