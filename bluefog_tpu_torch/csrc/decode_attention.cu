// One-token GQA decode attention over a KV-head-major K/V cache, for
// Hopper (sm_90a).
//
// Replaces bluefog_tpu/parallel/pallas_decode.py::_decode_kernel (the
// TPU kernel behind decode_attention and decode_attention_int8).  It
// computes the same function: the single query of each (batch row,
// query head) attends over cache positions 0..idx[b] of its kv head,
// with an f32 online softmax, the TPU kernel's max(l, 1e-30) guard on
// the denominator, and, for the int8 cache, the key scale applied to
// the score columns and the value scale folded into float
// probabilities after the denominator is summed (never re-quantized).
//
// What bounds it on this card: device-memory bytes.  A call must read
// 2 * B * KV * (idx + 1) * D * elem bytes of cache (plus 2 * B * KV *
// (idx + 1) * 4 bytes of scales for int8) and does 2 * rep flops per
// cache element it reads (4 per byte of a bf16 cache at rep = 4), below
// the card's ~20 flops per byte at which f32 arithmetic would become
// the limit.  What the design does about
// it today: every cache byte at a position <= idx[b] is read once, in
// 16-byte vector loads, and nothing past idx[b] is read at all (the
// TPU kernel streamed and masked the whole cache length).  One block
// serves one (batch row, kv head) pair and its rep query heads, so the
// cache streams at its native kv-head count and is never widened.
// Splitting the positions across blocks (flash-decoding) and pipelined
// copies (cp.async / TMA) are left for later: a block is a sequential
// loop over 32-position tiles.
//
// idx is a [B] int32 tensor: one launch serves every row at its own
// position (the serving engine's slots).  A row whose idx is past the
// cache end reads the whole cache, as the TPU kernel's mask did.
//
// Plain C interface, bound with ctypes (bluefog_tpu_torch/parallel/
// decode_attention.py); the wrapper validates shapes, types and
// alignment before it calls bf_decode_attention.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;   // 4 warps per block
constexpr int kTile = 32;       // cache positions per shared-memory tile
constexpr int kMaxRep = 16;     // query heads per kv head
constexpr float kNegInf = -1e30f;

// dtype codes shared with the Python wrapper
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kI8 = 2;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

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

// Copy `rows` contiguous cache rows of D elements into shared memory as
// f32, with a row stride of D + 1 (no bank conflicts when the threads of
// a warp read one column of consecutive rows).  The rows are one
// contiguous run in device memory and D * sizeof(T) is a multiple of 16,
// so every 16-byte vector lies inside one row.
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          float* __restrict__ dst,
                                          int rows) {
  constexpr int kVec = 16 / sizeof(T);
  const int n_vec = rows * D / kVec;
  const uint4* src4 = reinterpret_cast<const uint4*>(src);
  for (int i = threadIdx.x; i < n_vec; i += kThreads) {
    const uint4 raw = src4[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    const int r = (i * kVec) / D;
    const int c = (i * kVec) % D;
    float* out = dst + r * (D + 1) + c;
#pragma unroll
    for (int j = 0; j < kVec; ++j) out[j] = to_float(e[j]);
  }
}

template <typename QT, typename KT, bool kQuant, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const QT* __restrict__ q,
                            const KT* __restrict__ k,
                            const KT* __restrict__ v,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int32_t* __restrict__ idx,
                            QT* __restrict__ out, int n_kv, int seq_len,
                            int rep, float scale) {
  constexpr int kOut = kMaxRep * D / kThreads;  // outputs per thread, max
  extern __shared__ float smem[];
  float* q_s = smem;                       // [rep][D]
  float* k_s = q_s + kMaxRep * D;          // [kTile][D + 1]
  float* v_s = k_s + kTile * (D + 1);      // [kTile][D + 1]
  float* p_s = v_s + kTile * (D + 1);      // [rep][kTile]
  float* ks_s = p_s + kMaxRep * kTile;     // [kTile]
  float* vs_s = ks_s + kTile;              // [kTile]
  float* m_s = vs_s + kTile;               // [rep] running max
  float* l_s = m_s + kMaxRep;              // [rep] running denominator
  float* c_s = l_s + kMaxRep;              // [rep] this tile's correction

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_q = n_kv * rep;
  const size_t pair = static_cast<size_t>(b) * n_kv + h;
  const QT* q_bh = q + (static_cast<size_t>(b) * n_q +
                        static_cast<size_t>(h) * rep) * D;
  QT* o_bh = out + (static_cast<size_t>(b) * n_q +
                    static_cast<size_t>(h) * rep) * D;
  const KT* k_bh = k + pair * seq_len * D;
  const KT* v_bh = v + pair * seq_len * D;
  const float* ks_bh = kQuant ? k_scale + pair * seq_len : nullptr;
  const float* vs_bh = kQuant ? v_scale + pair * seq_len : nullptr;

  int last = idx[b];
  if (last > seq_len - 1) last = seq_len - 1;
  const int n_pos = last + 1;  // positions 0..last are valid

  for (int i = threadIdx.x; i < rep * D; i += kThreads)
    q_s[i] = to_float(q_bh[i]);
  for (int r = threadIdx.x; r < rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) acc[j] = 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int t0 = 0; t0 < n_pos; t0 += kTile) {
    const int rows = min(kTile, n_pos - t0);
    load_rows<KT, D>(k_bh + static_cast<size_t>(t0) * D, k_s, rows);
    load_rows<KT, D>(v_bh + static_cast<size_t>(t0) * D, v_s, rows);
    if (kQuant) {
      for (int i = threadIdx.x; i < rows; i += kThreads) {
        ks_s[i] = ks_bh[t0 + i];
        vs_s[i] = vs_bh[t0 + i];
      }
    }
    __syncthreads();

    // scores [rep, rows]: s = (q . k) * scale, times the key scale
    for (int e = threadIdx.x; e < rep * rows; e += kThreads) {
      const int r = e / rows;
      const int s = e - r * rows;
      const float* qr = q_s + r * D;
      const float* kr = k_s + s * (D + 1);
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
      float sc = dot * scale;
      if (kQuant) sc *= ks_s[s];
      p_s[r * kTile + s] = sc;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int r = warp; r < rep; r += kThreads / 32) {
      float* pr = p_s + r * kTile;
      float mx = kNegInf;
      for (int s = lane; s < rows; s += 32) mx = fmaxf(mx, pr[s]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int s = lane; s < rows; s += 32) {
        float p = expf(pr[s] - m_new);
        sum += p;
        // the denominator takes the unscaled p; the value scale only
        // rescales the values
        if (kQuant) p *= vs_s[s];
        pr[s] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc [rep, D] = acc * corr + p @ v
#pragma unroll
    for (int j = 0; j < kOut; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (e < rep * D) {
        const int r = e / D;
        const int d = e % D;
        const float* pr = p_s + r * kTile;
        float a = acc[j] * c_s[r];
        for (int s = 0; s < rows; ++s) a = fmaf(pr[s], v_s[s * (D + 1) + d], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kOut; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (e < rep * D) {
      const int r = e / D;
      store(o_bh + e, acc[j] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

constexpr size_t smem_bytes(int d) {
  return sizeof(float) *
         (kMaxRep * d + 2 * kTile * (d + 1) + kMaxRep * kTile + 2 * kTile +
          3 * kMaxRep);
}

template <typename QT, typename KT, bool kQuant, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale, const void* idx,
                   void* out, int batch, int n_kv, int seq_len, int rep,
                   cudaStream_t stream) {
  static_assert(smem_bytes(D) <= 48 * 1024, "tile exceeds static smem");
  const dim3 grid(n_kv, batch);
  decode_attention_kernel<QT, KT, kQuant, D>
      <<<grid, kThreads, smem_bytes(D), stream>>>(
          static_cast<const QT*>(q), static_cast<const KT*>(k),
          static_cast<const KT*>(v), static_cast<const float*>(k_scale),
          static_cast<const float*>(v_scale),
          static_cast<const int32_t*>(idx), static_cast<QT*>(out), n_kv,
          seq_len, rep,
          static_cast<float>(1.0 / std::sqrt(static_cast<double>(D))));
  return cudaGetLastError();
}

template <typename QT, typename KT, bool kQuant>
int by_head_dim(int head_dim, const void* q, const void* k, const void* v,
                const void* ks, const void* vs, const void* idx, void* out,
                int batch, int n_kv, int seq_len, int rep,
                cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<QT, KT, kQuant, 16>(q, k, v, ks, vs, idx, out, batch,
                                        n_kv, seq_len, rep, stream);
    case 32:
      return launch<QT, KT, kQuant, 32>(q, k, v, ks, vs, idx, out, batch,
                                        n_kv, seq_len, rep, stream);
    case 64:
      return launch<QT, KT, kQuant, 64>(q, k, v, ks, vs, idx, out, batch,
                                        n_kv, seq_len, rep, stream);
    case 128:
      return launch<QT, KT, kQuant, 128>(q, k, v, ks, vs, idx, out, batch,
                                         n_kv, seq_len, rep, stream);
    default:
      return -1;
  }
}

template <typename QT>
int by_cache_dtype(int kv_dtype, int head_dim, const void* q, const void* k,
                   const void* v, const void* ks, const void* vs,
                   const void* idx, void* out, int batch, int n_kv,
                   int seq_len, int rep, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return by_head_dim<QT, float, false>(head_dim, q, k, v, ks, vs, idx,
                                           out, batch, n_kv, seq_len, rep,
                                           stream);
    case kBF16:
      return by_head_dim<QT, __nv_bfloat16, false>(head_dim, q, k, v, ks, vs,
                                                   idx, out, batch, n_kv,
                                                   seq_len, rep, stream);
    case kI8:
      return by_head_dim<QT, int8_t, true>(head_dim, q, k, v, ks, vs, idx,
                                           out, batch, n_kv, seq_len, rep,
                                           stream);
    default:
      return -1;
  }
}

}  // namespace

// q [B, n_q, D] (head order kv-major: query head h * rep + r belongs to kv
// head h), k/v [B, KV, S, D], k_scale/v_scale [B, KV, S] f32 (int8 cache
// only, else null), idx [B] int32, out [B, n_q, D] in q's type; all
// contiguous on the current device.  Returns 0, a CUDA error code, or -1
// for an unsupported type or head dim.
extern "C" int bf_decode_attention(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const void* idx,
                                   void* out, int batch, int n_kv,
                                   int seq_len, int rep, int head_dim,
                                   int q_dtype, int kv_dtype, void* stream) {
  if (rep < 1 || rep > kMaxRep || batch < 1 || n_kv < 1 || seq_len < 1)
    return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32:
      return by_cache_dtype<float>(kv_dtype, head_dim, q, k, v, k_scale,
                                   v_scale, idx, out, batch, n_kv, seq_len,
                                   rep, s);
    case kBF16:
      return by_cache_dtype<__nv_bfloat16>(kv_dtype, head_dim, q, k, v,
                                           k_scale, v_scale, idx, out, batch,
                                           n_kv, seq_len, rep, s);
    default:
      return -1;
  }
}
