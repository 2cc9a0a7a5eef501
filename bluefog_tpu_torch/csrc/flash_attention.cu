// Flash attention for Hopper (sm_90a): the forward (K2) and the two
// backward kernels, dQ (K3a) and dK/dV (K3b).
//
// Replaces the Pallas TPU kernels of bluefog_tpu/parallel/
// pallas_attention.py: _kernel (K2, :107), _bwd_dq_kernel (K3a, :267) and
// _bwd_dkv_kernel (K3b, :309).  Layouts are the JAX package's: q, out, dO,
// dQ [B, T, H, D]; k, v, dK, dV [B, S, KV, D]; lse and delta [B, H, T]
// f32.  Query head h reads kv head h / (H / KV) (GQA by index, K and V are
// never widened).  Positions are global: query row i sits at q_off + i,
// key j at kv_off + j, and the causal rule keeps q_pos >= kv_pos.
//
// Numerics follow the TPU kernels: scores are products of the native
// operands accumulated in f32, times scale; masked scores are -1e30 and
// any score <= -5e29 gives p = 0, so a row with no live key ends with
// out = 0 and lse = -1e30; out = acc / max(l, 1e-30) and lse = m + log(l)
// where l > 0.  P is rounded to v's type before P·V, P to dO's type for
// dV, dS to q's type for dK and to k's type for dQ; delta = rowsum(dO·O)
// comes from the caller (computed outside the kernels, as in JAX).
//
// What bounds them on this card: tensor-core operations.  At the Llama
// training shape (B=4, H=32, KV=8, T=2048, D=128, causal) K2 does
// 4·B·H·T²·D/2 = 137 GFLOP over ~168 MB (~820 operations per byte, far
// above the card's ~295), K3a 6·B·H·T²·D/2 and K3b 8·B·H·T²·D/2.
//
// K2 in bf16 at D = 64 and 128 (every main-path shape: Llama-3.1-8B
// width, Llama-1B flash and splash, ViT-B/16) is built from what Hopper
// added (sm90_tile.cuh), in the shape of FlashAttention-3's forward:
//   a block serves one (batch, head).  Warpgroup 0 is the producer: one
//   thread loads Q once and keeps K and V tiles of 128 keys in flight
//   through a two-stage ring with TMA (4-D tensor maps over the
//   [B, T, H, D] / [B, S, KV, D] layouts, 128-byte swizzle, zeros out of
//   bounds), full and empty mbarriers per stage; setmaxnreg gives its
//   registers away (24).  Each consumer warpgroup owns 64 query rows:
//   S = Q·Kᵀ is one wgmma chain (m64n128k16, Q and K from shared memory,
//   K-major), the online softmax runs in the S accumulator registers, P
//   is rounded to bf16 in place as the register A operand of O += P·V
//   (m64nDk16, V MN-major through the transpose bit), and O stays in
//   registers until a masked store (rows past T never land) with lse.  At
//   D = 128 two consumers share a block (128 rows, 384 threads, 240
//   registers each; shared memory Q 32 KB + 2 stages x (K + V) 64 KB =
//   160 KB, one block an SM); at D = 64 one consumer (64 rows, 256
//   threads, 232 registers; 72 KB, two blocks an SM).  wgmma reads each
//   K/V tile once per 64-row warpgroup, where the mma.sync warps each
//   re-read it (~256 bytes of shared memory per mma.sync), and runs
//   asynchronously; a warpgroup's softmax overlaps the other's products.
//   The shared-memory size is set on every launch.  The tensor maps are
//   encoded on the host per call (cuTensorMapEncodeTiled through
//   cudaGetDriverEntryPoint, three maps, pure host work of about a
//   microsecond each).  The softmax keeps scores unscaled and takes
//   p = 2^(x·c - m·c) with c = scale·log2 e (one FFMA and one ex2 a
//   score), masks only on edge tiles, and reduces its row maxima in four
//   independent chains (a first version with a scaled copy, __expf and a
//   mask test on every score was markedly slower on the H100).
//   ptxas (-Xptxas -v, CUDA 12.9): at entry the launch bound's registers
//   (168 at D = 128, 128 at D = 64), setmaxnreg sharing them out as
//   above, no spills.  Tried on the H100 and not kept, each slower or no
//   faster: FlashAttention-3's intra-warpgroup overlap (tile j's S
//   product issued beside tile j - 1's P·V, two- or three-stage ring),
//   ping-pong turns of the two consumers on named barriers, a three-stage
//   ring, one consumer at D = 128.  Not yet: Q as register operands, FP8.
//
// K3a and K3b in bf16 at D = 64 and 128 take the same parts and shape:
//   K3a (dQ): a block serves NC · 64 query rows of one (batch, head),
//   longest causal tiles first.  The producer thread loads Q and dO once
//   (their own tensor maps over [B, T, H, D]) and keeps K and V tiles of
//   128 keys in flight through a two-stage ring.  Each consumer warpgroup
//   owns 64 rows, keeps their lse·log2 e and delta in registers, and per
//   key tile issues S = Q·Kᵀ and dP = dO·Vᵀ as two SS chains (both
//   K-major) in one commit group, waits once, takes P = 2^(x·c - lse·log2
//   e) in the S registers (one FFMA and one ex2 a score, the mask on edge
//   tiles only), dS = P·(dP - delta) in place, rounds dS to bf16 as the
//   register A operand (s_to_a) and issues dQ += dS·K (RS, K read
//   MN-major from the same swizzled tile through the transpose bit).  dQ
//   stays in f32 registers until a masked store of dQ·scale.
//   K3b (dK, dV): a block serves NC · 64 keys of one (batch, kv head),
//   the keys that see the most query tiles first; K and V are loaded
//   once.  The producer thread streams the (64-row query tile, group
//   member) pairs' Q and dO tiles by TMA through a two-stage ring, from
//   the first live tile on; the producer's second warp copies each pair's
//   64 lse and delta values into the same stage (zeros past T) and
//   arrives on the stage's full barrier.  Per pair each consumer issues
//   Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (SS m64n64, both K-major), waits once,
//   takes Pᵀ as above from each column's lse, rounds it to bf16 (dV's
//   A operand), forms dSᵀ = Pᵀ·(dPᵀ - delta) and its bf16 A operand, and
//   issues dV += Pᵀ·dO and dK += dSᵀ·Q (RS, dO and Q MN-major) in one
//   group.  dK and dV stay in f32 registers, written once (dK·scale).
//   Both take K2's block (WgSmem): one consumer at D = 64 (two blocks an
//   SM), two at D = 128, 128-key dQ steps and a two-stage ring.  Tried on
//   the H100 and not kept, each slower or no faster at the models' shapes:
//   64-key dQ steps, two consumers at D = 64, one dK/dV consumer at
//   D = 128, a third stage.  Every key (K3a) or query column (K3b) an edge
//   tile holds past the tensor is zeros from TMA, so every edge tile is
//   masked: a zero score is not a masked score.  ptxas (-Xptxas -v, CUDA
//   12.8): at entry 168 registers (D = 128) and 128 (D = 64), setmaxnreg
//   240 / 24 and 232 / 24 as K2, no spills; the overwriting first step of
//   each score chain (ss_chain) keeps S and dP dead between tiles.  At
//   the Llama-3.1-8B training shape each runs at ~550 TFLOP/s on the H100
//   (PERF.md), against ~200 and ~150 for the mma.sync design it replaces.
//
// K2, K3a and K3b in bf16 at D = 16 and 32 (test shapes only; no model of
// the repo runs them) keep the mma.sync kernels below: a 32- or 64-byte
// row needs other swizzles and descriptors, and the wrappers count those
// launches apart (launches_mma_sync).  They run on mma.sync m16n8k16
// (bf16 in, f32 accumulators): the score tile never leaves registers (the
// accumulator fragment of S is re-packed in place as the A operand of the
// next product), K/V (K2, K3a) or Q/dO (K3b) tiles stream through a
// two-stage cp.async ring in padded shared memory read with ldmatrix.
//
//   K2   block = 64 query rows of one (batch, head), 4 warps of 16 rows,
//        loop over 64-key tiles.
//   K3a  block = 64 query rows, loop over 64-key tiles: recompute P, then
//        dP = dO·Vᵀ, dS = P·(dP - delta), dQ += dS·K (scale at the end).
//   K3b  block = 64 keys of one (batch, kv head), 4 warps of 16 keys,
//        loop over (32-row query tile, group member) pairs in that order:
//        dV += Pᵀ·dO and dK += dSᵀ·Q in f32 registers, written once.
//
// In causal mode every kernel stops at its last live tile (K2, K3a) or
// starts at its first (K3b), the TPU kernels' _block_live.  The TPU grid
// walked k blocks in order into VMEM accumulators; here one block owns its
// rows (or keys) and loops over the tiles in a fixed order, so nothing is
// summed across blocks: no atomics, and dQ, dK and dV are bit-equal from
// run to run.
//
// Tails are masked (any T and S; the TPU kernels needed block divisors).
// D is 16, 32, 64 or 128.  bf16 runs on the tensor cores; f32 takes a
// plain FMA path (one thread per query row, or per key for K3b) with the
// same masking rules.
//
// The warp-level helpers (mma.sync, ldmatrix, cp.async) live in
// mma_tile.cuh, shared with splash_backward.cu (K5); the Hopper ones
// (TMA, mbarrier, wgmma, setmaxnreg, tensor maps) in sm90_tile.cuh.
//
// Plain C interface, bound with ctypes (bluefog_tpu_torch/parallel/
// flash_attention.py), which validates shapes, types, contiguity and
// 16-byte alignment (what TMA needs of a base address and row strides):
//   int bf_flash_forward(q, k, v, out, lse, B, T, S, H, KV, D, q_off,
//                        kv_off, causal, scale, dtype, stream)
//   int bf_flash_backward_dq(q, k, v, dout, lse, delta, dq, ...)
//   int bf_flash_backward_dkv(q, k, v, dout, lse, delta, dk, dv, ...)
// dtype: 0 = float32, 1 = bfloat16.  Each returns 0 or a CUDA error code
// (cudaGetLastError() after the launch).

#include "mma_tile.cuh"
#include "sm90_tile.cuh"

namespace {

struct Shape {
  int B, T, S, H, KV, rep;  // q [B, T, H, D]; k, v [B, S, KV, D]
  int q_off, kv_off, causal;
  float scale;
};

// Key tiles of width bk that hold a live key for query rows up to
// q_last: all of them without the causal mask, else up to the last key
// whose global position is <= q_off + q_last (the TPU's _block_live).
__device__ __forceinline__ int live_k_tiles(const Shape& s, int q_last,
                                            int bk) {
  const int nk = (s.S + bk - 1) / bk;
  if (!s.causal) return nk;
  const int last_key = s.q_off + q_last - s.kv_off;
  return last_key < 0 ? 0 : min(nk, last_key / bk + 1);
}

// Is score (query row qi, key kj) masked?  Keys past S are; with the
// causal mask, keys after the query's global position are.
__device__ __forceinline__ bool masked(const Shape& s, int qi, int kj) {
  return kj >= s.S || (s.causal && s.q_off + qi < s.kv_off + kj);
}

constexpr int kWarps = 4;
constexpr int kThreadsTc = 32 * kWarps;
constexpr int kBq = 16 * kWarps;   // K2/K3a: query rows per block
constexpr int kBk = 64;            // K2/K3a: keys per tile
constexpr int kBkB = 16 * kWarps;  // K3b: keys per block
constexpr int kBqB = 32;           // K3b: query rows per step

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // padded row: ldmatrix is conflict-free
  static constexpr int FWD = (kBq + 4 * kBk) * LD * 2;
  static constexpr int DQ = (2 * kBq + 4 * kBk) * LD * 2;
  static constexpr int DKV = (2 * kBkB + 4 * kBqB) * LD * 2 + 4 * kBqB * 4;
};

// ---------------------------------------------------------------------------
// K2, bf16 at D = 16 and 32: mma.sync.  grid (query tiles, B * H).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreadsTc)
    k2_forward_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out,
                  float* __restrict__ lse, Shape s) {
  constexpr int LD = Smem<D>::LD, NT = kBk / 8, ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBq * LD;   // [2][kBk][LD]
  bf16* Vs = Ks + 2 * kBk * LD;

  // causal: the last query tiles have the most live keys; start them first
  const int qt = s.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.y / s.H, h = blockIdx.y % s.H, kvh = h / s.rep;
  const int q0 = qt * kBq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long qs = (long long)s.H * D, ks = (long long)s.KV * D;
  const bf16* qg = q + ((long long)b * s.T * s.H + h) * D;
  const bf16* kg = k + ((long long)b * s.S * s.KV + kvh) * D;
  const bf16* vg = v + ((long long)b * s.S * s.KV + kvh) * D;
  const int n_live = live_k_tiles(s, min(q0 + kBq, s.T) - 1, kBk);

  load_rows<kBq, D, kThreadsTc>(Qs, qg, qs, q0, s.T, tid);
  if (n_live > 0) {
    load_rows<kBk, D, kThreadsTc>(Ks, kg, ks, 0, s.S, tid);
    load_rows<kBk, D, kThreadsTc>(Vs, vg, ks, 0, s.S, tid);
  }
  cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t qf[D / 16][4];
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  for (int j = 0; j < n_live; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j is in; tile j - 1's buffer is free
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        load_a(qf[kc], Qs + warp * 16 * LD + kc * 16, LD, lane);
    }
    if (j + 1 < n_live) {
      const int nb = (j + 1) & 1;
      load_rows<kBk, D, kThreadsTc>(Ks + nb * kBk * LD, kg, ks, (j + 1) * kBk,
                                    s.S, tid);
      load_rows<kBk, D, kThreadsTc>(Vs + nb * kBk * LD, vg, ks, (j + 1) * kBk,
                                    s.S, tid);
    }
    cp_async_commit();
    const bf16* kt = Ks + (j & 1) * kBk * LD;
    const bf16* vt = Vs + (j & 1) * kBk * LD;

    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    warp_abt_reg<NT, D>(sc, qf, kt, LD, lane);

    const int k0 = j * kBk;
    const bool edge = k0 + kBk > s.S ||
                      (s.causal && s.kv_off + k0 + kBk - 1 > s.q_off + q0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * s.scale;
        if (edge && masked(s, row0 + (e >> 1) * 8, k0 + n * 8 + 2 * t + (e & 1)))
          x = kNegInf;
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float nm = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = __expf(m[i] - nm);
      m[i] = nm;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[n][e];
        const float p = x <= kDead ? 0.f : __expf(x - m[e >> 1]);
        sc[n][e] = p;
        rs[e >> 1] += p;
      }
    // per-thread partial row sums; corr is uniform across the quad, so
    // the quad's sum at the end is the row's l
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];
    uint32_t pf[NT / 2][4];
    c_to_a<NT>(pf, sc);  // P in v's type (bf16)
    warp_ab<ND, NT / 2>(o, pf, vt, LD, lane);
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    const int row = row0 + i * 8;
    if (row >= s.T) continue;
    const float safe = fmaxf(li, 1e-30f);
    bf16* og = out + (((long long)b * s.T + row) * s.H + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(og + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * i] / safe, o[n][2 * i + 1] / safe);
    if (t == 0)
      lse[((long long)b * s.H + h) * s.T + row] =
          li > 0.f ? m[i] + logf(safe) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// K2, bf16 at D = 64 and 128: TMA + mbarrier ring + wgmma, warp-specialised.
// grid (query tiles, B * H): warpgroup 0 the producer, the consumers of 64
// query rows each after it.  D = 128: two consumers (128-row tiles, 384
// threads, one block an SM: 160 KB of shared memory).  D = 64: one
// consumer (64-row tiles, 256 threads, two blocks an SM), which the H100
// ran faster at both D = 64 shapes of the repo's models (Llama-1B, ViT).
// K3a and K3b below take the same block, tile and ring (WgSmem).
// ---------------------------------------------------------------------------
constexpr int kWgRows = 64;                  // query rows per consumer
constexpr int kBkW = 128;                    // keys per tile
constexpr int kStagesW = 2;                  // K/V ring depth

template <int D>
struct WgSmem {
  static constexpr int NC = D == 64 ? 1 : 2;   // consumer warpgroups
  static constexpr int ROWS = kWgRows * NC;    // query rows per block
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int BLOCKS_PER_SM = NC == 1 ? 2 : 1;
  // setmaxnreg: the producer gives its registers to the consumers; the
  // block's 65536 / BLOCKS_PER_SM registers are shared out exactly
  static constexpr int CONSUMER_REGS = NC == 1 ? 232 : 240;
  static constexpr int NB = D / 64;          // 64-column boxes per row
  static constexpr int QBOX = kWgRows * 128; // bytes of one box of Q rows
  static constexpr int KBOX = kBkW * 128;    // bytes of one box of keys
  static constexpr int Q = NB * QBOX;        // one consumer's Q tile
  static constexpr int KV = NB * KBOX;       // one K (or V) stage
  static constexpr int BARS = 1 + 3 * kStagesW;
  // the tiles, the barriers, and 1024 bytes to align the base (the 128B
  // swizzle's pattern repeats every 1024 bytes)
  static constexpr int BYTES = NC * Q + 2 * kStagesW * KV + 8 * BARS + 1024;
  // K3a (the same block of query rows): Q and dO, the K/V ring
  static constexpr int DQ_BYTES =
      2 * NC * Q + 2 * kStagesW * KV + 8 * (1 + 2 * kStagesW) + 1024;
  // K3b (NC · 64 keys): K and V, a ring of (Q, dO) tiles of 64 rows (Q
  // bytes each) with the pair's 64 lse and delta values
  static constexpr int DKV_BYTES = 2 * NC * Q +
                                   kStagesW * (2 * Q + 2 * kWgRows * 4) +
                                   8 * (1 + 2 * kStagesW) + 1024;
};

using sm90::align1024;
using sm90::exp2_approx;
using sm90::rs_chain;
using sm90::ss_chain;

// Issues sc[64 x 128] = Q[64 x D] · K[128 x D]ᵀ as one commit group (the
// caller waits): q and k at their first box (K-major, SBO 1024 bytes = 8
// rows); the k-th 16-column step starts 32·k bytes into its box.
template <int D>
__device__ __forceinline__ void qk_issue(float (&sc)[64], const void* q,
                                         const void* k) {
  using L = WgSmem<D>;
  const uint64_t dq = sm90::desc_sw128(q, 16, 1024);
  const uint64_t dk = sm90::desc_sw128(k, 16, 1024);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_ss_n128(sc,
                        sm90::desc_add(dq, (kk / 4) * L::QBOX + (kk % 4) * 32),
                        sm90::desc_add(dk, (kk / 4) * L::KBOX + (kk % 4) * 32),
                        kk > 0);
  sm90::wgmma_commit();
}

// Issues o[64 x D] += P[64 x 128] · V[128 x D] as one commit group: P as
// register A operands (s_to_a), V MN-major (LBO: the second 64-column
// box; SBO 1024 bytes = 8 keys); the k-th step of 16 keys starts 2048·k
// bytes in.
template <int D>
__device__ __forceinline__ void pv_issue(float (&o)[D / 2],
                                         const uint32_t (&p)[kBkW / 16][4],
                                         const void* v) {
  const uint64_t dv = sm90::desc_sw128(v, WgSmem<D>::KBOX, 1024);
  sm90::fence_regs(o);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBkW / 16; ++kk) {
    if constexpr (D == 128)
      sm90::wgmma_rs_n128(o, p[kk], sm90::desc_add(dv, kk * 2048), 1);
    else
      sm90::wgmma_rs_n64(o, p[kk], sm90::desc_add(dv, kk * 2048), 1);
  }
  sm90::wgmma_commit();
}

// The online softmax of one S tile in its accumulator registers (rows
// row0 and row0 + 8 of the thread, keys k0..): masks on an edge tile,
// updates m and l, turns sc into P (f32) and gives O's rescale per row.
// Scores stay unscaled (the scale is positive, so maxima agree): p =
// 2^(x·scale·log2 e - m·scale·log2 e), one FFMA and one ex2.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const Shape& s, int row0, int k0,
                                             bool edge, float sl2, int t) {
  if (edge) {
#pragma unroll
    for (int n = 0; n < kBkW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (masked(s, row0 + (e >> 1) * 8, k0 + n * 8 + 2 * t + (e & 1)))
          sc[4 * n + e] = kNegInf;
  }
  float mx[2][4];  // four independent chains per row
#pragma unroll
  for (int i = 0; i < 8; ++i) mx[i / 4][i % 4] = kNegInf;
#pragma unroll
  for (int n = 0; n < kBkW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1][(n & 1) * 2 + (e & 1)] =
          fmaxf(mx[e >> 1][(n & 1) * 2 + (e & 1)], sc[4 * n + e]);
  float ms[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float tile_max =
        fmaxf(fmaxf(mx[i][0], mx[i][1]), fmaxf(mx[i][2], mx[i][3]));
    const float nm = fmaxf(m[i], quad_max(tile_max));
    corr[i] = exp2_approx((m[i] - nm) * sl2);
    m[i] = nm;
    ms[i] = nm * sl2;
  }
  float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int n = 0; n < kBkW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = sc[4 * n + e];
      const float p = x <= kDead ? 0.f : exp2_approx(fmaf(x, sl2, -ms[e >> 1]));
      sc[4 * n + e] = p;
      rs[e >> 1][n & 1] += p;
    }
  // per-thread partial row sums; corr is uniform across the quad, so the
  // quad's sum at the end is the row's l
  l[0] = l[0] * corr[0] + (rs[0][0] + rs[0][1]);
  l[1] = l[1] * corr[1] + (rs[1][0] + rs[1][1]);
}

template <int D>
__global__ void __launch_bounds__(WgSmem<D>::THREADS,
                                  WgSmem<D>::BLOCKS_PER_SM)
    k2_forward_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     bf16* __restrict__ out, float* __restrict__ lse,
                     Shape s) {
  using L = WgSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);   // [consumer][box][64][64]
  unsigned char* Ks = Qs + L::NC * L::Q;  // [stage][box][128][64]
  unsigned char* Vs = Ks + kStagesW * L::KV;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(Vs + kStagesW * L::KV);
  uint64_t* full_k = full_q + 1;             // [stage]: K landed
  uint64_t* full_v = full_k + kStagesW;      // [stage]: V landed
  uint64_t* empty = full_v + kStagesW;       // [stage]: both consumers done

  // causal: the last query tiles have the most live keys; start them first
  const int qt = s.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.y / s.H, h = blockIdx.y % s.H, kvh = h / s.rep;
  const int q0 = qt * L::ROWS;
  const int n_live = live_k_tiles(s, min(q0 + L::ROWS, s.T) - 1, kBkW);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(full_q, 1);
    for (int i = 0; i < kStagesW; ++i) {
      sm90::mbar_init(full_k + i, 1);
      sm90::mbar_init(full_v + i, 1);
      sm90::mbar_init(empty + i, L::NC);  // one arrival a warpgroup
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full; the warpgroup gives its
    // registers to the consumers
    sm90::setmaxnreg_dec<24>();
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(full_q, L::NC * L::Q);
      for (int c = 0; c < L::NC; ++c)
        for (int nb = 0; nb < L::NB; ++nb)
          sm90::tma_load_4d(Qs + c * L::Q + nb * L::QBOX, &tq, full_q, nb * 64,
                            h, q0 + c * kWgRows, b);
      int stage = 0, phase = 1;  // a fresh barrier's parity-1 phase is done
      for (int j = 0; j < n_live; ++j) {
        sm90::mbar_wait(empty + stage, phase);
        sm90::mbar_arrive_expect_tx(full_k + stage, L::KV);
        for (int nb = 0; nb < L::NB; ++nb)
          sm90::tma_load_4d(Ks + stage * L::KV + nb * L::KBOX, &tk,
                            full_k + stage, nb * 64, kvh, j * kBkW, b);
        sm90::mbar_arrive_expect_tx(full_v + stage, L::KV);
        for (int nb = 0; nb < L::NB; ++nb)
          sm90::tma_load_4d(Vs + stage * L::KV + nb * L::KBOX, &tv,
                            full_v + stage, nb * 64, kvh, j * kBkW, b);
        if (++stage == kStagesW) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<L::CONSUMER_REGS>();
    const int c = wg - 1;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + c * kWgRows;      // this warpgroup's first row
    const int row0 = r0 + warp * 16 + g;  // this thread's rows: +0, +8
    // this warpgroup's own live tiles (at most the block's)
    const int my_live = live_k_tiles(s, min(r0 + kWgRows, s.T) - 1, kBkW);
    const unsigned char* qs = Qs + c * L::Q;
    const float sl2 = s.scale * 1.4426950408889634f;  // scale · log2(e)

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    sm90::mbar_wait(full_q, 0);

    // A tile is an edge tile when it may hold a masked score of this
    // warpgroup's rows.  The two consumers interleave on the SM: while one
    // runs its softmax, the other's products keep the tensor cores busy.
    float sc[64], corr[2];
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    int stage = 0, phase = 0;
    for (int j = 0; j < n_live; ++j) {
      sm90::mbar_wait(full_k + stage, phase);
      if (j < my_live) {
        const int k0 = j * kBkW;
        const bool edge = k0 + kBkW > s.S ||
                          (s.causal && s.kv_off + k0 + kBkW - 1 > s.q_off + r0);
        qk_issue<D>(sc, qs, Ks + stage * L::KV);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        softmax_tile(sc, m, l, corr, s, row0, k0, edge, sl2, t);
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[4 * n + e] *= corr[e >> 1];
        uint32_t pf[kBkW / 16][4];
        sm90::s_to_a<kBkW / 8>(pf, sc);  // P in v's type (bf16)
        sm90::mbar_wait(full_v + stage, phase);
        pv_issue<D>(o, pf, Vs + stage * L::KV);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
      }
      // past this warpgroup's causal edge the tile is the other
      // consumer's: the stage goes back once it has landed.  Either way
      // the warpgroup's products that read the stage have completed.
      if (tid == 0) sm90::mbar_arrive(empty + stage);
      if (++stage == kStagesW) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float li = quad_sum(l[i]);
      const int row = row0 + i * 8;
      if (row >= s.T) continue;
      const float safe = fmaxf(li, 1e-30f);
      bf16* og = out + (((long long)b * s.T + row) * s.H + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(og + n * 8 + 2 * t) =
            __floats2bfloat162_rn(o[4 * n + 2 * i] / safe,
                                  o[4 * n + 2 * i + 1] / safe);
      if (t == 0)
        lse[((long long)b * s.H + h) * s.T + row] =
            li > 0.f ? m[i] * s.scale + logf(safe) : kNegInf;
    }
  }
}

// The three tensor maps of a K2 launch: q as (D, H, T, B) in boxes of
// (64, 1, 64, 1), k and v as (D, KV, S, B) in boxes of (64, 1, 128, 1).
int k2_maps(CUtensorMap (&maps)[3], const void* q, const void* k,
            const void* v, const Shape& s, int D) {
  const uint64_t e = 2;  // bytes of a bf16
  const uint64_t qd[4] = {(uint64_t)D, (uint64_t)s.H, (uint64_t)s.T,
                          (uint64_t)s.B};
  const uint64_t qst[3] = {D * e, s.H * D * e, (uint64_t)s.T * s.H * D * e};
  const uint64_t kd[4] = {(uint64_t)D, (uint64_t)s.KV, (uint64_t)s.S,
                          (uint64_t)s.B};
  const uint64_t kst[3] = {D * e, s.KV * D * e,
                           (uint64_t)s.S * s.KV * D * e};
  const uint32_t qbox[4] = {64, 1, kWgRows, 1}, kbox[4] = {64, 1, kBkW, 1};
  int err = sm90::encode_bf16_4d(&maps[0], q, qd, qst, qbox);
  if (!err) err = sm90::encode_bf16_4d(&maps[1], k, kd, kst, kbox);
  if (!err) err = sm90::encode_bf16_4d(&maps[2], v, kd, kst, kbox);
  return err;
}

// ---------------------------------------------------------------------------
// K3a and K3b, bf16 at D = 64 and 128: TMA + mbarrier ring + wgmma,
// warp-specialised as K2 (warpgroup 0 the producer, consumers of 64 rows
// after it).  Each consumer recomputes its scores from the tiles in shared
// memory, takes P = 2^(x·c - lse·log2 e) with c = scale·log2 e on the
// unscaled score x (one FFMA and one ex2), masks on edge tiles only, and
// keeps its outputs in f32 registers until one masked store.
// ---------------------------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;

// K3a: a block owns the NC · 64 query rows of K2's block (WgSmem) of one
// (batch, head), Q and dO loaded once; K and V stream in tiles of 128 keys
// through K2's two-stage ring.  grid (B * H, query tiles): the tiles with
// the most live keys first.
template <int D>
__global__ void __launch_bounds__(WgSmem<D>::THREADS,
                                  WgSmem<D>::BLOCKS_PER_SM)
    k3a_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 Shape s) {
  using L = WgSmem<D>;
  constexpr int NC = L::NC, BK = kBkW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);  // [consumer][box][64][64]
  unsigned char* dOs = Qs + NC * L::Q;      // the same
  unsigned char* Ks = dOs + NC * L::Q;      // [stage][box][128][64]
  unsigned char* Vs = Ks + kStagesW * L::KV;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(Vs + kStagesW * L::KV);
  uint64_t* full = full_q + 1;         // [stage]: K and V landed
  uint64_t* empty = full + kStagesW;   // [stage]: every consumer done

  const int qt = s.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int b = blockIdx.x / s.H, h = blockIdx.x % s.H, kvh = h / s.rep;
  const int q0 = qt * L::ROWS;
  const int n_live = live_k_tiles(s, min(q0 + L::ROWS, s.T) - 1, BK);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(full_q, 1);
    for (int i = 0; i < kStagesW; ++i) {
      sm90::mbar_init(full + i, 1);
      sm90::mbar_init(empty + i, NC);  // one arrival a warpgroup
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::setmaxnreg_dec<24>();
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(full_q, 2 * NC * L::Q);
      for (int c = 0; c < NC; ++c)
        for (int nb = 0; nb < L::NB; ++nb) {
          const int at = c * L::Q + nb * L::QBOX, row = q0 + c * kWgRows;
          sm90::tma_load_4d(Qs + at, &tq, full_q, nb * 64, h, row, b);
          sm90::tma_load_4d(dOs + at, &tdo, full_q, nb * 64, h, row, b);
        }
      int stage = 0, phase = 1;  // a fresh barrier's parity-1 phase is done
      for (int j = 0; j < n_live; ++j) {
        sm90::mbar_wait(empty + stage, phase);
        sm90::mbar_arrive_expect_tx(full + stage, 2 * L::KV);
        for (int nb = 0; nb < L::NB; ++nb) {
          const int at = stage * L::KV + nb * L::KBOX;
          sm90::tma_load_4d(Ks + at, &tk, full + stage, nb * 64, kvh, j * BK,
                            b);
          sm90::tma_load_4d(Vs + at, &tv, full + stage, nb * 64, kvh, j * BK,
                            b);
        }
        if (++stage == kStagesW) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<L::CONSUMER_REGS>();
    const int c = wg - 1;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + c * kWgRows;      // this warpgroup's first row
    const int row0 = r0 + warp * 16 + g;  // this thread's rows: +0, +8
    const int my_live =
        r0 < s.T ? live_k_tiles(s, min(r0 + kWgRows, s.T) - 1, BK) : 0;
    const unsigned char* qs = Qs + c * L::Q;
    const unsigned char* dos = dOs + c * L::Q;
    const float sl2 = s.scale * kLog2e;
    float l2[2], dl[2];  // the rows' lse · log2 e and delta
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + i * 8;
      const long long at = ((long long)b * s.H + h) * s.T + row;
      l2[i] = row < s.T ? lse[at] * kLog2e : 0.f;
      dl[i] = row < s.T ? delta[at] : 0.f;
    }
    float acc[D / 2], sc[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    sm90::mbar_wait(full_q, 0);

    int stage = 0, phase = 0;
    for (int j = 0; j < n_live; ++j) {
      sm90::mbar_wait(full + stage, phase);
      if (j < my_live) {
        const int k0 = j * BK;
        const bool edge = k0 + BK > s.S ||
                          (s.causal && s.kv_off + k0 + BK - 1 > s.q_off + r0);
        const unsigned char* kt = Ks + stage * L::KV;
        // S = Q·Kᵀ and dP = dO·Vᵀ, one commit group
        sm90::wgmma_fence();
        ss_chain<D, BK>(sc, qs, L::QBOX, kt, L::KBOX);
        ss_chain<D, BK>(dp, dos, L::QBOX, Vs + stage * L::KV, L::KBOX);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        sm90::fence_regs(dp);
        if (edge) {  // keys past S (zeros from TMA) and the causal mask
#pragma unroll
          for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (masked(s, row0 + (e >> 1) * 8, k0 + n * 8 + 2 * t + (e & 1)))
                sc[4 * n + e] = kNegInf;
        }
        // dS = P · (dP - delta), in place
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const float x = sc[i];
          const int r = (i >> 1) & 1;
          const float p =
              x <= kDead ? 0.f : exp2_approx(fmaf(x, sl2, -l2[r]));
          sc[i] = p * (dp[i] - dl[r]);
        }
        uint32_t df[BK / 16][4];
        sm90::s_to_a<BK / 8>(df, sc);  // dS in k's type (bf16)
        // dQ += dS·K, K read MN-major from the same tile
        sm90::fence_regs(acc);
        sm90::wgmma_fence();
        rs_chain<D, BK / 16>(acc, df, kt, L::KBOX);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
      }
      // the warpgroup's products that read the stage have completed
      if (tid == 0) sm90::mbar_arrive(empty + stage);
      if (++stage == kStagesW) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + i * 8;
      if (row >= s.T) continue;
      bf16* dg = dq + (((long long)b * s.T + row) * s.H + h) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dg + n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i] * s.scale,
                                  acc[4 * n + 2 * i + 1] * s.scale);
    }
  }
}

// The first 64-row query tile whose last row reaches key k (causal: every
// later tile does too); 0 without the causal mask.
__device__ __forceinline__ int first_q_tile(const Shape& s, int k) {
  if (!s.causal) return 0;
  const int need = s.kv_off + k - s.q_off - (kWgRows - 1);
  return need <= 0 ? 0 : (need + kWgRows - 1) / kWgRows;
}

// K3b: a block owns NC · 64 keys of one (batch, kv head), K and V loaded
// once; (64-row query tile, group member) pairs stream through a
// two-stage ring: the pair's Q and dO tiles (TMA) and its 64 lse and
// delta values (the producer's second warp, zeros past T).  grid (B * KV,
// key tiles): the keys that see the most query tiles first.
template <int D>
__global__ void __launch_bounds__(WgSmem<D>::THREADS,
                                  WgSmem<D>::BLOCKS_PER_SM)
    k3b_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, Shape s) {
  using L = WgSmem<D>;
  constexpr int NC = L::NC, STAGES = kStagesW;
  constexpr int TILE = L::Q;  // 64 rows of D: a consumer's K, a Q stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);  // [consumer][box][64][64]
  unsigned char* Vs = Ks + NC * TILE;       // the same
  unsigned char* Qs = Vs + NC * TILE;       // [stage][box][64][64]
  unsigned char* dOs = Qs + STAGES * TILE;
  float* Ls = reinterpret_cast<float*>(dOs + STAGES * TILE);  // [stage][64]
  float* Ds = Ls + STAGES * kWgRows;
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(Ds + STAGES * kWgRows);
  uint64_t* full = full_kv + 1;      // [stage]: the pair's tiles and rows
  uint64_t* empty = full + STAGES;   // [stage]: every consumer done

  const int b = blockIdx.x / s.KV, kvh = blockIdx.x % s.KV;
  const int k0 = blockIdx.y * L::ROWS;
  const int p_begin = first_q_tile(s, k0) * s.rep;
  const int p_end = (s.T + kWgRows - 1) / kWgRows * s.rep;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(full_kv, 1);
    for (int i = 0; i < STAGES; ++i) {
      sm90::mbar_init(full + i, 2);  // the TMA thread and the row warp
      sm90::mbar_init(empty + i, NC);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::setmaxnreg_dec<24>();
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(full_kv, 2 * NC * TILE);
      for (int c = 0; c < NC; ++c)
        for (int nb = 0; nb < L::NB; ++nb) {
          const int at = c * TILE + nb * L::QBOX, key = k0 + c * kWgRows;
          sm90::tma_load_4d(Ks + at, &tk, full_kv, nb * 64, kvh, key, b);
          sm90::tma_load_4d(Vs + at, &tv, full_kv, nb * 64, kvh, key, b);
        }
      int stage = 0, phase = 1;
      for (int p = p_begin; p < p_end; ++p) {
        const int qi = p / s.rep, h = kvh * s.rep + p % s.rep;
        sm90::mbar_wait(empty + stage, phase);
        sm90::mbar_arrive_expect_tx(full + stage, 2 * TILE);
        for (int nb = 0; nb < L::NB; ++nb) {
          const int at = stage * TILE + nb * L::QBOX;
          sm90::tma_load_4d(Qs + at, &tq, full + stage, nb * 64, h,
                            qi * kWgRows, b);
          sm90::tma_load_4d(dOs + at, &tdo, full + stage, nb * 64, h,
                            qi * kWgRows, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (tid >> 5 == 1) {
      // the pair's 64 lse and delta values, zeros past T, then one
      // arrival: __syncwarp orders the lanes' stores before it
      const int lane = tid & 31;
      int stage = 0, phase = 1;
      for (int p = p_begin; p < p_end; ++p) {
        const int q0 = p / s.rep * kWgRows, h = kvh * s.rep + p % s.rep;
        const long long at = ((long long)b * s.H + h) * s.T;
        sm90::mbar_wait(empty + stage, phase);
        for (int i = lane; i < kWgRows; i += 32) {
          const bool ok = q0 + i < s.T;
          Ls[stage * kWgRows + i] = ok ? lse[at + q0 + i] : 0.f;
          Ds[stage * kWgRows + i] = ok ? delta[at + q0 + i] : 0.f;
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(full + stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<L::CONSUMER_REGS>();
    const int c = wg - 1;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int kc0 = k0 + c * kWgRows;      // this warpgroup's first key
    const int key0 = kc0 + warp * 16 + g;  // this thread's keys: +0, +8
    // this warpgroup's first live pair (at or after the block's)
    const int my_begin = kc0 < s.S ? first_q_tile(s, kc0) * s.rep : p_end;
    const unsigned char* ks = Ks + c * TILE;
    const unsigned char* vs = Vs + c * TILE;
    const float sl2 = s.scale * kLog2e;
    // dK, dV [64 keys x D]; Sᵀ, dPᵀ [64 keys x 64 queries]
    float dka[D / 2], dva[D / 2], st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    sm90::mbar_wait(full_kv, 0);

    int stage = 0, phase = 0;
    for (int p = p_begin; p < p_end; ++p) {
      sm90::mbar_wait(full + stage, phase);
      if (p >= my_begin) {
        const int q0 = p / s.rep * kWgRows;
        const bool edge =
            q0 + kWgRows > s.T || kc0 + kWgRows > s.S ||
            (s.causal && s.kv_off + kc0 + kWgRows - 1 > s.q_off + q0);
        const unsigned char* qt = Qs + stage * TILE;
        const unsigned char* dot = dOs + stage * TILE;
        const float* lt = Ls + stage * kWgRows;
        const float* dt = Ds + stage * kWgRows;
        // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, one commit group
        sm90::wgmma_fence();
        ss_chain<D, 64>(st, ks, L::QBOX, qt, L::QBOX);
        ss_chain<D, 64>(dpt, vs, L::QBOX, dot, L::QBOX);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);
        if (edge) {  // query columns past T, keys past S, the causal mask
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int qi = q0 + n * 8 + 2 * t + (e & 1);
              if (qi >= s.T || masked(s, qi, key0 + (e >> 1) * 8))
                st[4 * n + e] = kNegInf;
            }
        }
        // Pᵀ, then dSᵀ = Pᵀ · (dPᵀ - delta), each column's lse and delta
        // from the pair's rows in shared memory
        uint32_t pf[4][4], sf[4][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 lv =
              *reinterpret_cast<const float2*>(lt + n * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = st[4 * n + e];
            const float l2 = ((e & 1) ? lv.y : lv.x) * kLog2e;
            st[4 * n + e] = x <= kDead ? 0.f : exp2_approx(fmaf(x, sl2, -l2));
          }
        }
        sm90::s_to_a<8>(pf, st);  // Pᵀ in dO's type
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 dv2 =
              *reinterpret_cast<const float2*>(dt + n * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[4 * n + e] *= dpt[4 * n + e] - ((e & 1) ? dv2.y : dv2.x);
        }
        sm90::s_to_a<8>(sf, st);  // dSᵀ in q's type
        // dV += Pᵀ·dO and dK += dSᵀ·Q, dO and Q read MN-major
        sm90::fence_regs(dva);
        sm90::fence_regs(dka);
        sm90::wgmma_fence();
        rs_chain<D, 4>(dva, pf, dot, L::QBOX);
        rs_chain<D, 4>(dka, sf, qt, L::QBOX);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dva);
        sm90::fence_regs(dka);
      }
      // every warp read the stage's lse and delta before it issued its
      // part of the products, which have completed
      if (tid == 0) sm90::mbar_arrive(empty + stage);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + i * 8;
      if (key >= s.S) continue;
      const long long at = (((long long)b * s.S + key) * s.KV + kvh) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + n * 8 + 2 * t) =
            __floats2bfloat162_rn(dka[4 * n + 2 * i] * s.scale,
                                  dka[4 * n + 2 * i + 1] * s.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + n * 8 + 2 * t) =
            __floats2bfloat162_rn(dva[4 * n + 2 * i], dva[4 * n + 2 * i + 1]);
      }
    }
  }
}

// The tensor maps of a K3a or K3b launch: q and dO as (D, H, T, B) in boxes
// of (64, 1, 64, 1); k and v as (D, KV, S, B) in boxes of (64, 1, krows, 1).
int bwd_maps(CUtensorMap* maps, const void* q, const void* dout,
             const void* k, const void* v, const Shape& s, int D,
             int krows) {
  const uint64_t e = 2;  // bytes of a bf16
  const uint64_t qd[4] = {(uint64_t)D, (uint64_t)s.H, (uint64_t)s.T,
                          (uint64_t)s.B};
  const uint64_t qst[3] = {D * e, s.H * D * e, (uint64_t)s.T * s.H * D * e};
  const uint64_t kd[4] = {(uint64_t)D, (uint64_t)s.KV, (uint64_t)s.S,
                          (uint64_t)s.B};
  const uint64_t kst[3] = {D * e, s.KV * D * e,
                           (uint64_t)s.S * s.KV * D * e};
  const uint32_t qbox[4] = {64, 1, kWgRows, 1};
  const uint32_t kbox[4] = {64, 1, (uint32_t)krows, 1};
  int err = sm90::encode_bf16_4d(&maps[0], q, qd, qst, qbox);
  if (!err) err = sm90::encode_bf16_4d(&maps[1], dout, qd, qst, qbox);
  if (!err) err = sm90::encode_bf16_4d(&maps[2], k, kd, kst, kbox);
  if (!err) err = sm90::encode_bf16_4d(&maps[3], v, kd, kst, kbox);
  return err;
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, const Shape& s, cudaStream_t st) {
  using L = WgSmem<D>;
  const int tiles = (s.T + L::ROWS - 1) / L::ROWS;
  if (tiles > 65535) return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  int err = bwd_maps(maps, q, dout, k, v, s, D, kBkW);
  if (!err) err = set_smem(k3a_dq_wgmma<D>, L::DQ_BYTES);
  if (err) return err;
  k3a_dq_wgmma<D><<<dim3(s.B * s.H, tiles), L::THREADS, L::DQ_BYTES, st>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta,
      static_cast<bf16*>(dq), s);
  return 0;
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, const Shape& s, cudaStream_t st) {
  using L = WgSmem<D>;
  const int tiles = (s.S + L::ROWS - 1) / L::ROWS;
  if (tiles > 65535) return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  int err = bwd_maps(maps, q, dout, k, v, s, D, kWgRows);
  if (!err) err = set_smem(k3b_dkv_wgmma<D>, L::DKV_BYTES);
  if (err) return err;
  k3b_dkv_wgmma<D><<<dim3(s.B * s.KV, tiles), L::THREADS, L::DKV_BYTES,
                     st>>>(maps[0], maps[1], maps[2], maps[3], lse, delta,
                           static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                           s);
  return 0;
}

// ---------------------------------------------------------------------------
// K3a, bf16 at D = 16 and 32: mma.sync.  grid (query tiles, B * H).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreadsTc)
    k3a_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, Shape s) {
  constexpr int LD = Smem<D>::LD, NT = kBk / 8, ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kBq * LD;
  bf16* Ks = dOs + kBq * LD;  // [2][kBk][LD]
  bf16* Vs = Ks + 2 * kBk * LD;

  const int qt = s.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int b = blockIdx.y / s.H, h = blockIdx.y % s.H, kvh = h / s.rep;
  const int q0 = qt * kBq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long qs = (long long)s.H * D, ks = (long long)s.KV * D;
  const long long qoff = ((long long)b * s.T * s.H + h) * D;
  const bf16* kg = k + ((long long)b * s.S * s.KV + kvh) * D;
  const bf16* vg = v + ((long long)b * s.S * s.KV + kvh) * D;
  const int n_live = live_k_tiles(s, min(q0 + kBq, s.T) - 1, kBk);

  load_rows<kBq, D, kThreadsTc>(Qs, q + qoff, qs, q0, s.T, tid);
  load_rows<kBq, D, kThreadsTc>(dOs, dout + qoff, qs, q0, s.T, tid);
  if (n_live > 0) {
    load_rows<kBk, D, kThreadsTc>(Ks, kg, ks, 0, s.S, tid);
    load_rows<kBk, D, kThreadsTc>(Vs, vg, ks, 0, s.S, tid);
  }
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    const long long at = ((long long)b * s.H + h) * s.T + row;
    lse_r[i] = row < s.T ? lse[at] : 0.f;
    delta_r[i] = row < s.T ? delta[at] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int j = 0; j < n_live; ++j) {
    cp_async_wait_all();
    __syncthreads();
    if (j + 1 < n_live) {
      const int nb = (j + 1) & 1;
      load_rows<kBk, D, kThreadsTc>(Ks + nb * kBk * LD, kg, ks, (j + 1) * kBk,
                                    s.S, tid);
      load_rows<kBk, D, kThreadsTc>(Vs + nb * kBk * LD, vg, ks, (j + 1) * kBk,
                                    s.S, tid);
    }
    cp_async_commit();
    const bf16* kt = Ks + (j & 1) * kBk * LD;
    const bf16* vt = Vs + (j & 1) * kBk * LD;

    float p[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = dp[n][e] = 0.f;
    warp_abt<NT, D>(p, Qs + warp * 16 * LD, kt, LD, lane);
    warp_abt<NT, D>(dp, dOs + warp * 16 * LD, vt, LD, lane);
    const int k0 = j * kBk;
    const bool edge = k0 + kBk > s.S ||
                      (s.causal && s.kv_off + k0 + kBk - 1 > s.q_off + q0);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = p[n][e] * s.scale;
        if (edge && masked(s, row0 + (e >> 1) * 8, k0 + n * 8 + 2 * t + (e & 1)))
          x = kNegInf;
        const float pr = x <= kDead ? 0.f : __expf(x - lse_r[e >> 1]);
        p[n][e] = pr * (dp[n][e] - delta_r[e >> 1]);  // dS
      }
    uint32_t df[NT / 2][4];
    c_to_a<NT>(df, p);  // dS in k's type
    warp_ab<ND, NT / 2>(acc, df, kt, LD, lane);
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + i * 8;
    if (row >= s.T) continue;
    bf16* dg = dq + (((long long)b * s.T + row) * s.H + h) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dg + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * i] * s.scale,
                                acc[n][2 * i + 1] * s.scale);
  }
}

// ---------------------------------------------------------------------------
// K3b, bf16 at D = 16 and 32: mma.sync.  grid (key tiles, B * KV).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreadsTc)
    k3b_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, Shape s) {
  constexpr int LD = Smem<D>::LD, NQ = kBqB / 8, ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBkB * LD;
  bf16* Qs = Vs + kBkB * LD;       // [2][kBqB][LD]
  bf16* dOs = Qs + 2 * kBqB * LD;  // [2][kBqB][LD]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * kBqB * LD);  // [2][kBqB]
  float* Ds = Ls + 2 * kBqB;                                  // [2][kBqB]

  const int b = blockIdx.y / s.KV, kvh = blockIdx.y % s.KV;
  const int k0 = blockIdx.x * kBkB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long qs = (long long)s.H * D, ks = (long long)s.KV * D;
  const long long koff = ((long long)b * s.S * s.KV + kvh) * D;
  const int nq = (s.T + kBqB - 1) / kBqB;
  // causal: the first query tile whose last row reaches this block's
  // first key (every later tile is live too)
  int first = 0;
  if (s.causal) {
    const int need = s.kv_off + k0 - s.q_off - (kBqB - 1);
    first = need <= 0 ? 0 : (need + kBqB - 1) / kBqB;
  }
  const int p_begin = first * s.rep, p_end = nq * s.rep;

  // (query tile, group member) pair p into buffer buf
  auto load_pair = [&](int p, int buf) {
    const int qi = p / s.rep, h = kvh * s.rep + p % s.rep;
    const long long qoff = ((long long)b * s.T * s.H + h) * D;
    load_rows<kBqB, D, kThreadsTc>(Qs + buf * kBqB * LD, q + qoff, qs,
                                   qi * kBqB, s.T, tid);
    load_rows<kBqB, D, kThreadsTc>(dOs + buf * kBqB * LD, dout + qoff, qs,
                                   qi * kBqB, s.T, tid);
    if (tid < kBqB) {
      const int row = qi * kBqB + tid;
      const bool ok = row < s.T;
      const long long at = ok ? ((long long)b * s.H + h) * s.T + row : 0;
      cp_async4(Ls + buf * kBqB + tid, lse + at, ok);
      cp_async4(Ds + buf * kBqB + tid, delta + at, ok);
    }
  };

  load_rows<kBkB, D, kThreadsTc>(Ks, k + koff, ks, k0, s.S, tid);
  load_rows<kBkB, D, kThreadsTc>(Vs, v + koff, ks, k0, s.S, tid);
  if (p_begin < p_end) load_pair(p_begin, 0);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  for (int p = p_begin; p < p_end; ++p) {
    const int buf = (p - p_begin) & 1;
    cp_async_wait_all();
    __syncthreads();
    if (p + 1 < p_end) load_pair(p + 1, buf ^ 1);
    cp_async_commit();
    const int q0 = (p / s.rep) * kBqB;
    const bf16* qt = Qs + buf * kBqB * LD;
    const bf16* dot = dOs + buf * kBqB * LD;
    const float* lt = Ls + buf * kBqB;
    const float* dt = Ds + buf * kBqB;

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
        const int col = n * 8 + 2 * t + (e & 1);
        float x = pt[n][e] * s.scale;
        if (q0 + col >= s.T || masked(s, q0 + col, key0 + (e >> 1) * 8))
          x = kNegInf;
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
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + i * 8;
    if (key >= s.S) continue;
    const long long at = (((long long)b * s.S + key) * s.KV + kvh) * D;
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
// f32 FMA path: one thread per query row (K2, K3a) or key (K3b), the same
// masking and guards, f32 products and exact expf.
// ---------------------------------------------------------------------------
constexpr int kThreadsFma = 128;

// keys a query row sees: [0, n) with the causal mask, all S without
__device__ __forceinline__ int row_keys(const Shape& s, int row) {
  if (!s.causal) return s.S;
  return max(0, min(s.S, s.q_off + row - s.kv_off + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreadsFma)
    k2_forward_fma(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ lse, Shape s) {
  const int row = blockIdx.x * kThreadsFma + threadIdx.x;
  const int b = blockIdx.y / s.H, h = blockIdx.y % s.H, kvh = h / s.rep;
  if (row >= s.T) return;
  const long long qa = (((long long)b * s.T + row) * s.H + h) * D;
  float qv[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qv[d] = q[qa + d];
    acc[d] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int n = row_keys(s, row);
  for (int j = 0; j < n; ++j) {
    const long long ka = (((long long)b * s.S + j) * s.KV + kvh) * D;
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) dot = fmaf(qv[d], k[ka + d], dot);
    const float x = dot * s.scale;
    if (x > m) {
      const float corr = expf(m - x);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
      m = x;
    }
    const float p = expf(x - m);
    l += p;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v[ka + d], acc[d]);
  }
  const float safe = fmaxf(l, 1e-30f);
#pragma unroll
  for (int d = 0; d < D; ++d) out[qa + d] = acc[d] / safe;
  lse[((long long)b * s.H + h) * s.T + row] = l > 0.f ? m + logf(safe)
                                                      : kNegInf;
}

template <int D>
__global__ void __launch_bounds__(kThreadsFma)
    k3a_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, Shape s) {
  const int row = blockIdx.x * kThreadsFma + threadIdx.x;
  const int b = blockIdx.y / s.H, h = blockIdx.y % s.H, kvh = h / s.rep;
  if (row >= s.T) return;
  const long long qa = (((long long)b * s.T + row) * s.H + h) * D;
  const long long ra = ((long long)b * s.H + h) * s.T + row;
  const float lr = lse[ra], dr = delta[ra];
  float qv[D], dov[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qv[d] = q[qa + d];
    dov[d] = dout[qa + d];
    acc[d] = 0.f;
  }
  const int n = row_keys(s, row);
  for (int j = 0; j < n; ++j) {
    const long long ka = (((long long)b * s.S + j) * s.KV + kvh) * D;
    float sd = 0.f, pd = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      sd = fmaf(qv[d], k[ka + d], sd);
      pd = fmaf(dov[d], v[ka + d], pd);
    }
    const float ds = expf(sd * s.scale - lr) * (pd - dr);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, k[ka + d], acc[d]);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) dq[qa + d] = acc[d] * s.scale;
}

template <int D>
__global__ void __launch_bounds__(kThreadsFma)
    k3b_dkv_fma(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, Shape s) {
  const int key = blockIdx.x * kThreadsFma + threadIdx.x;
  const int b = blockIdx.y / s.KV, kvh = blockIdx.y % s.KV;
  if (key >= s.S) return;
  const long long ka = (((long long)b * s.S + key) * s.KV + kvh) * D;
  float kv[D], vv[D], dka[D], dva[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kv[d] = k[ka + d];
    vv[d] = v[ka + d];
    dka[d] = dva[d] = 0.f;
  }
  // causal: query rows whose global position reaches this key
  const int first = s.causal ? max(0, s.kv_off + key - s.q_off) : 0;
  for (int i = first; i < s.T; ++i) {
    for (int r = 0; r < s.rep; ++r) {
      const int h = kvh * s.rep + r;
      const long long qa = (((long long)b * s.T + i) * s.H + h) * D;
      const long long ra = ((long long)b * s.H + h) * s.T + i;
      float sd = 0.f, pd = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        sd = fmaf(q[qa + d], kv[d], sd);
        pd = fmaf(dout[qa + d], vv[d], pd);
      }
      const float p = expf(sd * s.scale - lse[ra]);
      const float ds = p * (pd - delta[ra]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dva[d] = fmaf(p, dout[qa + d], dva[d]);
        dka[d] = fmaf(ds, q[qa + d], dka[d]);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dk[ka + d] = dka[d] * s.scale;
    dv[ka + d] = dva[d];
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
template <int D>
int launch_forward(const void* q, const void* k, const void* v, void* out,
                   void* lse, const Shape& s, int dtype, cudaStream_t st) {
  if (dtype == kBF16) {
    if constexpr (D >= 64) {
      CUtensorMap maps[3];
      int err = k2_maps(maps, q, k, v, s, D);
      if (!err) err = set_smem(k2_forward_wgmma<D>, WgSmem<D>::BYTES);
      if (err) return err;
      using L = WgSmem<D>;
      dim3 grid((s.T + L::ROWS - 1) / L::ROWS, s.B * s.H);
      k2_forward_wgmma<D><<<grid, L::THREADS, L::BYTES, st>>>(
          maps[0], maps[1], maps[2], static_cast<bf16*>(out),
          static_cast<float*>(lse), s);
    } else {
      const int err = set_smem(k2_forward_tc<D>, Smem<D>::FWD);
      if (err) return err;
      dim3 grid((s.T + kBq - 1) / kBq, s.B * s.H);
      k2_forward_tc<D><<<grid, kThreadsTc, Smem<D>::FWD, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(out),
          static_cast<float*>(lse), s);
    }
  } else {
    dim3 grid((s.T + kThreadsFma - 1) / kThreadsFma, s.B * s.H);
    k2_forward_fma<D><<<grid, kThreadsFma, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), s);
  }
  return 0;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, const Shape& s,
              int dtype, cudaStream_t st) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == kBF16) {
    if constexpr (D >= 64) {
      return launch_dq_wgmma<D>(q, k, v, dout, l, dl, dq, s, st);
    } else {
      const int err = set_smem(k3a_dq_tc<D>, Smem<D>::DQ);
      if (err) return err;
      dim3 grid((s.T + kBq - 1) / kBq, s.B * s.H);
      k3a_dq_tc<D><<<grid, kThreadsTc, Smem<D>::DQ, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, dl,
          static_cast<bf16*>(dq), s);
    }
  } else {
    dim3 grid((s.T + kThreadsFma - 1) / kThreadsFma, s.B * s.H);
    k3a_dq_fma<D><<<grid, kThreadsFma, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        static_cast<float*>(dq), s);
  }
  return 0;
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const Shape& s, int dtype, cudaStream_t st) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == kBF16) {
    if constexpr (D >= 64) {
      return launch_dkv_wgmma<D>(q, k, v, dout, l, dl, dk, dv, s, st);
    } else {
      const int err = set_smem(k3b_dkv_tc<D>, Smem<D>::DKV);
      if (err) return err;
      dim3 grid((s.S + kBkB - 1) / kBkB, s.B * s.KV);
      k3b_dkv_tc<D><<<grid, kThreadsTc, Smem<D>::DKV, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l, dl,
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), s);
    }
  } else {
    dim3 grid((s.S + kThreadsFma - 1) / kThreadsFma, s.B * s.KV);
    k3b_dkv_fma<D><<<grid, kThreadsFma, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        static_cast<float*>(dk), static_cast<float*>(dv), s);
  }
  return 0;
}

// Validates the launch-independent arguments; 0 when they are usable.
int check(const Shape& s, int D, int dtype) {
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  if (D != 16 && D != 32 && D != 64 && D != 128) return cudaErrorInvalidValue;
  if (s.B < 1 || s.T < 1 || s.S < 1 || s.KV < 1 || s.H % s.KV)
    return cudaErrorInvalidValue;
  if ((long long)s.B * s.H > 65535) return cudaErrorInvalidValue;
  return 0;
}

Shape make_shape(int B, int T, int S, int H, int KV, int q_off, int kv_off,
                 int causal, float scale) {
  Shape s;
  s.B = B;
  s.T = T;
  s.S = S;
  s.H = H;
  s.KV = KV;
  s.rep = KV > 0 ? H / KV : 0;
  s.q_off = q_off;
  s.kv_off = kv_off;
  s.causal = causal;
  s.scale = scale;
  return s;
}

}  // namespace

extern "C" int bf_flash_forward(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int T, int S,
                                int H, int KV, int D, int q_off, int kv_off,
                                int causal, float scale, int dtype,
                                void* stream) {
  const Shape s = make_shape(B, T, S, H, KV, q_off, kv_off, causal, scale);
  int err = check(s, D, dtype);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  BF_DISPATCH_D(D, launch_forward<kD>(q, k, v, out, lse, s, dtype, st));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bf_flash_backward_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int B, int T, int S, int H,
                                    int KV, int D, int q_off, int kv_off,
                                    int causal, float scale, int dtype,
                                    void* stream) {
  const Shape s = make_shape(B, T, S, H, KV, q_off, kv_off, causal, scale);
  int err = check(s, D, dtype);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  BF_DISPATCH_D(D, launch_dq<kD>(q, k, v, dout, lse, delta, dq, s, dtype,
                                 st));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bf_flash_backward_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int T, int S,
                                     int H, int KV, int D, int q_off,
                                     int kv_off, int causal, float scale,
                                     int dtype, void* stream) {
  const Shape s = make_shape(B, T, S, H, KV, q_off, kv_off, causal, scale);
  int err = check(s, D, dtype);
  if (err) return err;
  if ((long long)B * KV > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  BF_DISPATCH_D(D, launch_dkv<kD>(q, k, v, dout, lse, delta, dk, dv, s,
                                  dtype, st));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
