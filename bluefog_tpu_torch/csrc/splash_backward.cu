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
// keys j <= i.  Per live (query, key) pair and head:
//   S = Q·Kᵀ, P = exp(S·scale - lse)   (-1e30 mask; p = 0 at <= -5e29)
//   dV += Pᵀ·dO                        (P rounded to dO's type)
//   dP = dO·Vᵀ, dS = P·(dP - delta)
//   dK += dSᵀ·Q                        (dS rounded to q's type)
//   dQ += dS·K                         (dS rounded to k's type)
// dK and dV stay in f32 registers and are written once (·scale for dK).
//
// dQ without atomics: the keys fall into spans (span() below); the block
// or cluster that owns a span writes its contribution to every row at or
// after the span's first key into that span's f32 partial, each (row,
// head) once, and a second kernel (k5_sum) sums each row's live partials
// in span order, times scale, in q's type.  dQ, dK and dV are bit-equal
// from run to run.  The partials are packed: partial j holds rows
// j·span .. T - 1 only (part_offset), so the buffer holds what is written.
//
// What bounds it on this card: operations, 5 products of 2·D per live
// (query, key) pair and head: 10·B·H·T(T+1)/2·D, 0.174 ms at the
// Llama-1B training shape (B=4, T=2048, H=32, KV=8, D=64) at 989 TFLOP/s.
// The partials add traffic the bound does not count: each live (row,
// span) pair writes D f32 and the sum reads it back.
//
// bf16 at D = 64 and 128 (every model path: Llama-1B at D 64, 8B width at
// D 128) is K3b's wgmma kernel (flash_attention.cu) with the fifth product
// added, k5_wgmma:
//   a block owns 128 keys of one (batch, kv head): two consumer
//   warpgroups of 64 keys, K and V loaded once by TMA; the producer thread
//   streams the (64-row query tile, group member) pairs' Q and dO through
//   a two-stage mbarrier ring, its second warp copies each pair's lse and
//   delta into the stage.  Per pair each consumer issues Sᵀ = K·Qᵀ and
//   dPᵀ = V·dOᵀ (SS, one commit group), forms Pᵀ = 2^(x·c - lse·log2 e)
//   and dSᵀ = Pᵀ·(dPᵀ - delta) in the accumulator registers, and issues
//   dV += Pᵀ·dO and dK += dSᵀ·Q (RS).  The bf16 dSᵀ operands also go to a
//   128-byte-swizzled shared tile (keys as rows, the 64 query columns as
//   one 128-byte row; sm90::store_a_sw128), fenced for the async proxy;
//   after a named barrier of the consumers, consumer c computes dQ's
//   columns c·D/2 .. for the pair's 64 rows over the block's 128 keys in
//   one SS chain (sm90::ss_chain_mn): A = dS read MN-major from the dSᵀ
//   tile (the transpose bit), B = the resident K tiles read MN-major.
//   Both consumers' dS sit side by side, so the product's K dimension
//   sums the block's keys.  A cluster of two blocks along the key axis
//   covers one 256-key span.  Block r sums rows 32r .. 32r + 31 of each
//   pair: every live block puts those rows of its dQ tile into its own
//   slot of block r's receive buffer (two buffers, by pair parity): its
//   own rows by plain stores and an arrival, the peer's staged in the
//   dS tile the dQ chains have just read and sent by one bulk copy
//   (cp.async.bulk into the peer's shared memory, the bytes completed on
//   the peer's rx_full).  Block r sums the live slots in rank (key) order
//   into the span's partial while the next pair's products run, then
//   arrives on both blocks' rx_free.
//   Every block of a cluster walks the pairs from the span's first live
//   query tile, so the barriers match; a block whose keys all lie after a
//   pair's rows skips its products there.  At T = 2048: 8 partials a row
//   at most, where the 64-key blocks of the design this replaces wrote 32.
//   Measured on the H100 and not kept: four blocks of 64 keys a cluster
//   at D 64 (twice the traffic between blocks); blocks reading their
//   peers' tiles after an mbarrier.arrive.release.cluster (the release
//   waits for the block's earlier global stores); the sum on
//   the producer warpgroup's spare warps (it hung; cause not found); 16-
//   byte pushes after a lane exchange (no faster); st.async pushes of
//   8 bytes from the registers (kept until the bulk copy, which was as
//   fast at D 64 and faster at D 128).
// D 16/32 bf16 (test shapes only) keeps the mma.sync kernel k5_tc (one
// block per 64-key span, 4 warps of 16 keys, 32-row query steps, padded
// shared memory read with ldmatrix, dS through a plain bf16 tile), and f32
// a plain FMA path (one thread per key) with the same masking rules; both
// write 64-key partials.
//
// Every tile at an edge is masked: query columns past T and keys past T
// arrive as zeros from TMA, and a zero score is not a masked one.  T need
// not be a multiple of 64 (the Python wrapper refuses T % 128 for parity
// with the JAX one).  D is 16, 32, 64 or 128.
//
// Plain C interface, bound with ctypes (bluefog_tpu_torch/parallel/
// splash.py), which validates shapes, types and alignment:
//   int bf_splash_key_tile(dtype, D)  // keys per dQ partial (the span)
//   int bf_splash_backward(q, k, v, dout, lse, delta, part, dq, dk, dv,
//                          B, T, H, KV, D, scale, dtype, stream)
// dtype: 0 = float32, 1 = bfloat16.  part is the packed f32 partial buffer
// (B·H·D · Σ_j (T - j·span) floats).  Returns 0 or a CUDA error code.

#include "mma_tile.cuh"
#include "sm90_tile.cuh"

namespace {

struct Dims {
  int B, T, H, KV, rep;
  float scale;
};

// Where partial j (of `span` keys) starts in the packed buffer: partial i
// holds B x (T - i·span) rows of H·D floats.
__host__ __device__ __forceinline__ long long part_offset(int j, int span,
                                                          const Dims& s) {
  return (long long)s.B * s.H * ((long long)j * s.T -
                                 (long long)span * j * (j - 1) / 2);
}
// Row `row` (>= j·span) of batch b in partial j, at its first of H·D.
__host__ __device__ __forceinline__ long long part_row(int j, int span,
                                                       int b, int row,
                                                       const Dims& s) {
  return part_offset(j, span, s) +
         ((long long)b * (s.T - j * span) + row - j * span) * s.H;
}

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
  // this block's dQ partial: rows k0 .. T - 1 of batch b
  float* pg = part + part_row(j, kBk, b, k0, s) * D;
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
        float* dst = pg + ((long long)(row - k0) * s.H + h) * D + c0 + 2 * t;
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
  float* pg = part + part_row(j, kBk, b, k0, s) * D;
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
        pg[((long long)(i - k0) * s.H + h) * D + d] = acc;
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
// bf16 at D = 64 and 128: TMA + mbarrier ring + wgmma, a cluster of two
// blocks of 128 keys per 256-key span.  grid (B * KV, spans · 2), the
// cluster along y: the spans that see the most query tiles first.
// ---------------------------------------------------------------------------
constexpr int kRows = 64;      // query rows per pair, keys per consumer
constexpr int kSpanW = 256;    // keys per dQ partial
constexpr int kStages = 2;     // Q/dO ring depth
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct K5W {
  static constexpr int NC = 2;                 // consumer warpgroups
  static constexpr int DQN = D / NC;           // dQ columns per consumer
  static constexpr int KEYS = kRows * NC;      // keys per block
  static constexpr int CLUSTER = kSpanW / KEYS;
  static constexpr int THREADS = 128 * (NC + 1);
  // setmaxnreg: the producer gives its registers to the consumers; the
  // block's 65536 registers (one block an SM) are shared out
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int NB = D / 64;            // 64-column boxes per row
  static constexpr int BOX = kRows * 128;      // one box of 64 rows
  static constexpr int TILE = NB * BOX;        // 64 rows of D
  static constexpr int DS = KEYS * 128;        // one dSᵀ tile (64 queries)
  // the dQ rows this block sums: CLUSTER slots (one per block, in rank
  // order) of 64 / CLUSTER rows of D f32, two buffers
  static constexpr int SROWS = kRows / CLUSTER;
  static constexpr int RX = kRows * D * 4;
  static constexpr int BARS = 1 + 2 * kStages + 4;
  // K and V; the ring of (Q, dO) tiles with the pair's lse and delta; two
  // dSᵀ tiles; two receive buffers; the barriers; 1024 bytes to align the
  // base
  static constexpr int BYTES = 2 * NC * TILE + kStages * 2 * TILE + 2 * DS +
                               2 * RX + kStages * 2 * kRows * 4 + 8 * BARS +
                               1024;
  static_assert(BYTES <= 232448, "shared memory: a block may take 227 KB");
  // two blocks a cluster (each sends the other half of its rows); the
  // rows it sends are staged in a dS tile
  static_assert(CLUSTER == 2 && SROWS * D * 4 <= DS, "cluster layout");
};

template <int D>
__global__ void __launch_bounds__(K5W<D>::THREADS, 1)
    k5_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ part, bf16* __restrict__ dk,
             bf16* __restrict__ dv, Dims s) {
  using L = K5W<D>;
  constexpr int NC = L::NC, C = L::CLUSTER, TILE = L::TILE;
  constexpr int CT = 128 * NC;  // consumer threads
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = sm90::align1024(smem_raw);  // [consumer][box][64][64]
  unsigned char* Vs = Ks + NC * TILE;
  unsigned char* Qs = Vs + NC * TILE;             // [stage][box][64][64]
  unsigned char* dOs = Qs + kStages * TILE;
  unsigned char* dSs = dOs + kStages * TILE;      // [2][KEYS][64] swizzled
  float* Rx = reinterpret_cast<float*>(dSs + 2 * L::DS);  // [2][C][SROWS][D]
  float* Ls = Rx + 2 * kRows * D;           // [stage][64]
  float* Ds = Ls + kStages * kRows;
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(Ds + kStages * kRows);
  uint64_t* full = full_kv + 1;        // [stage]: the pair's tiles and rows
  uint64_t* empty = full + kStages;    // [stage]: every consumer done
  uint64_t* rx_full = empty + kStages;  // [2]: every live block's rows in
  uint64_t* rx_free = rx_full + 2;      // [2]: every block read this
                                        // block's rows of that buffer

  const uint32_t rank = sm90::cluster_ctarank();
  const int b = blockIdx.x / s.KV, kvh = blockIdx.x % s.KV;
  const int span = blockIdx.y / C;
  const int s0 = span * kSpanW;              // the span's first key
  const int k0 = s0 + rank * L::KEYS;        // this block's first key
  const bool dead = k0 >= s.T;               // no key of the block is live
  // the cluster's pairs: from the query tile that holds key s0; this
  // block's first live pair: the query tile that holds key k0
  const int p_begin = s0 / kRows * s.rep, my_begin = k0 / kRows * s.rep;
  const int p_end = (s.T + kRows - 1) / kRows * s.rep;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;

  // the blocks of the cluster that hold a key at or before pair p's last
  // row (ranks 0 ..), and the bytes of the pair's dQ rows this block sums
  auto rx_blocks = [&](int p) {
    const int q_last = p / s.rep * kRows + kRows - 1;
    int live = 0;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      const int kr = s0 + r * L::KEYS;
      live += kr < s.T && kr <= q_last;
    }
    return live;
  };
  auto rx_bytes = [&](int p) {
    return static_cast<uint32_t>(rx_blocks(p) * L::SROWS * D * 4);
  };

  if (threadIdx.x == 0) {
    sm90::mbar_init(full_kv, 1);
    for (int i = 0; i < kStages; ++i) {
      sm90::mbar_init(full + i, 2);  // the TMA thread and the row warp
      sm90::mbar_init(empty + i, NC);
    }
    for (int i = 0; i < 2; ++i) {
      // this block's expect_tx, and every consumer thread once its rows
      // of its own tile are stored
      sm90::mbar_init(rx_full + i, 1 + 128 * NC);
      sm90::mbar_init(rx_free + i, C);  // one arrival from each block
    }
    sm90::mbar_fence_init();
  }
  sm90::cluster_sync();  // every block's barriers exist before any arrival

  if (wg == 0) {
    sm90::setmaxnreg_dec<L::PRODUCER_REGS>();
    if (tid == 0 && !dead) {
      sm90::mbar_arrive_expect_tx(full_kv, 2 * NC * TILE);
      for (int c = 0; c < NC; ++c)
        for (int nb = 0; nb < L::NB; ++nb) {
          const int at = c * TILE + nb * L::BOX, key = k0 + c * kRows;
          sm90::tma_load_4d(Ks + at, &tk, full_kv, nb * 64, kvh, key, b);
          sm90::tma_load_4d(Vs + at, &tv, full_kv, nb * 64, kvh, key, b);
        }
      int stage = 0, phase = 1;
      for (int p = my_begin; p < p_end; ++p) {
        const int qi = p / s.rep, h = kvh * s.rep + p % s.rep;
        sm90::mbar_wait(empty + stage, phase);
        sm90::mbar_arrive_expect_tx(full + stage, 2 * TILE);
        for (int nb = 0; nb < L::NB; ++nb) {
          const int at = stage * TILE + nb * L::BOX;
          sm90::tma_load_4d(Qs + at, &tq, full + stage, nb * 64, h,
                            qi * kRows, b);
          sm90::tma_load_4d(dOs + at, &tdo, full + stage, nb * 64, h,
                            qi * kRows, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (tid >> 5 == 1 && !dead) {
      // the pair's 64 lse and delta values, zeros past T, then one arrival
      const int lane = tid & 31;
      int stage = 0, phase = 1;
      for (int p = my_begin; p < p_end; ++p) {
        const int q0 = p / s.rep * kRows, h = kvh * s.rep + p % s.rep;
        const long long at = ((long long)b * s.H + h) * s.T;
        sm90::mbar_wait(empty + stage, phase);
        for (int i = lane; i < kRows; i += 32) {
          const bool ok = q0 + i < s.T;
          Ls[stage * kRows + i] = ok ? lse[at + q0 + i] : 0.f;
          Ds[stage * kRows + i] = ok ? delta[at + q0 + i] : 0.f;
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(full + stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<L::CONSUMER_REGS>();
    const int c = wg - 1, ct = threadIdx.x - 128;  // ct: 0 .. CT - 1
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int kc0 = k0 + c * kRows;        // this warpgroup's first key
    const int key0 = kc0 + warp * 16 + g;  // this thread's keys: +0, +8
    const unsigned char* ks = Ks + c * TILE;
    const unsigned char* vs = Vs + c * TILE;
    const float sl2 = s.scale * kLog2e;
    // the receive buffers and their barriers in every block of the cluster
    constexpr int SROWS = L::SROWS, F4 = SROWS * D / 4;
    uint32_t rx_at[C], full_at[C];
#pragma unroll
    for (int r = 0; r < C; ++r) {
      rx_at[r] = sm90::mapa(Rx, r);
      full_at[r] = sm90::mapa(rx_full, r);
    }
    // This block's rows of pair p's (step n's) cluster sum: once every
    // live block's rows are in (rx_full), the slots summed in rank (key)
    // order into the span's partial; then every block is told that its
    // slot of buffer n % 2 is free (rx_free).
    auto reduce = [&](int n, int p) {
      const int q0 = p / s.rep * kRows, h = kvh * s.rep + p % s.rep;
      const int k = n & 1, live_blocks = rx_blocks(p);
      sm90::mbar_wait(rx_full + k, (n >> 1) & 1);
      const float* rx = Rx + k * kRows * D;
#pragma unroll
      for (int u = 0; u < F4 / CT; ++u) {
        const int i = ct + u * CT;
        const int row = i / (D / 4), col = (i % (D / 4)) * 4;
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < C; ++r) {
          if (r < live_blocks) {  // the live blocks are ranks 0 ..
            const float4 x = *reinterpret_cast<const float4*>(
                rx + (r * SROWS + row) * D + col);
            sum.x += x.x;
            sum.y += x.y;
            sum.z += x.z;
            sum.w += x.w;
          }
        }
        const int grow = q0 + rank * SROWS + row;
        if (grow < s.T)
          *reinterpret_cast<float4*>(
              part + (part_row(span, kSpanW, b, grow, s) + h) * D + col) =
              sum;
      }
      sm90::named_barrier(2, CT);  // every consumer read its slots
      if (ct == 0) {
#pragma unroll
        for (int r = 0; r < C; ++r) sm90::mbar_arrive_remote(rx_free + k, r);
      }
    };
    float dka[D / 2], dva[D / 2], st[32], dpt[32], acc[L::DQN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    if (!dead) sm90::mbar_wait(full_kv, 0);

    int stage = 0, phase = 0, n = 0;
    for (int p = p_begin; p < p_end; ++p, ++n) {
      const int q0 = p / s.rep * kRows;
      // the block holds a key at or before the pair's last row (the ring
      // carries these pairs only)
      const bool live = !dead && p >= my_begin;
      unsigned char* dst = dSs + (n & 1) * L::DS;
      if (live) {
        // every block has summed pair n - 2: this block's copy out of dS
        // buffer n % 2 into the peer's slot is done, and the slot is free
        sm90::mbar_wait(rx_free + (n & 1), ((n >> 1) & 1) ^ 1);
        sm90::mbar_wait(full + stage, phase);
        uint32_t pf[4][4], sf[4][4];
        if (kc0 < s.T && kc0 <= q0 + kRows - 1) {
          const bool edge = q0 + kRows > s.T || kc0 + kRows > s.T ||
                            kc0 + kRows - 1 > q0;
          const unsigned char* qt = Qs + stage * TILE;
          const unsigned char* dot = dOs + stage * TILE;
          const float* lt = Ls + stage * kRows;
          const float* dt = Ds + stage * kRows;
          // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, one commit group
          sm90::wgmma_fence();
          sm90::ss_chain<D, 64>(st, ks, L::BOX, qt, L::BOX);
          sm90::ss_chain<D, 64>(dpt, vs, L::BOX, dot, L::BOX);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(st);
          sm90::fence_regs(dpt);
          if (edge) {  // query columns and keys past T, the causal mask
#pragma unroll
            for (int nn = 0; nn < 8; ++nn)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qi = q0 + nn * 8 + 2 * t + (e & 1);
                const int kj = key0 + (e >> 1) * 8;
                if (qi >= s.T || kj >= s.T || qi < kj)
                  st[4 * nn + e] = kNegInf;
              }
          }
#pragma unroll
          for (int nn = 0; nn < 8; ++nn) {
            const float2 lv =
                *reinterpret_cast<const float2*>(lt + nn * 8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = st[4 * nn + e];
              const float l2 = ((e & 1) ? lv.y : lv.x) * kLog2e;
              st[4 * nn + e] =
                  x <= kDead ? 0.f : sm90::exp2_approx(fmaf(x, sl2, -l2));
            }
          }
          sm90::s_to_a<8>(pf, st);  // Pᵀ in dO's type
#pragma unroll
          for (int nn = 0; nn < 8; ++nn) {
            const float2 dv2 =
                *reinterpret_cast<const float2*>(dt + nn * 8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              st[4 * nn + e] *= dpt[4 * nn + e] - ((e & 1) ? dv2.y : dv2.x);
          }
          sm90::s_to_a<8>(sf, st);  // dSᵀ in q's (and k's) type
          // dV += Pᵀ·dO and dK += dSᵀ·Q, dO and Q read MN-major
          sm90::fence_regs(dva);
          sm90::fence_regs(dka);
          sm90::wgmma_fence();
          sm90::rs_chain<D, 4>(dva, pf, dot, L::BOX);
          sm90::rs_chain<D, 4>(dka, sf, qt, L::BOX);
          sm90::wgmma_commit();
        } else {  // every key of this warpgroup after the pair's rows
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) sf[kk][i] = 0u;
        }
        // dSᵀ (keys as rows, queries as columns) for the dQ product
        sm90::store_a_sw128(dst, sf, c * kRows);
        sm90::fence_proxy_async();
        sm90::named_barrier(1, CT);  // every consumer's dSᵀ rows are in
        // dQ's columns c·DQN .. = dS · K over the block's keys
        constexpr int DQN = L::DQN;
        sm90::wgmma_fence();
        sm90::ss_chain_mn<L::KEYS / 16, DQN>(
            acc, dSs + (n & 1) * L::DS,
            Ks + (c * DQN / 64) * L::BOX + (c * DQN % 64) * 2, TILE);
        sm90::wgmma_commit();
        // the previous pair's sum while the products run: its rows had a
        // step to arrive
        if (n > 0) reduce(n - 1, p - 1);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        sm90::fence_regs(dva);
        sm90::fence_regs(dka);
        // the products that read the stage have completed
        if (tid == 0) sm90::mbar_arrive(empty + stage);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
        sm90::named_barrier(3, CT);  // every dQ chain has read dS buffer
      }
      if (n > 0 && !live) reduce(n - 1, p - 1);
      // this pair's dQ tile: block r sums rows r·SROWS .. of it.  This
      // block's own rows go to its slot of its own receive buffer n % 2
      // by plain stores; the peer's rows are staged in dS buffer n % 2
      // (free once the dQ chains have read it) and copied into this
      // block's slot of the peer's buffer by the bulk-copy engine, which
      // completes the bytes on the peer's rx_full[n % 2]
      const int k = n & 1;
      if (ct == 0)
        sm90::mbar_arrive_expect_tx(
            rx_full + k, rx_bytes(p) - (live ? SROWS * D * 4 : 0));
      if (live) {
        float* stg = reinterpret_cast<float*>(dSs + k * L::DS);
        const int row = warp * 16 + g;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rr = row + 8 * i;
          float* at = rr / SROWS == rank
                          ? Rx + (k * kRows + rank * SROWS + rr % SROWS) * D
                          : stg + (rr % SROWS) * D;
#pragma unroll
          for (int j = 0; j < L::DQN / 8; ++j)
            *reinterpret_cast<float2*>(at + c * L::DQN + 2 * t + 8 * j) =
                make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
        }
        sm90::fence_proxy_async();
        sm90::named_barrier(4, CT);  // the staged rows are in
        if (ct == 0) {
          const uint32_t peer = rank ^ 1;
          sm90::bulk_copy_cluster(
              rx_at[peer] + (k * kRows + rank * SROWS) * D * 4, stg,
              SROWS * D * 4, full_at[peer] + 8 * k);
        }
      }
      sm90::mbar_arrive(rx_full + k);  // this thread's own rows are in
    }
    if (n > 0) reduce(n - 1, p_end - 1);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + i * 8;
      if (key >= s.T) continue;
      const long long at = (((long long)b * s.T + key) * s.KV + kvh) * D;
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + nn * 8 + 2 * t) =
            __floats2bfloat162_rn(dka[4 * nn + 2 * i] * s.scale,
                                  dka[4 * nn + 2 * i + 1] * s.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + nn * 8 + 2 * t) =
            __floats2bfloat162_rn(dva[4 * nn + 2 * i],
                                  dva[4 * nn + 2 * i + 1]);
      }
    }
  }
  // no block leaves while a peer may still read its dQ tile or arrive on
  // its barriers
  sm90::cluster_sync();
}

// The keys per dQ partial of a (dtype, D): the wgmma kernel's span for
// bf16 at D 64 and 128, else one 64-key block.
int span_of(int dtype, int D) {
  return dtype == kBF16 && D >= 64 ? kSpanW : kBk;
}

// The four tensor maps of a k5_wgmma launch: q and dO as (D, H, T, B), k
// and v as (D, KV, T, B), all in boxes of (64, 1, 64, 1).
int k5_maps(CUtensorMap (&maps)[4], const void* q, const void* dout,
            const void* k, const void* v, const Dims& s, int D) {
  const uint64_t e = 2;  // bytes of a bf16
  const uint64_t qd[4] = {(uint64_t)D, (uint64_t)s.H, (uint64_t)s.T,
                          (uint64_t)s.B};
  const uint64_t qst[3] = {D * e, s.H * D * e, (uint64_t)s.T * s.H * D * e};
  const uint64_t kd[4] = {(uint64_t)D, (uint64_t)s.KV, (uint64_t)s.T,
                          (uint64_t)s.B};
  const uint64_t kst[3] = {D * e, s.KV * D * e,
                           (uint64_t)s.T * s.KV * D * e};
  const uint32_t box[4] = {64, 1, kRows, 1};
  int err = sm90::encode_bf16_4d(&maps[0], q, qd, qst, box);
  if (!err) err = sm90::encode_bf16_4d(&maps[1], dout, qd, qst, box);
  if (!err) err = sm90::encode_bf16_4d(&maps[2], k, kd, kst, box);
  if (!err) err = sm90::encode_bf16_4d(&maps[3], v, kd, kst, box);
  return err;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 float* part, void* dk, void* dv, const Dims& s,
                 cudaStream_t st) {
  using L = K5W<D>;
  const long long blocks =
      (long long)(s.T + kSpanW - 1) / kSpanW * L::CLUSTER;
  if (blocks > 65535) return cudaErrorInvalidValue;
  CUtensorMap maps[4];
  int err = k5_maps(maps, q, dout, k, v, s, D);
  if (!err) err = set_smem(k5_wgmma<D>, L::BYTES);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s.B * s.KV, static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = L::CLUSTER;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, k5_wgmma<D>, maps[0], maps[1], maps[2], maps[3], lse, delta,
      part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), s));
}

// ---------------------------------------------------------------------------
// The dQ sum: each row's live partials j = 0 .. row / span, in that order,
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
                       long long n4, int HD, int span, Dims s) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const long long e = i * 4;
  const long long rb = e / HD;  // b · T + row
  const int row = static_cast<int>(rb % s.T), b = static_cast<int>(rb / s.T);
  const int col = static_cast<int>(e % HD);
  const int live = row / span + 1;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < live; ++j) {
    const float4 x = *reinterpret_cast<const float4*>(
        part + part_row(j, span, b, row, s) * (HD / s.H) + col);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  store4(dq + e, make_float4(acc.x * s.scale, acc.y * s.scale,
                             acc.z * s.scale, acc.w * s.scale));
}

constexpr int kThreadsSum = 256;

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* part, void* dq,
           void* dk, void* dv, const Dims& s, int dtype, cudaStream_t st) {
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* pt = static_cast<float*>(part);
  const int span = span_of(dtype, D);
  const dim3 grid((s.T + kBk - 1) / kBk, s.B * s.KV);
  const long long n4 = (long long)s.B * s.T * s.H * D / 4;
  const unsigned sum_blocks =
      static_cast<unsigned>((n4 + kThreadsSum - 1) / kThreadsSum);
  int err = 0;
  if (dtype == kBF16 && D >= 64) {
    if constexpr (D >= 64)
      err = launch_wgmma<D>(q, k, v, dout, l, dl, pt, dk, dv, s, st);
  } else if (dtype == kBF16) {
    err = set_smem(k5_tc<D>, Smem<D>::BYTES);
    if (!err)
      k5_tc<D><<<grid, kThreads, Smem<D>::BYTES, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), l,
          dl, pt, static_cast<bf16*>(dk), static_cast<bf16*>(dv), s);
  } else {
    k5_fma<D><<<grid, kThreadsFma, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), l, dl,
        pt, static_cast<float*>(dk), static_cast<float*>(dv), s);
  }
  if (err) return err;
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (dtype == kBF16)
    k5_sum<bf16><<<sum_blocks, kThreadsSum, 0, st>>>(
        pt, static_cast<bf16*>(dq), n4, s.H * D, span, s);
  else
    k5_sum<float><<<sum_blocks, kThreadsSum, 0, st>>>(
        pt, static_cast<float*>(dq), n4, s.H * D, span, s);
  return 0;
}

}  // namespace

extern "C" int bf_splash_key_tile(int dtype, int D) {
  return span_of(dtype, D);
}

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
