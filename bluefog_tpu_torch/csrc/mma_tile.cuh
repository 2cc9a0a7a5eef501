// Warp-level tensor-core and copy helpers shared by the attention kernels
// (flash_attention.cu: K2, K3a, K3b; splash_backward.cu: K5).
//
// mma.sync m16n8k16 (bf16 in, f32 accumulators), ldmatrix reads of
// padded shared-memory tiles, cp.async copies, and the masking constants
// of the TPU kernels (-1e30 for a masked score, p = 0 at or below -5e29).
//
// Accumulator fragment of a 16 x 8 tile, lane = 4 g + t: c[0], c[1] at
// (row g, cols 2t, 2t + 1), c[2], c[3] at (row g + 8, same cols).
//
// cuda_build.py hashes this header with every source, so an edit here
// rebuilds both libraries.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kDead = -5e29f;  // kNegInf / 2: scores at or below are p = 0

constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
// 4-byte asynchronous copy (lse and delta rows); zeros when !valid.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment (16 x 16, row-major) at rows 0..15, cols 0..15 of a.
__device__ __forceinline__ void load_a(uint32_t (&af)[4], const bf16* a,
                                       int ld, int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldsm_x4(af, a + ((mi & 1) * 8 + r) * ld + (mi >> 1) * 8);
}

// acc[16 x 8NT] += A[16 x KD] · B[8NT x KD]ᵀ, A and B row-major in shared
// memory with the KD axis contiguous (S = Q·Kᵀ and its relatives).
template <int NT, int KD>
__device__ __forceinline__ void warp_abt(float (&acc)[NT][4], const bf16* a,
                                         const bf16* b, int ld, int lane) {
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kc = 0; kc < KD / 16; ++kc) {
    uint32_t af[4];
    load_a(af, a + kc * 16, ld, lane);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bq[4];
      ldsm_x4(bq, b + ((j + (mi >> 1)) * 8 + r) * ld + kc * 16 + (mi & 1) * 8);
      mma16816(acc[j], af, bq[0], bq[1]);
      mma16816(acc[j + 1], af, bq[2], bq[3]);
    }
  }
}

// Same with A held in registers as KD/16 A fragments.
template <int NT, int KD>
__device__ __forceinline__ void warp_abt_reg(float (&acc)[NT][4],
                                             const uint32_t (&af)[KD / 16][4],
                                             const bf16* b, int ld, int lane) {
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kc = 0; kc < KD / 16; ++kc) {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bq[4];
      ldsm_x4(bq, b + ((j + (mi >> 1)) * 8 + r) * ld + kc * 16 + (mi & 1) * 8);
      mma16816(acc[j], af[kc], bq[0], bq[1]);
      mma16816(acc[j + 1], af[kc], bq[2], bq[3]);
    }
  }
}

// acc[16 x 8NT] += A[16 x 16KC] · B[16KC x 8NT]; A in registers, B
// row-major in shared memory with the N axis contiguous (P·V, dS·K, ...),
// read transposed by ldmatrix.
template <int NT, int KC>
__device__ __forceinline__ void warp_ab(float (&acc)[NT][4],
                                        const uint32_t (&af)[KC][4],
                                        const bf16* b, int ld, int lane) {
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bq[4];
      ldsm_x4_t(bq, b + (kc * 16 + (mi & 1) * 8 + r) * ld + (j + (mi >> 1)) * 8);
      mma16816(acc[j], af[kc], bq[0], bq[1]);
      mma16816(acc[j + 1], af[kc], bq[2], bq[3]);
    }
  }
}

// Accumulator fragments of a [16 x 8NT] tile, rounded to bf16, as the
// A fragments of a [16 x 8NT] operand (NT / 2 chunks of 16 columns).
template <int NT>
__device__ __forceinline__ void c_to_a(uint32_t (&af)[NT / 2][4],
                                       const float (&c)[NT][4]) {
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    af[kc][0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
    af[kc][1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
    af[kc][2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
    af[kc][3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ROWS rows of D bf16 from g (row stride gs elements) starting at row0
// into s (row stride D + 8), zero-filling rows at or past n.
template <int ROWS, int D, int THREADS>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g,
                                          long long gs, int row0, int n,
                                          int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int c = tid; c < ROWS * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8;
    const bool ok = row0 + r < n;
    cp_async16(s + r * (D + 8) + col, ok ? g + (row0 + r) * gs + col : g, ok);
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  // above 48 KB only after this attribute; it is per device, so it is set
  // on every launch (a host-side call of a few microseconds)
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// The four head dims every attention kernel is compiled for.
#define BF_DISPATCH_D(D, CALL)            \
  switch (D) {                            \
    case 16: { constexpr int kD = 16; err = CALL; break; }   \
    case 32: { constexpr int kD = 32; err = CALL; break; }   \
    case 64: { constexpr int kD = 64; err = CALL; break; }   \
    case 128: { constexpr int kD = 128; err = CALL; break; } \
    default: err = cudaErrorInvalidValue;                    \
  }
