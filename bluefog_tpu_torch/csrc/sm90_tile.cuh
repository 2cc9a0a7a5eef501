// Hopper (sm_90a) building blocks of the redesigned kernels: the flash
// forward (K2) and backward (K3a, K3b) of flash_attention.cu, the fused
// splash backward (K5, splash_backward.cu) and the 1x1-conv backward (K1,
// conv1x1_backward.cu): mbarriers, TMA tile loads from 2-D and 4-D
// CUtensorMaps, wgmma shared-memory descriptors for the 128-byte swizzle,
// the asynchronous warpgroup products (wgmma.mma_async m64nNk16, bf16 in,
// f32 accumulators, A from shared memory or from registers, either operand
// MN-major through the transpose bits) with their fence, commit and wait,
// the product chains the kernels share, setmaxnreg, named barriers,
// thread-block clusters (remote mbarrier arrivals, bulk copies into a
// peer's shared memory), and the host side: tensor maps encoded through the
// driver entry point (no -lcuda: the libraries link against cudart only).
//
// Layouts, as the cuda tests of tests/test_torch_cuda_kernels.py check
// them on the card against torch.matmul (test_sm90_tile_*):
//
// * A TMA box of R rows x 64 bf16 (128 bytes) under CU_TENSOR_MAP_
//   SWIZZLE_128B lands as R rows of 128 bytes, each 16-byte chunk c of
//   row r stored at chunk c ^ (r % 8); a box starts on a 1024-byte
//   boundary.  A row of D = 128 is two such boxes, one after the other.
// * K-major operand (Q and K: the reduction axis D contiguous): the
//   descriptor's stride byte offset (SBO) is 1024 (8 rows of 128 bytes),
//   its leading byte offset is unused; the k-th 16-column step of a box
//   starts 32·k bytes in, the next box at its own base.
// * MN-major operand (V as the B of P·V: the output axis D contiguous,
//   the reduction axis keys by rows; the transpose bit): SBO 1024 between
//   groups of 8 keys, LBO the byte distance between the two 64-column
//   boxes of D = 128; the k-th step of 16 keys starts 2048·k bytes in.
//   The backward reads K (dS·K), dO (Pᵀ·dO) and Q (dSᵀ·Q) so, from the
//   same tiles it reads K-major for its scores: a tile of 64 rows has its
//   boxes 8192 bytes apart, one of 128 rows 16384.
// * Accumulator of m64nN: thread t of the warpgroup (warp w = t / 32,
//   lane = 4g + q) holds d[4j + e] at row 16w + g + 8(e / 2), column
//   8j + 2q + e % 2, for j < N / 8: the mma.sync m16n8 fragment, once per
//   8 columns.  The register A operand of m64n?k16 is the mma.sync
//   m16n8k16 A fragment of the warp's 16 rows, so an S accumulator
//   becomes P's A operand by packing pairs, with no shuffle (s_to_a).
// * MN-major A (K5's dS, K1's xᵀ): a tile of 128-byte rows along the
//   reduction axis, 64 values of M a row, read with the transpose bit,
//   SBO 1024; the k-th step of 16 rows starts 2048·k bytes in.  A thread
//   that writes such a tile itself swizzles as TMA does (sw128).
//
// cuda_build.py hashes this header with every source.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only; no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Arrives and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// TMA: a 4-D tile (coordinates innermost first) into shared memory,
// completing `bytes` of the barrier's transaction count; out-of-bounds
// elements arrive as zeros and count as bytes too.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The same from a 2-D map (coordinates innermost first).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// ---------------------------------------------------------------------------
// Ordering between the proxies, named barriers, thread-block clusters
// ---------------------------------------------------------------------------
// Makes this thread's generic stores to shared memory visible to the
// async proxy (a wgmma that reads a tile the threads wrote).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// bar.sync on hardware barrier `id` (1..15; 0 is __syncthreads) for
// `threads` threads (a multiple of 32).
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The whole cluster: every thread of every block arrives and waits.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The shared::cluster address of the same offset in block `rank`'s
// shared memory.
__device__ __forceinline__ uint32_t mapa(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}
// One arrival on the barrier at `bar`'s offset in block `rank` (release at
// CTA scope: enough to order this thread's completed reads of its own
// shared memory before the writes that the arrival lets in).
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   uint32_t rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                   mapa(bar, rank))
               : "memory");
}
// `bytes` (a multiple of 16) of this block's shared memory at `src` into
// a block's shared memory at `dst` (a shared::cluster address) by the
// bulk-copy engine, completing the bytes on the barrier at `bar` (a
// shared::cluster address in the destination block).
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst,
                                                  const void* src,
                                                  uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
// Shared-memory matrix descriptor of a 128-byte-swizzled tile at `p`
// (1024-byte aligned at the start of its box): start address, leading and
// stride byte offsets (16-byte units), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// The descriptor moved on by `bytes` (a multiple of 16) of start address.
__device__ __forceinline__ uint64_t desc_add(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// d[64 x N] (+)= A[64 x 16] · B[16 x N], both operands in shared memory,
// K-major by default; TA = 1 (TB = 1) reads A (B) MN-major through the
// transpose bit.  scale_d = 0 overwrites d.
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// The same with d overwritten (scale-d 0): d is written and not read, so
// its old values need not stay live until the product (the backward
// recomputes its score tiles every step).
template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n128_set(float (&d)[64], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
}

template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n64_set(float (&d)[32], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
}

template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 x N] (+)= A[64 x 16] · B[16 x N], A in registers (the warp's
// m16n8k16 A fragment), B in shared memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// S accumulator [64 x 8NT] (f32) rounded to bf16 as NT / 2 register A
// operands of 16 columns each (round to nearest even, as torch's cast).
template <int NT>
__device__ __forceinline__ void s_to_a(uint32_t (&a)[NT / 2][4],
                                       const float (&s)[4 * NT]) {
#pragma unroll
  for (int k = 0; k < NT / 2; ++k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a0: (row g, cols 2q..) of block 2k, a1: (row g + 8) of block 2k,
      // a2, a3: the same of block 2k + 1
      const int j = 2 * k + (i >> 1), e = 2 * (i & 1);
      __nv_bfloat162 v = __floats2bfloat162_rn(s[4 * j + e], s[4 * j + e + 1]);
      a[k][i] = *reinterpret_cast<uint32_t*>(&v);
    }
  }
}

// ---------------------------------------------------------------------------
// Product chains and small helpers of the kernels built on these parts
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Issues acc[64 x N] = A[64 x D] · B[N x D]ᵀ (no fence, no commit): A and B
// K-major in 128B-swizzled boxes of 64 columns, abox and bbox bytes from
// one box to the next (SBO 1024 bytes = 8 rows; the k-th 16-column step
// starts 32·k bytes into its box).  N is 64 or 128.  The first step
// overwrites acc, so the previous tile's values are dead before it.
template <int D, int N>
__device__ __forceinline__ void ss_chain(float (&acc)[N / 2], const void* a,
                                         int abox, const void* b, int bbox) {
  const uint64_t da = sm90::desc_sw128(a, 16, 1024);
  const uint64_t db = sm90::desc_sw128(b, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t ka = sm90::desc_add(da, (kk / 4) * abox + (kk % 4) * 32);
    const uint64_t kb = sm90::desc_add(db, (kk / 4) * bbox + (kk % 4) * 32);
    if constexpr (N == 128) {
      if (kk == 0)
        sm90::wgmma_ss_n128_set(acc, ka, kb);
      else
        sm90::wgmma_ss_n128(acc, ka, kb, 1);
    } else {
      if (kk == 0)
        sm90::wgmma_ss_n64_set(acc, ka, kb);
      else
        sm90::wgmma_ss_n64(acc, ka, kb, 1);
    }
  }
}

// Issues acc[64 x D] += A[64 x 16·KS] · B[16·KS x D] (no fence, no
// commit): A as KS register operands (s_to_a), B MN-major (the transpose
// bit) from a tile of rows whose 64-column boxes lie bbox bytes apart (LBO;
// SBO 1024 bytes = 8 rows); the k-th step of 16 rows starts 2048·k bytes
// in.
template <int D, int KS>
__device__ __forceinline__ void rs_chain(float (&acc)[D / 2],
                                         const uint32_t (&a)[KS][4],
                                         const void* b, int bbox) {
  const uint64_t db = sm90::desc_sw128(b, bbox, 1024);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    if constexpr (D == 128)
      sm90::wgmma_rs_n128(acc, a[kk], sm90::desc_add(db, kk * 2048), 1);
    else
      sm90::wgmma_rs_n64(acc, a[kk], sm90::desc_add(db, kk * 2048), 1);
  }
}

// Byte offset of (row r, bf16 column c < 64) in a 128-byte-swizzled tile
// of 128-byte rows (16-byte chunk c / 8 of row r lands at (c / 8) ^ (r % 8)),
// for threads that write such a tile themselves.
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// Stores a 64-column tile's bf16 register A operands (s_to_a<8> of an
// m64n64 accumulator: the warpgroup's 64 rows) at rows row0 .. row0 + 63
// of a 128-byte-swizzled tile, as a TMA box of those rows would hold them:
// a[k][i] is (row g + 8·(i % 2), columns 16k + 8·(i / 2) + 2q, + 1) of the
// warp's 16 rows.  Each warp's stores of one (k, i) cover 8 rows x 16
// bytes, one chunk a row, in 8 distinct chunk columns: no bank conflict.
__device__ __forceinline__ void store_a_sw128(unsigned char* tile,
                                              const uint32_t (&a)[4][4],
                                              int row0) {
  const int t = threadIdx.x % 128, g = (t % 32) / 4, q = t % 4;
  const int r = row0 + (t / 32) * 16 + g;
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint32_t*>(
          tile + sw128(r + (i & 1) * 8, k * 16 + (i >> 1) * 8 + 2 * q)) =
          a[k][i];
}

// Issues acc[64 x 64] = A[64 x 16·KS] · B[16·KS x 64] (no fence, no
// commit), both operands MN-major (the transpose bits), each a tile of
// 128-byte rows along the reduction axis (SBO 1024 bytes = 8 rows, the
// k-th step of 16 rows 2048·k bytes in): A's rows follow one another; B's
// come in groups of 64 rows, `bgroup` bytes apart.  K5's dQ = dS·K reads dS
// so from the dSᵀ tile the threads wrote (keys as rows) and K from its
// resident tiles.  The first step overwrites acc.
template <int KS, int N = 64>
__device__ __forceinline__ void ss_chain_mn(float (&acc)[N / 2],
                                            const void* a,
                                            const unsigned char* b,
                                            int bgroup) {
  const uint64_t da = desc_sw128(a, 8192, 1024);
  const uint64_t db = desc_sw128(b, 8192, 1024);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t ka = desc_add(da, kk * 2048);
    const uint64_t kb = desc_add(db, (kk / 4) * bgroup + (kk % 4) * 2048);
    if constexpr (N == 64) {
      if (kk == 0)
        wgmma_ss_n64_set<1, 1>(acc, ka, kb);
      else
        wgmma_ss_n64<1, 1>(acc, ka, kb, 1);
    } else {
      wgmma_ss_n32<1, 1>(acc, ka, kb, kk > 0);
    }
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, looked
// up once per process.  0 or a CUDA error code.
inline int encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// A 4-D bf16 tensor map, 128-byte swizzle, zeros out of bounds: dims and
// box innermost first, strides in bytes of dims 1..3 (multiples of 16).
// Pure host work (no device call), about a microsecond.
inline int encode_bf16_4d(CUtensorMap* map, const void* base,
                          const uint64_t (&dims)[4],
                          const uint64_t (&strides)[3],
                          const uint32_t (&box)[4]) {
  EncodeTiled fn;
  const int err = encoder(&fn);
  if (err) return err;
  if (reinterpret_cast<uintptr_t>(base) % 16) return cudaErrorInvalidValue;
  cuuint64_t d[4], st[3];
  cuuint32_t b[4], one[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
  }
  for (int i = 0; i < 3; ++i) {
    if (strides[i] % 16) return cudaErrorInvalidValue;
    st[i] = strides[i];
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), d, st, b, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 2-D bf16 tensor map over a row-major [rows, cols] matrix (cols
// contiguous, a row `row_bytes` apart, a multiple of 16), boxes of
// box_cols x box_rows, 128-byte swizzle, zeros out of bounds.
inline int encode_bf16_2d(CUtensorMap* map, const void* base, uint64_t cols,
                          uint64_t rows, uint64_t row_bytes,
                          uint32_t box_cols, uint32_t box_rows) {
  EncodeTiled fn;
  const int err = encoder(&fn);
  if (err) return err;
  if (reinterpret_cast<uintptr_t>(base) % 16 || row_bytes % 16)
    return cudaErrorInvalidValue;
  cuuint64_t d[2] = {cols, rows}, st[1] = {row_bytes};
  cuuint32_t b[2] = {box_cols, box_rows}, one[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), d, st, b, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sm90
