// The single-tile check of K1's wgmma layouts, for the cuda tests only
// (tests/test_torch_cuda_kernels.py::test_k1_tile_forms_on_card builds and
// loads it; chip_smoke.py and the port's wrapper never do).  It includes
// conv1x1_backward.cu, so it runs the kernel's own 2-D tensor maps
// (k1_maps over sm90::encode_bf16_2d) and product issues (slice_kk,
// slice_mn) on one tile, against torch.matmul.  cuda_build.py hashes the
// included source with this one.
//
//   int bf_conv1x1_tile_check(x, dy, w, dx_f, dw_f, dx_g, dw_g, stream)

#include "conv1x1_backward.cu"

namespace {

// x [128, 128], dy [128, 256], w [128, 256] bf16; two warpgroups, c = 0, 1.
//   k1_fused's forms on its 64-row tile (ci 64, co 256):
//     dx_f [64, 64]   = dy[:64] · w[:64]ᵀ     (consumer 0: K-major, four
//                                              64-row boxes of co)
//     dw_f [64, 256]  = x[:64, :64]ᵀ · dy[:64] (consumer 1: MN-major, two
//                                              n128 halves)
//   k1_gemm's forms on one 64-deep slice:
//     dx_g [128, 128] = dy[:, :64] · w[:, :64]ᵀ  (B a box of 128 rows)
//     dw_g [128, 128] = x[:64]ᵀ · dy[:64, :128]  (B two boxes of 64 rows)
constexpr int kCheckBytes = kFusedX + kFusedDy + kFusedW + 4 * kGemmA + 8 +
                            1024;

__global__ void __launch_bounds__(256)
    k1_tile_check(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tdy,
                  const __grid_constant__ CUtensorMap tw64,
                  const __grid_constant__ CUtensorMap tw128, float* dx_f,
                  float* dw_f, float* dx_g, float* dw_g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Xs = sm90::align1024(smem_raw);  // x[:64, :64]
  unsigned char* Ys = Xs + kFusedX;               // dy[:64], 4 boxes
  unsigned char* Ws = Ys + kFusedDy;              // w[:64], 4 boxes
  unsigned char* Ag = Ws + kFusedW;               // dy[:, :64], 2 boxes
  unsigned char* Bg = Ag + kGemmA;                // w[:, :64], 128 rows
  unsigned char* Xg = Bg + kGemmB;                // x[:64], 2 ci boxes
  unsigned char* Yg = Xg + kGemmA;                // dy[:64, :128], 2 boxes
  uint64_t* bar = reinterpret_cast<uint64_t*>(Yg + kGemmB);
  const int c = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(bar, kFusedX + kFusedDy + kFusedW +
                                         kGemmA + kGemmB + kGemmA + kGemmB);
    sm90::tma_load_2d(Xs, &tx, bar, 0, 0);
    for (int h = 0; h < 2; ++h) {
      sm90::tma_load_2d(Ag + h * kBox, &tdy, bar, 0, 64 * h);
      sm90::tma_load_2d(Xg + h * kBox, &tx, bar, 64 * h, 0);
      sm90::tma_load_2d(Yg + h * kBox, &tdy, bar, 64 * h, 0);
    }
    for (int cb = 0; cb < 4; ++cb) {
      sm90::tma_load_2d(Ys + cb * kFusedDyBox, &tdy, bar, 64 * cb, 0);
      sm90::tma_load_2d(Ws + cb * kBox, &tw64, bar, 64 * cb, 0);
    }
    sm90::tma_load_2d(Bg, &tw128, bar, 0, 0);
  }
  sm90::mbar_wait(bar, 0);
  float g[64];
  if (c == 0) {
    float dxa[32];
    sm90::wgmma_fence();
#pragma unroll
    for (int cb = 0; cb < 4; ++cb)
      slice_kk<64>(dxa, Ys + cb * kFusedDyBox, Ws + cb * kBox, cb == 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dxa);
    store_f32<64>(dxa, dx_f, 64, 0, 64, 0, 64);
  } else {
    float dw0[64], dw1[64];
    sm90::wgmma_fence();
    slice_mn<4>(dw0, Xs, kBox, Ys, kFusedDyBox, 64, 0, true);
    slice_mn<4>(dw1, Xs, kBox, Ys + 2 * kFusedDyBox, kFusedDyBox, 64, 0,
                true);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dw0);
    sm90::fence_regs(dw1);
    store_f32<128>(dw0, dw_f, 256, 0, 64, 0, 256);
    store_f32<128>(dw1, dw_f, 256, 0, 64, 128, 256);
  }
  sm90::wgmma_fence();
  slice_kk<128>(g, Ag + c * kBox, Bg, true);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(g);
  store_f32<128>(g, dx_g, 128, 64 * c, 128, 0, 128);
  sm90::wgmma_fence();
  slice_mn<4>(g, Xg + c * kBox, kBox, Yg, kBox, 64, 0, true);
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(g);
  store_f32<128>(g, dw_g, 128, 64 * c, 128, 0, 128);
}

}  // namespace

extern "C" int bf_conv1x1_tile_check(const void* x, const void* dy,
                                     const void* w, void* dx_f, void* dw_f,
                                     void* dx_g, void* dw_g, void* stream) {
  CUtensorMap tx, tdy, tw64, tw128;
  int err = k1_maps(&tx, &tdy, &tw64, x, dy, w, 128, 128, 256, 64, 64, 64);
  if (!err)
    err = k1_maps(nullptr, nullptr, &tw128, x, dy, w, 128, 128, 256, 0, 0,
                  128);
  if (!err)
    err = static_cast<int>(cudaFuncSetAttribute(
        k1_tile_check, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kCheckBytes));
  if (err) return err;
  k1_tile_check<<<1, 256, kCheckBytes, static_cast<cudaStream_t>(stream)>>>(
      tx, tdy, tw64, tw128, static_cast<float*>(dx_f),
      static_cast<float*>(dw_f), static_cast<float*>(dx_g),
      static_cast<float*>(dw_g));
  return static_cast<int>(cudaGetLastError());
}
