// A-SL dual-conductance crossbar VMM.
//
// Replaces: src/repro/kernels/crossbar_vmm/kernel.py, crossbar_vmm_kernel
//   (pallas_call at :53; body _xbar_kernel at :29).
//
// Computes, for x (M, K) f32, four A-SL conductance cells (K, N) f32 (read
// noise, when any, already drawn into them by the wrapper) and the host
// scalars inv = 1 / g_ratio and res_scale = 1 / res_gain:
//   y = x @ (((G+ - G-) + (G+res - G-res) * res_scale) * inv)
// with float32 accumulation.
//
// What bounds it on an H100: at decode (M = 8) bytes — 4*K*N*4 bytes of
// cells (360 MB at K=2048, N=11008) for 2*M*K*N FLOPs; at prefill
// (M = 512) f32 operations.  The design is kernel B's (dual_compute.cu)
// without its ACAM epilogue: the shared main loop of xbar_tiles.cuh with
// the W_eff loader (W_eff formed once per K step in shared memory, each
// operation rounded on its own), the accumulator stored with the ragged
// edge masked.  The TPU wrapper pads the cells with g_min (weight 0); here
// nothing is padded.  inv comes by value, as the reference's static float.

#include "xbar_tiles.cuh"

namespace {

using namespace xbar;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
crossbar_vmm_kernel(const float* __restrict__ x,
                    const float* __restrict__ gp,
                    const float* __restrict__ gn,
                    const float* __restrict__ rp,
                    const float* __restrict__ rn, float* __restrict__ out,
                    int M, int N, int K, float res_scale, float inv) {
  __shared__ float x_s[BK * BM];
  __shared__ float w_s[BK * BN];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[TM][TN];
  gemm_tile(RowMajorA{x, M, K},
            CellsB{gp, gn, rp, rn, res_scale, inv, K, N}, x_s, w_s, K, m0,
            n0, acc);
  store_tile(acc, out, M, N, m0, n0);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch.
int crossbar_vmm_launch(const float* x, const float* gp, const float* gn,
                        const float* rp, const float* rn, float* out, int M,
                        int N, int K, float res_scale, float inv,
                        void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  crossbar_vmm_kernel<<<grid, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, gp, gn, rp, rn, out, M, N, K, res_scale, inv);
  return (int)cudaGetLastError();
}

}  // extern "C"
