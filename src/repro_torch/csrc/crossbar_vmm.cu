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
// without its ACAM epilogue: the pipelined main loop of xbar_tiles.cuh
// with the crossbar operands (the cells streamed through cp.async, W_eff
// formed once per block per K step, each operation rounded on its own),
// the tile chosen from M, and the accumulator tile stored through shared
// memory with coalesced, masked stores.  The TPU wrapper pads the cells
// with g_min (weight 0); here nothing is padded.  inv comes by value, as
// the reference's static float.

#include "xbar_tiles.cuh"

namespace {

using namespace xbar;

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
crossbar_vmm_kernel(const float* __restrict__ x,
                    const float* __restrict__ gp,
                    const float* __restrict__ gn,
                    const float* __restrict__ rp,
                    const float* __restrict__ rn, float* __restrict__ out,
                    int M, int N, int K, float res_scale, float inv,
                    bool x_vec, bool cells_vec) {
  using Op = CrossbarOp<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* comp =
      reinterpret_cast<float*>(smem + ring_bytes<T>(Op::STAGE_BYTES));
  int m0, n0;
  tile_origin<T>(M, m0, n0);
  const Op op{x, {gp, gn, rp, rn}, res_scale, inv, M, N, K, x_vec,
              cells_vec};
  float acc[T::TM][T::TN];
  gemm_tile<T>(op, smem, comp, K, m0, n0, acc);
  store_tile<T>(acc, reinterpret_cast<float*>(smem), out, M, N, m0, n0,
                Identity{});
}

template <class T>
int launch(const float* x, const float* gp, const float* gn, const float* rp,
           const float* rn, float* out, int M, int N, int K, float res_scale,
           float inv, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(CrossbarOp<T>::STAGE_BYTES, 0);
  cudaError_t err = cudaFuncSetAttribute(
      crossbar_vmm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  crossbar_vmm_kernel<T><<<grid_blocks<T>(M, N), T::THREADS, smem, stream>>>(
      x, gp, gn, rp, rn, out, M, N, K, res_scale, inv,
      rows_aligned16(x, 4LL * K), cells_aligned16(gp, gn, rp, rn, N));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile variant (xbar::Variant) a launch at (M, N) takes.
int crossbar_vmm_variant(int M, int N) {
  return (int)choose(M, N, sm_count());
}

// Returns the cudaError_t of the launch.
int crossbar_vmm_launch(const float* x, const float* gp, const float* gn,
                        const float* rp, const float* rn, float* out, int M,
                        int N, int K, float res_scale, float inv,
                        void* stream) {
  return with_tile(M, N, [&](auto tile) {
    return launch<decltype(tile)>(x, gp, gn, rp, rn, out, M, N, K, res_scale,
                                  inv, static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
