// Fused crossbar -> ACAM pass: the ADC-free dual-compute dataflow.
//
// Replaces: src/repro/kernels/dual_compute/kernel.py,
//   fused_crossbar_acam_kernel (pallas_call at :96; body _fused_kernel at
//   :52), including the ACAM decode of acam_decode_tile
//   (src/repro/kernels/acam_activation/kernel.py:29) as its epilogue.
//
// Computes, for x (M, K) f32, four A-SL conductance cells (K, N) f32, the
// device scalar inv = w_max / (g_max - g_min) and an ACAM table compiled
// to n breakpoints and 2n + 1 codes (core/acam.py, compile_thresholds):
//   W_eff = ((G+ - G-) + (G+res - G-res) * (1/res_gain)) * inv
//   y     = x @ W_eff                               (f32 accumulator)
//   out   = dequant(code of y)   == the row walk OR_r [lo <= y <= hi],
//                                   Gray-decoded, bit for bit
// The pre-activation y never goes to device memory.
//
// What bounds it on an H100: at decode (M = 8) bytes — the four cell
// matrices are 4*K*N*4 bytes (360 MB per MLP gate at K=2048, N=11008) for
// 2*M*K*N FLOPs; at chunk prefill (M = 512) f32 operations.  The design
// is the shared tile code of xbar_tiles.cuh:
//   * the pipelined main loop: the x tile and the four cell tiles of the
//     next steps stream in through cp.async while the block computes, and
//     W_eff is formed once per block per K step from the staged cells as
//     the reference kernel forms it (kernel.py:62), with __fsub_rn/
//     __fmul_rn/__fadd_rn so the compiler cannot contract it into FMAs —
//     the f32 rounding of the conductance differences decides ACAM codes
//     at interval edges; kernel E (crossbar_vmm.cu) is the same loop;
//   * the tile sized to M (xbar::choose): 16 x 32 at decode, so the 344
//     blocks of N = 11008 keep the cells streaming; 128 x 128 at prefill;
//   * the ACAM epilogue spread over all threads of the block: a binary
//     search of the compiled map in shared memory (about 9 steps for a
//     noise-free 8-bit table) in place of a walk over up to 8 x 66 rows;
//     kernel D (acam_activation.cu) is the same function;
//   * inv is read from device memory, so w_max never round-trips the host.

#include "xbar_tiles.cuh"

namespace {

using namespace xbar;

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
fused_crossbar_acam_kernel(const float* __restrict__ x,
                           const float* __restrict__ gp,
                           const float* __restrict__ gn,
                           const float* __restrict__ rp,
                           const float* __restrict__ rn,
                           const float* __restrict__ inv_ptr,
                           const float* __restrict__ bp,
                           const int* __restrict__ code,
                           float* __restrict__ out, int M, int N, int K,
                           float res_scale, int n_bp, float out_lo,
                           float out_step, bool x_vec, bool cells_vec) {
  using Op = CrossbarOp<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* comp =
      reinterpret_cast<float*>(smem + ring_bytes<T>(Op::STAGE_BYTES));
  float* bp_s = comp + 2 * T::COMPUTE_FLOATS;
  int* code_s = reinterpret_cast<int*>(bp_s + n_bp);
  int m0, n0;
  tile_origin<T>(M, m0, n0);

  load_map(bp, code, bp_s, code_s, n_bp);
  const Op op{x, {gp, gn, rp, rn}, res_scale, *inv_ptr, M, N, K, x_vec,
              cells_vec};
  float acc[T::TM][T::TN];
  gemm_tile<T>(op, smem, comp, K, m0, n0, acc);
  // the bit-line current drives the ACAM directly
  store_tile<T>(acc, reinterpret_cast<float*>(smem), out, M, N, m0, n0,
                Acam{bp_s, code_s, n_bp, out_lo, out_step});
}

template <class T>
size_t smem_for(int n_bp) {
  return smem_bytes<T>(CrossbarOp<T>::STAGE_BYTES, map_bytes(n_bp));
}

template <class T>
int launch(const float* x, const float* gp, const float* gn, const float* rp,
           const float* rn, const float* inv, const float* bp,
           const int* code, float* out, int M, int N, int K, float res_scale,
           int n_bp, float out_lo, float out_step, cudaStream_t stream) {
  const size_t smem = smem_for<T>(n_bp);
  cudaError_t err = cudaFuncSetAttribute(
      fused_crossbar_acam_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_crossbar_acam_kernel<T><<<grid_blocks<T>(M, N), T::THREADS, smem,
                                  stream>>>(
      x, gp, gn, rp, rn, inv, bp, code, out, M, N, K, res_scale, n_bp,
      out_lo, out_step, rows_aligned16(x, 4LL * K),
      cells_aligned16(gp, gn, rp, rn, N));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile variant (xbar::Variant) a launch at (M, N) takes.
int fused_crossbar_acam_variant(int M, int N) {
  return (int)choose(M, N, sm_count());
}

// Shared-memory bytes of the launch at (M, N) with an n_bp-point map.
size_t fused_crossbar_acam_smem_bytes(int M, int N, int n_bp) {
  return with_tile(M, N, [&](auto tile) {
    return smem_for<decltype(tile)>(n_bp);
  });
}

// Returns the cudaError_t of the launch.
int fused_crossbar_acam_launch(const float* x, const float* gp,
                               const float* gn, const float* rp,
                               const float* rn, const float* inv,
                               const float* bp, const int* code, float* out,
                               int M, int N, int K, float res_scale, int n_bp,
                               float out_lo, float out_step, void* stream) {
  return with_tile(M, N, [&](auto tile) {
    return launch<decltype(tile)>(x, gp, gn, rp, rn, inv, bp, code, out, M,
                                  N, K, res_scale, n_bp, out_lo, out_step,
                                  static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
