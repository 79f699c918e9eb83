// Fused crossbar -> ACAM pass: the ADC-free dual-compute dataflow.
//
// Replaces: src/repro/kernels/dual_compute/kernel.py,
//   fused_crossbar_acam_kernel (pallas_call at :96; body _fused_kernel at
//   :52), including the ACAM decode of acam_decode_tile
//   (src/repro/kernels/acam_activation/kernel.py:29) as its epilogue.
//
// Computes, for x (M, K) f32, four A-SL conductance cells (K, N) f32, the
// device scalar inv = w_max / (g_max - g_min) and an ACAM table lo/hi
// (bits, rows) f32:
//   W_eff = ((G+ - G-) + (G+res - G-res) * (1/res_gain)) * inv
//   y     = x @ W_eff                               (f32 accumulator)
//   out   = dequant(gray_decode(OR_r [lo[i,r] <= y <= hi[i,r]]))
// The pre-activation y never goes to device memory: the interval match
// and the Gray decode run on the accumulator registers.
//
// What bounds it on an H100: at decode (M = 8) bytes — the four cell
// matrices are 4*K*N*4 bytes (360 MB per MLP gate at K=2048, N=11008) for
// 2*M*K*N FLOPs; at chunk prefill (M = 512) f32 operations.  The design
// is the shared tile code of xbar_tiles.cuh:
//   * the GEMM main loop (64x64 tile, 4x4 outputs per thread, K in steps
//     of 16) with W_eff formed in shared memory from the four cells as the
//     reference kernel forms it (kernel.py:62), with __fsub_rn/__fmul_rn/
//     __fadd_rn so the compiler cannot contract it into FMAs — the f32
//     rounding of the conductance differences decides ACAM codes at
//     interval edges; kernel E (crossbar_vmm.cu) is the same loop;
//   * the ACAM epilogue on the accumulator (kernel D, acam_activation.cu,
//     is the same function on values read from memory), its table in
//     shared memory;
//   * ragged M/N/K edges are masked (zero operands, no stores), not padded;
//   * inv is read from device memory, so w_max never round-trips the host.

#include "xbar_tiles.cuh"

namespace {

using namespace xbar;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_crossbar_acam_kernel(const float* __restrict__ x,
                           const float* __restrict__ gp,
                           const float* __restrict__ gn,
                           const float* __restrict__ rp,
                           const float* __restrict__ rn,
                           const float* __restrict__ inv_ptr,
                           const float* __restrict__ lo,
                           const float* __restrict__ hi,
                           float* __restrict__ out, int M, int N, int K,
                           float res_scale, int bits, int rows, float out_lo,
                           float out_step) {
  extern __shared__ float smem[];
  float* x_s = smem;                  // BK x BM (k-major)
  float* w_s = x_s + BK * BM;         // BK x BN
  float* lo_s = w_s + BK * BN;        // bits x rows
  float* hi_s = lo_s + bits * rows;   // bits x rows
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  load_table(lo, hi, lo_s, hi_s, bits * rows);
  float acc[TM][TN];
  gemm_tile(RowMajorA{x, M, K},
            CellsB{gp, gn, rp, rn, res_scale, *inv_ptr, K, N}, x_s, w_s, K,
            m0, n0, acc);

  // epilogue: the bit-line current drives the ACAM directly
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + tile_row() + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = n0 + tile_col() + j;
      if (gm >= M || gc >= N) continue;
      out[(size_t)gm * N + gc] = acam_value(acc[i][j], lo_s, hi_s, bits,
                                            rows, out_lo, out_step);
    }
  }
}

size_t smem_bytes(int bits, int rows) {
  return sizeof(float) * ((size_t)TILE_FLOATS + 2 * (size_t)bits * rows);
}

}  // namespace

extern "C" {

size_t fused_crossbar_acam_smem_bytes(int bits, int rows) {
  return smem_bytes(bits, rows);
}

// Returns the cudaError_t of the launch.
int fused_crossbar_acam_launch(const float* x, const float* gp,
                               const float* gn, const float* rp,
                               const float* rn, const float* inv,
                               const float* lo, const float* hi, float* out,
                               int M, int N, int K, float res_scale, int bits,
                               int rows, float out_lo, float out_step,
                               void* stream) {
  const size_t smem = smem_bytes(bits, rows);
  cudaError_t err = cudaFuncSetAttribute(
      fused_crossbar_acam_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  fused_crossbar_acam_kernel<<<grid, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      x, gp, gn, rp, rn, inv, lo, hi, out, M, N, K, res_scale, bits, rows,
      out_lo, out_step);
  return (int)cudaGetLastError();
}

}  // extern "C"
