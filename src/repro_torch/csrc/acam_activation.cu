// 8-bit ACAM activation: interval match -> Gray decode -> dequantize.
//
// Replaces: src/repro/kernels/acam_activation/kernel.py,
//   acam_activation_kernel (pallas_call at :65; tile fn acam_decode_tile
//   at :29).
//
// Computes, for n float32 values x and an ACAM table lo/hi (bits, rows):
//   bit i = OR_r (lo[i,r] <= x <= hi[i,r]),  b_i = XOR(g_{n-1}, ..., g_i),
//   out   = code * out_step + out_lo                (code = sum b_i 2^i),
// from the table compiled to its sorted breakpoints and the code at and
// between each (core/acam.py, compile_thresholds): bit for bit the row
// walk.
//
// What bounds it on an H100: bytes, 8 per element (a 3.35 TB/s bound of
// 13.5 us at 512 x 11008).  The design: the compiled map sits in shared
// memory, loaded once per block; a grid-stride loop gives each thread
// several elements, with a few blocks per SM so the map load is paid once
// per block, not once per element; each element is a binary search over
// the breakpoints (about 9 steps for a noise-free 8-bit table), where the
// reference builds a (bm, bn, bits, rows) compare tensor.  The per-element
// function is xbar::acam_value, the epilogue of kernel B
// (dual_compute.cu), so D on y equals B's output on an accumulator
// holding y, bit for bit.  The ragged tail is masked by the loop bound;
// nothing is padded.

#include "xbar_tiles.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__global__ void __launch_bounds__(THREADS)
acam_activation_kernel(const float* __restrict__ x,
                       const float* __restrict__ bp,
                       const int* __restrict__ code, float* __restrict__ out,
                       long long n, int n_bp, float out_lo, float out_step) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* bp_s = reinterpret_cast<float*>(smem);
  int* code_s = reinterpret_cast<int*>(bp_s + n_bp);
  xbar::load_map(bp, code, bp_s, code_s, n_bp);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = xbar::acam_value(__ldg(x + i), bp_s, code_s, n_bp, out_lo,
                              out_step);
  }
}

}  // namespace

extern "C" {

size_t acam_activation_smem_bytes(int n_bp) { return xbar::map_bytes(n_bp); }

// Returns the cudaError_t of the launch.
int acam_activation_launch(const float* x, const float* bp, const int* code,
                           float* out, long long n, int n_bp, float out_lo,
                           float out_step, void* stream) {
  const size_t smem = xbar::map_bytes(n_bp);
  cudaError_t err = cudaFuncSetAttribute(
      acam_activation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long need = (n + THREADS - 1) / THREADS;
  const long long cap = (long long)xbar::sm_count() * BLOCKS_PER_SM;
  const int blocks = (int)(need < cap ? need : cap);
  acam_activation_kernel<<<blocks, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      x, bp, code, out, n, n_bp, out_lo, out_step);
  return (int)cudaGetLastError();
}

}  // extern "C"
