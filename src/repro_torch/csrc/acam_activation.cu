// 8-bit ACAM activation: interval match -> Gray decode -> dequantize.
//
// Replaces: src/repro/kernels/acam_activation/kernel.py,
//   acam_activation_kernel (pallas_call at :65; tile fn acam_decode_tile
//   at :29).
//
// Computes, for n float32 values x and an ACAM table lo/hi (bits, rows):
//   bit i = OR_r (lo[i,r] <= x <= hi[i,r]),  b_i = XOR(g_{n-1}, ..., g_i),
//   out   = code * out_step + out_lo                (code = sum b_i 2^i).
//
// What bounds it on an H100: the walk over the table (up to bits*rows
// compares per element) more than the 8 bytes per element it moves (a
// 3.35 TB/s bound of 13.5 us at 512 x 11008).  The design: the table sits
// in shared memory, loaded once per block; a grid-stride loop gives each
// thread several elements, with a few blocks per SM so the table load is
// paid once per block, not once per element; each bit's rows are walked
// until the first match (the bit is an OR), where the reference builds a
// (bm, bn, bits, rows) compare tensor.  The per-element function is
// xbar::acam_value, the epilogue of kernel B (dual_compute.cu), so D on
// y equals B's output on an accumulator holding y, bit for bit.  The
// ragged tail is masked by the loop bound; nothing is padded.

#include "xbar_tiles.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__global__ void __launch_bounds__(THREADS)
acam_activation_kernel(const float* __restrict__ x,
                       const float* __restrict__ lo,
                       const float* __restrict__ hi, float* __restrict__ out,
                       long long n, int bits, int rows, float out_lo,
                       float out_step) {
  extern __shared__ float smem[];
  float* lo_s = smem;                 // bits x rows
  float* hi_s = lo_s + bits * rows;   // bits x rows
  xbar::load_table(lo, hi, lo_s, hi_s, bits * rows);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = xbar::acam_value(__ldg(x + i), lo_s, hi_s, bits, rows, out_lo,
                              out_step);
  }
}

size_t smem_bytes(int bits, int rows) {
  return sizeof(float) * 2 * (size_t)bits * rows;
}

}  // namespace

extern "C" {

size_t acam_activation_smem_bytes(int bits, int rows) {
  return smem_bytes(bits, rows);
}

// Returns the cudaError_t of the launch.
int acam_activation_launch(const float* x, const float* lo, const float* hi,
                           float* out, long long n, int bits, int rows,
                           float out_lo, float out_step, void* stream) {
  const size_t smem = smem_bytes(bits, rows);
  cudaError_t err = cudaFuncSetAttribute(
      acam_activation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long need = (n + THREADS - 1) / THREADS;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  const int blocks = (int)(need < cap ? need : cap);
  acam_activation_kernel<<<blocks, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      x, lo, hi, out, n, bits, rows, out_lo, out_step);
  return (int)cudaGetLastError();
}

}  // extern "C"
