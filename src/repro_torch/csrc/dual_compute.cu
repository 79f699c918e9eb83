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
// 2*M*K*N FLOPs; at chunk prefill (M = 512) f32 operations.  The design:
//   * a 64x64 output tile per block, 4x4 outputs per thread, K in steps
//     of 16 through shared memory; W_eff is formed in shared memory from
//     the four cells as the reference kernel forms it (kernel.py:62), with
//     __fsub_rn/__fmul_rn/__fadd_rn so the compiler cannot contract it
//     into FMAs — the f32 rounding of the conductance differences decides
//     ACAM codes at interval edges;
//   * the product accumulates with IEEE fmaf in k order (no TF32, no
//     tensor cores in this first version);
//   * the ACAM table lives in shared memory; each output walks the rows of
//     each bit and stops at the first match (the bit is an OR), instead of
//     the reference's (strip, bn, bits, rows) compare tensor;
//   * ragged M/N/K edges are masked (zero operands, no stores), not padded.
//   * inv is read from device memory, so w_max never round-trips the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
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

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const float inv = *inv_ptr;

  for (int idx = tid; idx < bits * rows; idx += THREADS) {
    lo_s[idx] = lo[idx];
    hi_s[idx] = hi[idx];
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int mm = idx / BK;
      const int kk = idx % BK;
      const int gm = m0 + mm;
      const int gk = k0 + kk;
      x_s[kk * BM + mm] =
          (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.0f;
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int kk = idx / BN;
      const int nn = idx % BN;
      const int gk = k0 + kk;
      const int gnn = n0 + nn;
      float w = 0.0f;
      if (gk < K && gnn < N) {
        const size_t o = (size_t)gk * N + gnn;
        const float main = __fsub_rn(gp[o], gn[o]);
        const float res = __fmul_rn(__fsub_rn(rp[o], rn[o]), res_scale);
        w = __fmul_rn(__fadd_rn(main, res), inv);
      }
      w_s[kk * BN + nn] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = x_s[kk * BM + ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = w_s[kk * BN + tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: the bit-line current drives the ACAM directly
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gnn = n0 + tx * TN + j;
      if (gm >= M || gnn >= N) continue;
      const float y = acc[i][j];
      int b = 0;
      int code = 0;
      for (int bit = bits - 1; bit >= 0; --bit) {
        int g = 0;
        for (int r = 0; r < rows; ++r) {
          if (lo_s[bit * rows + r] <= y && y <= hi_s[bit * rows + r]) {
            g = 1;
            break;
          }
        }
        b ^= g;                        // b_i = XOR(g_{n-1}, ..., g_i)
        code += b << bit;
      }
      out[(size_t)gm * N + gnn] =
          __fadd_rn(__fmul_rn((float)code, out_step), out_lo);
    }
  }
}

size_t smem_bytes(int bits, int rows) {
  return sizeof(float) * ((size_t)BK * BM + (size_t)BK * BN +
                          2 * (size_t)bits * rows);
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
