// Log-domain DMMul over 8-bit ACAM codes (paper Eq 3), the fused mode.
//
// Replaces: src/repro/kernels/nldpe_qmatmul/kernel.py, nldpe_qmatmul_kernel
//   (pallas_call at :61; body _qmm_kernel at :30).
//
// Computes, for A (M, K) and B (K, N) in the analog engine's wire format —
// centered int8 codes (code - 128) and int8 signs in {-1, 0, +1} — and the
// log grid's step and floor log_lo:
//   A^ = sign * exp((code + 128) * step + log_lo), B^ likewise,
//   C  = A^ @ B^                                   (f32 accumulation).
// The multiply-add before exp is one fused rounding (__fmaf_rn), as XLA
// contracts the reference kernel's `code * step + log_lo` under jit; exp is
// the accurate expf (no fast math).
//
// What bounds it on an H100: f32 operations at the shapes that matter
// (2*M*K*N; 34.4 GFLOP at 4096 x 2048 x 2048, 0.513 ms at 67 TFLOP/s); the
// int8 operands are 2 bytes per element.  The design is the shared main
// loop of xbar_tiles.cuh with two dequantizing loaders: each K step
// dequantizes its A and B tiles once into shared memory (one expf per
// staged element), and the 4x4 register tiles accumulate with IEEE fmaf.
// Ragged M/N/K edges are masked, where the TPU wrapper pads with sign 0.

#include "xbar_tiles.cuh"

namespace {

using namespace xbar;

__device__ __forceinline__ float dequant(int8_t code, int8_t sign,
                                         float step, float log_lo) {
  const float c = (float)((int)code + 128);
  return (float)sign * expf(__fmaf_rn(c, step, log_lo));
}

struct CodesA {                          // A (M, K)
  const int8_t* code;
  const int8_t* sign;
  int M, K;
  float step, log_lo;
  __device__ __forceinline__ float operator()(int gm, int gk) const {
    if (gm >= M || gk >= K) return 0.0f;
    const size_t o = (size_t)gm * K + gk;
    return dequant(code[o], sign[o], step, log_lo);
  }
};

struct CodesB {                          // B (K, N)
  const int8_t* code;
  const int8_t* sign;
  int K, N;
  float step, log_lo;
  __device__ __forceinline__ float operator()(int gk, int gc) const {
    if (gk >= K || gc >= N) return 0.0f;
    const size_t o = (size_t)gk * N + gc;
    return dequant(code[o], sign[o], step, log_lo);
  }
};

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
nldpe_qmatmul_kernel(const int8_t* __restrict__ a_code,
                     const int8_t* __restrict__ a_sign,
                     const int8_t* __restrict__ b_code,
                     const int8_t* __restrict__ b_sign,
                     float* __restrict__ out, int M, int N, int K,
                     float step, float log_lo) {
  __shared__ float a_s[BK * BM];
  __shared__ float b_s[BK * BN];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[TM][TN];
  gemm_tile(CodesA{a_code, a_sign, M, K, step, log_lo},
            CodesB{b_code, b_sign, K, N, step, log_lo}, a_s, b_s, K, m0, n0,
            acc);
  store_tile(acc, out, M, N, m0, n0);
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch.
int nldpe_qmatmul_launch(const int8_t* a_code, const int8_t* a_sign,
                         const int8_t* b_code, const int8_t* b_sign,
                         float* out, int M, int N, int K, float step,
                         float log_lo, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  nldpe_qmatmul_kernel<<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      a_code, a_sign, b_code, b_sign, out, M, N, K, step, log_lo);
  return (int)cudaGetLastError();
}

}  // extern "C"
