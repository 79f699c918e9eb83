// Shared tile code of the crossbar kernels: the SIMT f32 GEMM main loop of
// B (dual_compute.cu), E (crossbar_vmm.cu) and G (nldpe_qmatmul.cu), and
// the ACAM interval-match epilogue of B and D (acam_activation.cu).
//
// Main loop: a 64x64 output tile per block of 256 threads, 4x4 outputs per
// thread, K in steps of 16 through shared memory.  Each K step, the block
// stages a BM x BK slice of A and a BK x BN slice of B through two loader
// functors — `a(gm, gk)` and `b(gk, gn)`, each returning 0 outside the
// matrix — and every thread accumulates its 4x4 outputs with IEEE fmaf in
// k order (no TF32, no tensor cores).  The kernels differ only in their
// loaders: a row-major f32 A; W_eff formed from four A-SL conductance
// cells (B, E); dequantized int8 log-grid codes (G).  One main loop means
// D∘E equals B bit for bit, and a redesign of the tiling is made once.
//
// Epilogue: each output walks the rows of each ACAM bit in shared memory
// and stops at the first match (the bit is an OR), decodes the Gray bits
// with an XOR chain and dequantizes with separate float32 roundings
// (__fmul_rn, __fadd_rn), as the port's plain eval_table does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace xbar {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
// Six blocks per SM (at most 40 registers a thread): at 48 registers only
// five fit, and M = 512's 1376 blocks of a 2048 x 11008 product take three
// waves of 660 on 132 SMs instead of two of 792.
constexpr int MIN_BLOCKS = 6;
constexpr int TILE_FLOATS = BK * BM + BK * BN;  // shared floats of the loop

// A operand: x (M, K) float32, row-major.
struct RowMajorA {
  const float* x;
  int M, K;
  __device__ __forceinline__ float operator()(int gm, int gk) const {
    return (gm < M && gk < K) ? __ldg(x + (size_t)gm * K + gk) : 0.0f;
  }
};

// B operand: the A-SL effective weight of four (K, N) conductance cells,
//   W_eff = ((G+ - G-) + (G+res - G-res) * res_scale) * inv,
// each operation rounded on its own so no FMA contraction moves a value.
struct CellsB {
  const float* gp;
  const float* gn;
  const float* rp;
  const float* rn;
  float res_scale, inv;
  int K, N;
  __device__ __forceinline__ float operator()(int gk, int gc) const {
    if (gk >= K || gc >= N) return 0.0f;
    const size_t o = (size_t)gk * N + gc;
    const float main = __fsub_rn(__ldg(gp + o), __ldg(gn + o));
    const float res = __fmul_rn(__fsub_rn(__ldg(rp + o), __ldg(rn + o)),
                                res_scale);
    return __fmul_rn(__fadd_rn(main, res), inv);
  }
};

// The block's 64x64 tile of A @ B, accumulated into `acc`.  `a_s` and
// `b_s` are BK*BM and BK*BN floats of shared memory.
template <class LoadA, class LoadB>
__device__ __forceinline__ void gemm_tile(const LoadA& load_a,
                                          const LoadB& load_b, float* a_s,
                                          float* b_s, int K, int m0, int n0,
                                          float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int mm = idx / BK;
      const int kk = idx % BK;
      a_s[kk * BM + mm] = load_a(m0 + mm, k0 + kk);
    }
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int kk = idx / BN;
      const int nn = idx % BN;
      b_s[kk * BN + nn] = load_b(k0 + kk, n0 + nn);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = a_s[kk * BM + ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b_s[kk * BN + tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Row and column of the thread's first output in the block's tile.
__device__ __forceinline__ int tile_row() {
  return (threadIdx.x / (BN / TN)) * TM;
}
__device__ __forceinline__ int tile_col() {
  return (threadIdx.x % (BN / TN)) * TN;
}

// Store the accumulator tile, masking the ragged edge.
__device__ __forceinline__ void store_tile(const float (&acc)[TM][TN],
                                           float* out, int M, int N, int m0,
                                           int n0) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + tile_row() + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = n0 + tile_col() + j;
      if (gm < M && gc < N) out[(size_t)gm * N + gc] = acc[i][j];
    }
  }
}

// Copy an ACAM table (bits x rows lo and hi) into shared memory; the
// caller synchronizes before the first use.
__device__ __forceinline__ void load_table(const float* lo, const float* hi,
                                           float* lo_s, float* hi_s,
                                           int n) {
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    lo_s[idx] = lo[idx];
    hi_s[idx] = hi[idx];
  }
}

// One ACAM unit on one value: bit i = OR_r (lo[i,r] <= y <= hi[i,r]),
// Gray bits XOR-decoded from the MSB down, then code * out_step + out_lo.
__device__ __forceinline__ float acam_value(float y, const float* lo_s,
                                            const float* hi_s, int bits,
                                            int rows, float out_lo,
                                            float out_step) {
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
  return __fadd_rn(__fmul_rn((float)code, out_step), out_lo);
}

}  // namespace xbar
