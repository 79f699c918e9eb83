// NL-DPE log-domain flash attention (paper Fig 6c, exp-bypass), streamed.
//
// Replaces: src/repro/kernels/dual_compute/kernel.py,
//   logdomain_flash_kernel (pallas_call at :192; body _ld_flash_kernel at
//   :121, quantizer _quant_apply at :114).
//
// Computes, for log-quantized q_l (B, Hq, Lq, D) and k_l/v_l (B, Hkv, Lk, D),
// all f32 (the wrapper scales q by 1/sqrt(D) and log-quantizes q, k, v),
// G = Hq/Hkv, s_ij = q_l[i] . k_l[j] over the keys j <= i + Lk - Lq (causal,
// queries at the end of the KV axis) or all keys, K/V at head h:
//   pass 0:  m_i = max_j s_ij                          (ACAM winner-take-all)
//   pass 1:  t_i = sum_j q8(exp(y_ij)),  y_ij = q8(s_ij - m_i) on [-r, 0],
//            the exp ACAM's output on the [0, 1] grid
//   pass 2:  out_i = sum_j exp(q8(y_ij - q8(log t_i))) v_l[j], log t on
//            [-r, log(Lk + 1)], the log-softmax on [-2r, 0]
// with q8 an 8-bit uniform quantize-dequantize.  A row whose max is not
// finite (no visible key) takes m = 0 and gets weight 0 everywhere.
//
// Every grid crossing is rounded as the port's QuantSpec rounds it: code =
// rint((x - lo) * (1/step)) clamped to [0, 255], value = code * step + lo,
// with __fsub_rn/__fmul_rn/__fadd_rn so nvcc cannot contract the steps into
// FMAs, and expf/logf (no fast math): a score that lands on a rounding
// boundary moves a code, so the kernel must round where the plain version
// rounds.  The grids' (lo, step, 1/step) come from the wrapper, computed as
// core/quantization.QuantSpec computes them.  What can still differ from
// the plain version: the dot products' and the row sums' order.
//
// What bounds it on an H100: operations, as for flash attention (kernel F),
// but the design streams the scores three times (the TPU kernel's three
// passes), so it does about 4x the QK^T work of one pass; the bound counts
// the function's work once.  The tiling is kernel F's (attn_tiles.cuh):
// one block per (sequence, KV head, tile of 64 rows), K/V tiles in shared
// memory serving the GQA group, causal tiles past the row tile's last
// position never loaded.  This file adds the three grid-quantized passes,
// four threads per softmax row.  No tensor cores, no cp.async/TMA (later
// work).

#include "attn_tiles.cuh"

namespace {

using namespace attn_tiles;

struct Grid {         // an 8-bit uniform grid: lo, step, float32(1 / step)
  float lo, step, inv_step;
};

struct Grids {
  Grid score;         // [-r, 0]
  Grid expo;          // [0, 1]
  Grid logsum;        // [-r, log(Lk + 1)]
  Grid logp;          // [-2r, 0]
};

__device__ __forceinline__ float q8(float x, const Grid& g) {
  float c = rintf(__fmul_rn(__fsub_rn(x, g.lo), g.inv_step));
  c = fminf(fmaxf(c, 0.0f), 255.0f);
  return __fadd_rn(__fmul_rn(c, g.step), g.lo);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
logdomain_flash_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       float* __restrict__ out, int Hq, int Hkv, int Lq,
                       int Lk, int causal, Grids gr) {
  extern __shared__ __align__(16) float smem[];
  const Smem<D> s(smem);
  float* m_s = s.stat[0];                   // row max
  float* t_s = s.stat[1];                   // sum of quantized exps
  float* lt_s = s.stat[2];                  // quantized log t
  const Tile t(Hq, Hkv, Lq, Lk, causal);
  const int tid = threadIdx.x;
  const int sm_row = tid >> 2;              // softmax: four threads per row
  const int sub = tid & 3;

  load_q<D>(q, s, t, 1.0f);                 // q arrives scaled, quantized
  for (int r = tid; r < ROWS; r += THREADS) {
    m_s[r] = -INFINITY;
    t_s[r] = 0.0f;
  }
  float acc[PV<D>::RPT];
#pragma unroll
  for (int u = 0; u < PV<D>::RPT; ++u) acc[u] = 0.0f;
  __syncthreads();

  for (int phase = 0; phase < 3; ++phase) {
    if (phase == 2 && sub == 0)
      lt_s[sm_row] = q8(logf(fmaxf(t_s[sm_row], 1e-9f)), gr.logsum);
    for (int j0 = 0; j0 < t.n_keys; j0 += BK) {
      load_kv<D>(k, v, s, t, j0, phase == 2);
      __syncthreads();
      score_tile<D>(s, t, j0);              // DMMul_1 over log-quantized q, k
      __syncthreads();

      float* row = s.p_s + sm_row * BK;
      if (phase == 0) {                     // step 0: row max
        float mx = -INFINITY;
        for (int jj = sub; jj < BK; jj += 4) mx = fmaxf(mx, row[jj]);
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        if (sub == 0) m_s[sm_row] = fmaxf(m_s[sm_row], mx);
      } else {
        const float m = m_s[sm_row];
        const float m_safe = isfinite(m) ? m : 0.0f;
        if (phase == 1) {                   // steps 1-2: exp ACAM + adders
          float sum = 0.0f;
          for (int jj = sub; jj < BK; jj += 4) {
            const float x = row[jj];
            if (x != -INFINITY)
              sum += q8(expf(q8(__fsub_rn(x, m_safe), gr.score)), gr.expo);
          }
          sum += __shfl_xor_sync(FULL, sum, 1);
          sum += __shfl_xor_sync(FULL, sum, 2);
          if (sub == 0) t_s[sm_row] += sum;
        } else {                            // steps 3-4: log-softmax weights
          const float lt = lt_s[sm_row];
          for (int jj = sub; jj < BK; jj += 4) {
            const float x = row[jj];
            float a = 0.0f;
            if (x != -INFINITY) {
              const float yq = q8(__fsub_rn(x, m_safe), gr.score);
              a = expf(q8(__fsub_rn(yq, lt), gr.logp));
            }
            row[jj] = a;
          }
        }
      }
      __syncthreads();

      if (phase == 2) {                     // DMMul_2: weights @ V
        pv_accumulate<D>(s, acc);
        __syncthreads();
      }
    }
    __syncthreads();                        // m_s / t_s complete
  }
  store_rows<D>(out, t, acc);
}

}  // namespace

extern "C" {

// q_l (B, Hq, Lq, D), k_l/v_l (B, Hkv, Lk, D), out (B, Hq, Lq, D):
// contiguous f32; D in {16, 32, 64, 128}.  grids: 12 floats, (lo, step,
// 1/step) of the score, exp, log-sum and log-softmax grids in that order.
// Returns the cudaError_t of the launch.
int logdomain_flash_launch(const float* q, const float* k, const float* v,
                           float* out, int B, int Hq, int Hkv, int Lq, int Lk,
                           int D, int causal, const float* grids,
                           void* stream) {
  Grids gr;
  gr.score = {grids[0], grids[1], grids[2]};
  gr.expo = {grids[3], grids[4], grids[5]};
  gr.logsum = {grids[6], grids[7], grids[8]};
  gr.logp = {grids[9], grids[10], grids[11]};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_head_dim(D, [&](auto dim) {
    constexpr int kD = decltype(dim)::value;
    return launch<kD>(logdomain_flash_kernel<kD>, B, Hq, Hkv, Lq, st, q, k,
                      v, out, Hq, Hkv, Lq, Lk, causal, gr);
  });
}

}  // extern "C"
