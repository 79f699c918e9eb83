// Causal GQA flash attention: online softmax over streamed K/V tiles.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_kernel (pallas_call at :87; body _flash_kernel at :30);
//   in serving, the lax twin repro/nn/attention.py blockwise_attention,
//   which the OFF whole-prompt prefill runs.
//
// Computes, for q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D), all f32, G = Hq/Hkv:
//   out[b, h*G+g, i] = softmax_j(q_i . k_j * scale) @ v over the keys
//   j <= i + Lk - Lq (causal; queries sit at the end of the KV axis) or
//   all keys (not causal), K/V read at head h.  A row with no visible key
//   gives 0.  `scale` is 1/sqrt(D) as the caller rounds it; q is scaled
//   before the dot products, as the reference scales it.
//
// What bounds it on an H100: operations.  Each (row, key) pair costs
// 4*D FLOPs against 16*D bytes of K/V that serve a whole row tile, so at
// the serve path's shapes the f32 FLOPs (67 TFLOP/s outside the tensor
// cores) set the floor.  The tiling (attn_tiles.cuh, shared with kernel
// C): one block per (sequence, KV head, tile of 64 rows), K/V tiles of 32
// keys in shared memory serving the whole GQA group, causal tiles past
// the row tile's last position never loaded (they would add exactly
// nothing to the online softmax).  This file adds the online softmax, four
// threads per row with shuffle reductions, in f32 with expf (no fast
// math).  No tensor cores and no cp.async/TMA pipelining yet.

#include "attn_tiles.cuh"

namespace {

using namespace attn_tiles;

template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       float* __restrict__ out, int Hq, int Hkv, int Lq,
                       int Lk, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  const Smem<D> s(smem);
  float* m_s = s.stat[0];                   // running max
  float* l_s = s.stat[1];                   // running sum
  float* c_s = s.stat[2];                   // correction factor
  const Tile t(Hq, Hkv, Lq, Lk, causal);
  const int tid = threadIdx.x;

  load_q<D>(q, s, t, scale);
  for (int r = tid; r < ROWS; r += THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
  }
  float acc[PV<D>::RPT];
#pragma unroll
  for (int u = 0; u < PV<D>::RPT; ++u) acc[u] = 0.0f;
  __syncthreads();

  for (int j0 = 0; j0 < t.n_keys; j0 += BK) {
    load_kv<D>(k, v, s, t, j0, true);
    __syncthreads();
    score_tile<D>(s, t, j0);
    __syncthreads();

    {  // online softmax: four threads per row
      const int r = tid >> 2;
      const int sub = tid & 3;
      float* row = s.p_s + r * BK;
      float mx = -INFINITY;
      for (int jj = sub; jj < BK; jj += 4) mx = fmaxf(mx, row[jj]);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      float sum = 0.0f;
      for (int jj = sub; jj < BK; jj += 4) {
        const float p = expf(row[jj] - m_safe);   // -inf -> 0
        row[jj] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      if (sub == 0) {
        const float corr = isfinite(m_old) ? expf(m_old - m_safe) : 0.0f;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int u = 0; u < PV<D>::RPT; ++u) acc[u] *= c_s[PV<D>::row() + u];
    pv_accumulate<D>(s, acc);
    __syncthreads();                        // k_s/v_s/p_s reused next tile
  }

#pragma unroll
  for (int u = 0; u < PV<D>::RPT; ++u) {
    const float l = l_s[PV<D>::row() + u];
    acc[u] = acc[u] / (l == 0.0f ? 1.0f : l);
  }
  store_rows<D>(out, t, acc);
}

}  // namespace

extern "C" {

// q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D), out (B, Hq, Lq, D): contiguous
// f32; D in {16, 32, 64, 128}.  Returns the cudaError_t of the launch.
int flash_attention_launch(const float* q, const float* k, const float* v,
                           float* out, int B, int Hq, int Hkv, int Lq, int Lk,
                           int D, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_head_dim(D, [&](auto dim) {
    constexpr int kD = decltype(dim)::value;
    return launch<kD>(flash_attention_kernel<kD>, B, Hq, Hkv, Lq, st, q, k,
                      v, out, Hq, Hkv, Lq, Lk, causal, scale);
  });
}

}  // extern "C"
