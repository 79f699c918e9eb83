// Tile code shared by the causal GQA attention kernels: flash attention
// (flash_attention.cu, kernel F) and log-domain flash attention
// (logdomain_flash.cu, kernel C).  Each kernel keeps only its own softmax;
// the loads, the masked score tile, P @ V, the output store, the shared
// memory layout and the launch live here.
//
// Layout: one block per (sequence, KV head, tile of ROWS rows), rows
// ordered r = i*G + g, so one K/V tile in shared memory serves every query
// head of the GQA group at ROWS/G consecutive positions — K/V are read at
// head h and never repeated.  Row tiles with the most keys are scheduled
// first, and a causal tile's keys stop at its last position.  Scores are a
// register micro-tile (4 rows x 2 keys per thread) from float4
// shared-memory loads over rows padded by four floats, so a quarter-warp's
// loads hit distinct banks; D is a template parameter.  P @ V runs one
// thread per head-dim column with ROWS*D/THREADS rows in registers,
// probabilities read four at a time.  Ragged lengths are masked, so no
// length has to be a multiple of a tile.  IEEE f32 throughout (FMA dot
// products; no TF32, no fast math), no tensor cores, no cp.async/TMA.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace attn_tiles {

constexpr int ROWS = 64;      // query rows (positions x group heads) per block
constexpr int BK = 32;        // keys per K/V tile
constexpr int THREADS = 256;  // 16 x 16 score threads; 4 per softmax row
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory, in floats: q_s ROWS*(D+4) | k_s BK*(D+4) |
// v_s BK*D | p_s ROWS*BK | three per-row statistics of ROWS each.
template <int D>
struct Smem {
  static constexpr int DP = D + 4;          // padded, 16-byte aligned rows
  float* q_s;
  float* k_s;
  float* v_s;
  float* p_s;                               // scores, then weights
  float* stat[3];

  __device__ explicit Smem(float* base) {
    q_s = base;
    k_s = q_s + ROWS * DP;
    v_s = k_s + BK * DP;
    p_s = v_s + BK * D;
    stat[0] = p_s + ROWS * BK;
    stat[1] = stat[0] + ROWS;
    stat[2] = stat[1] + ROWS;
  }
};

inline size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)ROWS * (D + 4) + (size_t)BK * (D + 4) +
                          (size_t)BK * D + (size_t)ROWS * BK + 3 * ROWS);
}

// This block's place: sequence b, KV head h, rows r0 .. r0 + rows_here.
struct Tile {
  int b, h, G, Hq, Lq, Lk, causal;
  int r0, rows_here, shift, n_keys;
  size_t kv_base;

  __device__ Tile(int Hq_, int Hkv, int Lq_, int Lk_, int causal_) {
    Hq = Hq_;
    Lq = Lq_;
    Lk = Lk_;
    causal = causal_;
    b = blockIdx.x / Hkv;
    h = blockIdx.x % Hkv;
    G = Hq / Hkv;
    const int n_rows = G * Lq;
    r0 = (gridDim.y - 1 - blockIdx.y) * ROWS;   // most keys first
    rows_here = min(ROWS, n_rows - r0);
    shift = Lk - Lq;                            // query i sits at i + shift
    const int last_pos = (r0 + rows_here - 1) / G + shift;
    n_keys = causal ? min(Lk, last_pos + 1) : Lk;
    kv_base = ((size_t)b * Hkv + h) * Lk;
  }

  // offset of row r's D-vector in q and out (B, Hq, Lq, D)
  __device__ size_t row_offset(int r, int D) const {
    const int i = (r0 + r) / G;
    const int g = (r0 + r) % G;
    return (((size_t)b * Hq + (size_t)h * G + g) * Lq + i) * D;
  }
};

// q rows into q_s, each element times `scale` (rounded, never fused);
// rows past the tile's end are 0.
template <int D>
__device__ __forceinline__ void load_q(const float* __restrict__ q,
                                       const Smem<D>& s, const Tile& t,
                                       float scale) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D;
    const int d = idx % D;
    s.q_s[r * Smem<D>::DP + d] =
        r < t.rows_here ? __fmul_rn(q[t.row_offset(r, D) + d], scale) : 0.0f;
  }
}

// the K (and, with `with_v`, V) tile of keys j0 .. j0 + BK; keys past Lk
// are 0.  The caller synchronizes.
template <int D>
__device__ __forceinline__ void load_kv(const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const Smem<D>& s, const Tile& t,
                                        int j0, bool with_v) {
  for (int idx = threadIdx.x; idx < BK * D; idx += THREADS) {
    const int j = idx / D;
    const int d = idx % D;
    const bool in = j0 + j < t.Lk;
    const size_t at = (t.kv_base + (size_t)(j0 + j)) * D + d;
    s.k_s[j * Smem<D>::DP + d] = in ? k[at] : 0.0f;
    if (with_v) s.v_s[idx] = in ? v[at] : 0.0f;
  }
}

// p_s[r][jj] = q_s[r] . k_s[jj] for the tile of keys from j0, or -inf where
// the key lies past Lk, past the row's causal limit, or the row past the
// tile's end.  The caller synchronizes.
template <int D>
__device__ __forceinline__ void score_tile(const Smem<D>& s, const Tile& t,
                                           int j0) {
  constexpr int DP = Smem<D>::DP;
  const int ja = threadIdx.x % 16;          // keys ja, ja + 16
  const int ra = threadIdx.x / 16;          // rows ra + 16u
  float acc[4][2];
#pragma unroll
  for (int u = 0; u < 4; ++u) acc[u][0] = acc[u][1] = 0.0f;
  const float4* k0 = reinterpret_cast<const float4*>(s.k_s + ja * DP);
  const float4* k1 = reinterpret_cast<const float4*>(s.k_s + (ja + 16) * DP);
#pragma unroll 4
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 x = k0[d4], y = k1[d4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 a =
          reinterpret_cast<const float4*>(s.q_s + (ra + 16 * u) * DP)[d4];
      acc[u][0] = fmaf(a.x, x.x, acc[u][0]);
      acc[u][0] = fmaf(a.y, x.y, acc[u][0]);
      acc[u][0] = fmaf(a.z, x.z, acc[u][0]);
      acc[u][0] = fmaf(a.w, x.w, acc[u][0]);
      acc[u][1] = fmaf(a.x, y.x, acc[u][1]);
      acc[u][1] = fmaf(a.y, y.y, acc[u][1]);
      acc[u][1] = fmaf(a.z, y.z, acc[u][1]);
      acc[u][1] = fmaf(a.w, y.w, acc[u][1]);
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = ra + 16 * u;
    const int pos = (t.r0 + r) / t.G + t.shift;
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const int j = j0 + ja + 16 * w;
      const bool ok = r < t.rows_here && j < t.Lk && (!t.causal || j <= pos);
      s.p_s[r * BK + ja + 16 * w] = ok ? acc[u][w] : -INFINITY;
    }
  }
}

// P @ V rows per thread; thread tid owns column tid % D of rows
// pv_row() .. pv_row() + RPT.
template <int D>
struct PV {
  static constexpr int RPT = ROWS * D / THREADS;
  __device__ static int col() { return threadIdx.x % D; }
  __device__ static int row() { return (threadIdx.x / D) * RPT; }
};

// acc[u] += sum_jj p_s[row + u][jj] * v_s[jj][col] over the tile.
template <int D>
__device__ __forceinline__ void pv_accumulate(const Smem<D>& s,
                                              float (&acc)[PV<D>::RPT]) {
  const int col = PV<D>::col();
  const int row = PV<D>::row();
  for (int jj = 0; jj < BK; jj += 4) {
    const float v0 = s.v_s[(jj + 0) * D + col];
    const float v1 = s.v_s[(jj + 1) * D + col];
    const float v2 = s.v_s[(jj + 2) * D + col];
    const float v3 = s.v_s[(jj + 3) * D + col];
#pragma unroll
    for (int u = 0; u < PV<D>::RPT; ++u) {
      const float4 p =
          *reinterpret_cast<const float4*>(s.p_s + (row + u) * BK + jj);
      float a = fmaf(p.x, v0, acc[u]);
      a = fmaf(p.y, v1, a);
      a = fmaf(p.z, v2, a);
      acc[u] = fmaf(p.w, v3, a);
    }
  }
}

// out rows from the P @ V registers, rows past the tile's end skipped.
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const Tile& t,
                                           const float (&acc)[PV<D>::RPT]) {
#pragma unroll
  for (int u = 0; u < PV<D>::RPT; ++u) {
    const int r = PV<D>::row() + u;
    if (r < t.rows_here) out[t.row_offset(r, D) + PV<D>::col()] = acc[u];
  }
}

// Launch `kernel` over the grid (B * Hkv, row tiles) with the shared
// memory of head dim D; returns the cudaError_t.
template <int D, typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int B, int Hq, int Hkv, int Lq,
           cudaStream_t stream, Args... args) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rows = (Hq / Hkv) * Lq;
  dim3 grid(B * Hkv, (n_rows + ROWS - 1) / ROWS);
  kernel<<<grid, THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, D>) for the head dims the kernels take.
template <typename F>
int dispatch_head_dim(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace attn_tiles
