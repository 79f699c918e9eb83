// Paged GQA attention against a page pool through a block table.
//
// Replaces: src/repro/kernels/paged_attention/kernel.py,
//   paged_attention_kernel (pallas_call at :164; body _paged_kernel at :55).
//
// Computes, for q (B, Hq, Q, D) f32, pools (P, Hkv, ps, D) in f32 or bf16
// -- or int8 codes with (P, Hkv, ps) f32 scales (kv_quant "int8"/"log8") --
// block table bt (B, NB) int32 and lengths (B,) int32:
//   out[b, h*G+g, j] = softmax_p(q . k_p / sqrt(D)) @ v over the logical
//   positions p < lengths[b] + j, position p stored in page bt[b, p / ps]
//   at offset p % ps.  Block-table entries outside [0, P) are unmapped
//   sentinels: their pages are never read and contribute nothing.  A row
//   with no valid position gives 0.
//
// What bounds it on an H100: bytes.  Each K/V page is read once per
// (sequence, KV head, row tile) and feeds every row of the tile with
// 2*ps*D FLOPs per row, far below the card's ~20 FLOPs-per-byte f32 ridge.
// The design keeps that traffic down and the card busy:
//   * one block per (sequence, KV head, tile of ROWS query rows); the
//     GQA group's rows (g*Q + j) share each page it loads into shared
//     memory, so decode (Q = 1) reads each page once for all G heads;
//   * scores as a small register-tiled product: each thread computes a
//     2 rows x 2 page slots micro-tile from float4 shared-memory loads (one
//     load per FMA instead of two), over rows padded by four floats so a
//     quarter-warp's loads hit distinct banks; the head dim is a template
//     parameter, so the loops unroll;
//   * P @ V with one thread per head-dim column and all of the tile's rows
//     in registers: each V element loaded once feeds ROWS independent FMAs,
//     and each row's probabilities come four at a time as one float4;
//   * the online softmax runs four threads per row (shuffle reductions);
//   * pages are read in the pool's own dtype and widened to f32 in shared
//     memory; the pool is never upcast as a whole;
//   * int8 code pools (a third pool kind) are decoded as each page is
//     staged, as the TPU kernel decodes one page tile in VMEM: four codes
//     per 4-byte load, each value table[code + 128] * scale, the 256-entry
//     f32 table (core.quantization.kv_table: sign * exp(fma) for log8, the
//     code for int8) copied to shared memory once per block.  The table is
//     built with the plain version's own formula, so the kernel and the
//     plain version decode to the same floats and differ only in sum order;
//     an 8-bit pool moves a quarter of an f32 pool's bytes plus 4 B of
//     scale per (page, head, position).  A sentinel page's codes and scale
//     row are never read;
//   * when B*Hkv*tiles is too small to fill 132 SMs (decode), the page
//     axis is split over gridDim.z and a second kernel merges the partial
//     (max, sum, acc) triples (flash-decoding);
//   * pages past lengths[b] + Q - 1 and sentinel pages are skipped.
// IEEE f32 arithmetic throughout: FMA dot products, expf, no TF32.
// This first version uses no cp.async/TMA pipelining (a later PR).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROWS = 32;      // query rows per block
constexpr int THREADS = 128;  // = 4 * ROWS; one thread per column in P@V
constexpr unsigned FULL = 0xffffffffu;
constexpr int TABLE = 256;    // int8 decode table entries (code + 128)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// T = float or __nv_bfloat16: fp pools; T = int8_t: code pools, decoded
// through table[code + 128] * scale as each page is staged.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const float* __restrict__ q,
                       const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const float* __restrict__ k_scale,  // int8 pools
                       const float* __restrict__ v_scale,  // int8 pools
                       const float* __restrict__ table,    // int8 pools
                       const int* __restrict__ bt,
                       const int* __restrict__ lengths,
                       float* __restrict__ out,       // splits == 1
                       float* __restrict__ part_acc,  // splits > 1
                       float* __restrict__ part_ml,   // splits > 1
                       int Hq, int Hkv, int Q, int P, int ps, int NB,
                       int pages_per_split, float scale) {
  constexpr int DP = D + 4;             // padded, 16-byte aligned rows
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // ROWS * DP
  float* k_s = q_s + ROWS * DP;         // ps * DP
  float* v_s = k_s + ps * DP;           // ps * D
  float* p_s = v_s + ps * D;            // ROWS * ps
  float* m_s = p_s + ROWS * ps;         // ROWS running max
  float* l_s = m_s + ROWS;              // ROWS running sum
  float* c_s = l_s + ROWS;              // ROWS correction factor
  float* t_s = c_s + ROWS;              // TABLE decode entries (int8 pools)
  constexpr bool kCodes = std::is_same<T, int8_t>::value;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;            // b * Hkv + h
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int G = Hq / Hkv;
  const int n_rows = G * Q;             // rows of this (b, h): r = g*Q + j
  const int r0 = blockIdx.y * ROWS;
  const int rows_here = min(ROWS, n_rows - r0);
  const int split = blockIdx.z;
  const int len = lengths[b];

  // rows of (b, h) are contiguous in q/out: (b*Hq + h*G)*Q*D + r*D
  const size_t row_base = ((size_t)b * Hq + (size_t)h * G) * Q * D;
  for (int idx = tid; idx < ROWS * D; idx += THREADS) {
    const int r = idx / D;
    const int d = idx % D;
    q_s[r * DP + d] = (r < rows_here)
                          ? q[row_base + (size_t)(r0 + r) * D + d] : 0.0f;
  }
  for (int r = tid; r < ROWS; r += THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
  }
  if constexpr (kCodes) {
    for (int i = tid; i < TABLE; i += THREADS) t_s[i] = table[i];
  }
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;

  const int i_begin = split * pages_per_split;
  const int i_end = min(NB, i_begin + pages_per_split);
  const int pos_limit = len + Q - 1;    // no row attends at or past this
  const size_t page_stride = (size_t)Hkv * ps * D;
  const int rh = (rows_here + 1) / 2;   // score micro-tile: row half
  const int sh = (ps + 1) / 2;          // and slot half
  __syncthreads();

  for (int i = i_begin; i < i_end; ++i) {
    if (i * ps >= pos_limit) break;     // past every row's length
    const int blk = bt[(size_t)b * NB + i];
    if (blk < 0 || blk >= P) continue;  // unmapped sentinel: never read
    const size_t base = (size_t)blk * page_stride + (size_t)h * ps * D;
    if constexpr (kCodes) {
      // four codes per load (D % 4 == 0, so they share a position); the
      // page's base is a multiple of D bytes, so the char4 loads align
      const size_t srow = ((size_t)blk * Hkv + h) * ps;
      const char4* kc = reinterpret_cast<const char4*>(k_pages + base);
      const char4* vc = reinterpret_cast<const char4*>(v_pages + base);
      for (int i4 = tid; i4 < ps * D / 4; i4 += THREADS) {
        const int slot = (i4 * 4) / D;
        const int col = (i4 * 4) % D;
        const float ks = k_scale[srow + slot];
        const float vs = v_scale[srow + slot];
        const char4 kq = kc[i4];
        const char4 vq = vc[i4];
        *reinterpret_cast<float4*>(k_s + slot * DP + col) = make_float4(
            t_s[kq.x + 128] * ks, t_s[kq.y + 128] * ks,
            t_s[kq.z + 128] * ks, t_s[kq.w + 128] * ks);
        *reinterpret_cast<float4*>(v_s + i4 * 4) = make_float4(
            t_s[vq.x + 128] * vs, t_s[vq.y + 128] * vs,
            t_s[vq.z + 128] * vs, t_s[vq.w + 128] * vs);
      }
    } else {
      for (int idx = tid; idx < ps * D; idx += THREADS) {
        k_s[(idx / D) * DP + idx % D] = to_f32(k_pages[base + idx]);
        v_s[idx] = to_f32(v_pages[base + idx]);
      }
    }
    __syncthreads();

    // scores: thread t owns rows (ra, ra + rh) x slots (ja, ja + sh)
    for (int t = tid; t < rh * sh; t += THREADS) {
      const int ra = t / sh;
      const int ja = t % sh;
      const int rb = min(ra + rh, rows_here - 1);
      const int jb = min(ja + sh, ps - 1);
      const float4* qa = reinterpret_cast<const float4*>(q_s + ra * DP);
      const float4* qb = reinterpret_cast<const float4*>(q_s + rb * DP);
      const float4* ka = reinterpret_cast<const float4*>(k_s + ja * DP);
      const float4* kb = reinterpret_cast<const float4*>(k_s + jb * DP);
      float s00 = 0.0f, s01 = 0.0f, s10 = 0.0f, s11 = 0.0f;
#pragma unroll 8
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 a = qa[d4], b = qb[d4], x = ka[d4], y = kb[d4];
        s00 = fmaf(a.x, x.x, s00); s00 = fmaf(a.y, x.y, s00);
        s00 = fmaf(a.z, x.z, s00); s00 = fmaf(a.w, x.w, s00);
        s01 = fmaf(a.x, y.x, s01); s01 = fmaf(a.y, y.y, s01);
        s01 = fmaf(a.z, y.z, s01); s01 = fmaf(a.w, y.w, s01);
        s10 = fmaf(b.x, x.x, s10); s10 = fmaf(b.y, x.y, s10);
        s10 = fmaf(b.z, x.z, s10); s10 = fmaf(b.w, x.w, s10);
        s11 = fmaf(b.x, y.x, s11); s11 = fmaf(b.y, y.y, s11);
        s11 = fmaf(b.z, y.z, s11); s11 = fmaf(b.w, y.w, s11);
      }
      const float sv[4] = {s00, s01, s10, s11};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = (u < 2) ? ra : ra + rh;
        const int jj = (u & 1) ? ja + sh : ja;
        if (r < rows_here && jj < ps) {
          const int qoff = (r0 + r) % Q;
          p_s[r * ps + jj] =
              (i * ps + jj) < len + qoff ? sv[u] * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: four threads per row, shuffle reductions
    {
      const int r = tid >> 2;
      const int sub = tid & 3;
      const bool live = r < rows_here;
      float mx = -INFINITY;
      if (live)
        for (int jj = sub; jj < ps; jj += 4) mx = fmaxf(mx, p_s[r * ps + jj]);
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      float sum = 0.0f;
      if (live) {
        for (int jj = sub; jj < ps; jj += 4) {
          const float p = expf(p_s[r * ps + jj] - m_safe);  // -inf -> 0
          p_s[r * ps + jj] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      if (live && sub == 0) {
        const float corr = isfinite(m_old) ? expf(m_old - m_safe) : 0.0f;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // P @ V: thread = head-dim column; each V element feeds every row
    if (tid < D) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (r < rows_here) acc[r] *= c_s[r];
      int jj = 0;
      if ((ps & 3) == 0) {
        for (; jj < ps; jj += 4) {
          const float v0 = v_s[(jj + 0) * D + tid];
          const float v1 = v_s[(jj + 1) * D + tid];
          const float v2 = v_s[(jj + 2) * D + tid];
          const float v3 = v_s[(jj + 3) * D + tid];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            if (r < rows_here) {
              const float4 p =
                  *reinterpret_cast<const float4*>(p_s + r * ps + jj);
              float a = fmaf(p.x, v0, acc[r]);
              a = fmaf(p.y, v1, a);
              a = fmaf(p.z, v2, a);
              acc[r] = fmaf(p.w, v3, a);
            }
          }
        }
      }
      for (; jj < ps; ++jj) {           // page sizes not a multiple of 4
        const float v = v_s[jj * D + tid];
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          if (r < rows_here) acc[r] = fmaf(p_s[r * ps + jj], v, acc[r]);
      }
    }
    __syncthreads();                    // k_s/v_s/p_s reused next page
  }

  if (part_acc == nullptr) {
    if (tid < D) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < rows_here) {
          const float l = l_s[r];
          out[row_base + (size_t)(r0 + r) * D + tid] =
              acc[r] / (l == 0.0f ? 1.0f : l);
        }
      }
    }
    return;
  }
  // partial triple of this split: acc (un-normalized), m, l
  const int splits = gridDim.z;
  const size_t prow = ((size_t)bh * splits + split) * n_rows;
  if (tid < D) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < rows_here) part_acc[(prow + r0 + r) * D + tid] = acc[r];
  }
  for (int r = tid; r < rows_here; r += THREADS) {
    part_ml[(prow + r0 + r) * 2 + 0] = m_s[r];
    part_ml[(prow + r0 + r) * 2 + 1] = l_s[r];
  }
}

// Merge the per-split partials: one block per (b*Hkv + h, row).
__global__ void paged_attention_combine(const float* __restrict__ part_acc,
                                        const float* __restrict__ part_ml,
                                        float* __restrict__ out, int Hq,
                                        int Hkv, int Q, int D, int splits) {
  const int bh = blockIdx.x;
  const int row = blockIdx.y;
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int G = Hq / Hkv;
  const int n_rows = G * Q;
  float m_all = -INFINITY;
  for (int s = 0; s < splits; ++s)
    m_all = fmaxf(m_all, part_ml[(((size_t)bh * splits + s) * n_rows + row) * 2]);
  const float m_safe = isfinite(m_all) ? m_all : 0.0f;
  float l_all = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const size_t pr = ((size_t)bh * splits + s) * n_rows + row;
    const float m = part_ml[pr * 2];
    if (isfinite(m)) l_all += part_ml[pr * 2 + 1] * expf(m - m_safe);
  }
  const float denom = l_all == 0.0f ? 1.0f : l_all;
  const size_t orow = ((size_t)b * Hq + (size_t)h * G) * Q * D + (size_t)row * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const size_t pr = ((size_t)bh * splits + s) * n_rows + row;
      const float m = part_ml[pr * 2];
      if (isfinite(m)) a = fmaf(part_acc[pr * D + d], expf(m - m_safe), a);
    }
    out[orow + d] = a / denom;
  }
}

size_t smem_bytes(int D, int ps, bool codes) {
  return sizeof(float) *
         ((size_t)ROWS * (D + 4) + (size_t)ps * (D + 4) + (size_t)ps * D +
          (size_t)ROWS * ps + 3 * ROWS + (codes ? TABLE : 0));
}

template <typename T, int D>
int launch(const float* q, const void* k_pages, const void* v_pages,
           const float* k_scale, const float* v_scale, const float* table,
           const int* bt, const int* lengths, float* out, float* part_acc,
           float* part_ml, int B, int Hq, int Hkv, int Q, int P, int ps,
           int NB, int splits, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, ps, std::is_same<T, int8_t>::value);
  cudaError_t err = cudaFuncSetAttribute(
      paged_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rows = (Hq / Hkv) * Q;
  const int pages_per_split = (NB + splits - 1) / splits;
  dim3 grid(B * Hkv, (n_rows + ROWS - 1) / ROWS, splits);
  const float scale = 1.0f / sqrtf((float)D);
  paged_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      q, static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      k_scale, v_scale, table, bt, lengths, out,
      splits > 1 ? part_acc : nullptr,
      splits > 1 ? part_ml : nullptr, Hq, Hkv, Q, P, ps, NB,
      pages_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  paged_attention_combine<<<dim3(B * Hkv, n_rows), 128, 0, stream>>>(
      part_acc, part_ml, out, Hq, Hkv, Q, D, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const float* q, const void* k_pages, const void* v_pages,
             const float* k_scale, const float* v_scale, const float* table,
             const int* bt, const int* lengths, float* out, float* part_acc,
             float* part_ml, int B, int Hq, int Hkv, int Q, int D, int P,
             int ps, int NB, int splits, cudaStream_t stream) {
  switch (D) {
#define PAGED_D(DV)                                                       \
  case DV:                                                                \
    return launch<T, DV>(q, k_pages, v_pages, k_scale, v_scale, table, bt, \
                         lengths, out, part_acc, part_ml, B, Hq, Hkv, Q, P, \
                         ps, NB, splits, stream);
    PAGED_D(16)
    PAGED_D(32)
    PAGED_D(64)
    PAGED_D(128)
#undef PAGED_D
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs; the wrapper checks it against the card.
size_t paged_attention_smem_bytes(int D, int ps, int kv_kind) {
  return smem_bytes(D, ps, kv_kind == 2);
}

int paged_attention_rows_per_block() { return ROWS; }

// kv_kind: 0 = float32 pools, 1 = bfloat16 pools, 2 = int8 code pools with
// k_scale/v_scale (P, Hkv, ps) floats and the 256-entry decode table
// (unused, and may be null, for fp pools); D in {16, 32, 64, 128}.
// part_acc/part_ml are scratch of (B*Hkv, splits, G*Q, D) and
// (B*Hkv, splits, G*Q, 2) floats, used only when splits > 1.  Returns the
// cudaError_t of the launches.
int paged_attention_launch(const float* q, const void* k_pages,
                           const void* v_pages, int kv_kind,
                           const float* k_scale, const float* v_scale,
                           const float* table, const int* bt,
                           const int* lengths, float* out, float* part_acc,
                           float* part_ml, int B, int Hq, int Hkv, int Q,
                           int D, int P, int ps, int NB, int splits,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_kind == 2)
    return launch_d<int8_t>(q, k_pages, v_pages, k_scale, v_scale, table, bt,
                            lengths, out, part_acc, part_ml, B, Hq, Hkv, Q, D,
                            P, ps, NB, splits, s);
  if (kv_kind == 1)
    return launch_d<__nv_bfloat16>(q, k_pages, v_pages, k_scale, v_scale,
                                   table, bt, lengths, out, part_acc, part_ml,
                                   B, Hq, Hkv, Q, D, P, ps, NB, splits, s);
  return launch_d<float>(q, k_pages, v_pages, k_scale, v_scale, table, bt,
                         lengths, out, part_acc, part_ml, B, Hq, Hkv, Q, D, P,
                         ps, NB, splits, s);
}

}  // extern "C"
