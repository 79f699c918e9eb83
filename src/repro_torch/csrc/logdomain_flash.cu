// NL-DPE log-domain flash attention (paper Fig 6c, exp-bypass): one score
// pass where the row tile's scores fit in shared memory, two above, every
// exp from a table, P @ V on the tensor cores in split TF32.
//
// Replaces: src/repro/kernels/dual_compute/kernel.py,
//   logdomain_flash_kernel (pallas_call at :192; body _ld_flash_kernel at
//   :121, quantizer _quant_apply at :114); and the wrapper's log_quantize
//   of q, k and v (kernels/dual_compute/ops.py), as one launch.
//
// Computes, for q (B, Hq, Lq, D) and k/v (B, Hkv, Lk, D) (f32 or bf16,
// strided over batch, head and position), G = Hq/Hkv:
//   quantize launch:  q_l = log_quantize(q * scale), k_l, v_l = log_quantize
//     of k, v — sign * exp(q8(log|x|)) on the DMMul grid, |x| under the
//     flush threshold 0, rounded as core.logdomain.log_quantize rounds it
//     (f32 scalars, no contraction) with the exp read from a 256-entry
//     table the wrapper builds with torch's own exp;
//   attention launch: s_ij = q_l[i] . k_l[j] over the keys j <= i + Lk - Lq
//     (causal, queries at the end of the KV axis) or all keys, K/V at head
//     h, then
//       m_i = max_j s_ij                               (ACAM winner-take-all)
//       c_ij = code of y_ij = s_ij - m_i on the score grid [-r, 0]
//       t_i = sum_j T1[c_ij],  T1[c] = q8(exp(yq(c))) on [0, 1] (exp ACAM)
//       lt_i = q8(log t_i) on [-r, log(Lk + 1)]
//       out_i = sum_j T2[code of (T0[c_ij] - lt_i) on [-2r, 0]] v_l[j]
//     with T0[c] = yq(c), the score grid's value, and T2[c] the exp of the
//     log-softmax grid's value: three 256-entry tables built by the wrapper
//     with QuantSpec's rounding and torch's exp, so every exp is the plain
//     version's bits.  A row whose max is not finite (no visible key) takes
//     m = 0 and gets weight 0 everywhere.
//
// Every grid crossing is rounded as the port's QuantSpec rounds it: code =
// rint((x - lo) * (1/step)) clamped to [0, 255], value = code * step + lo,
// with __fsub_rn/__fmul_rn/__fadd_rn so nvcc cannot contract the steps into
// FMAs, and logf (no fast math): a score that lands on a rounding boundary
// moves a code, and a moved code moves a weight by a whole log-softmax
// step (6.5%), more than the tolerance where a row has few keys.  So the
// scores are f32 FMA chains in d order from 0, the order of the plain
// version's f32 matmul, and are its bits: split-TF32 scores (about 2^-21
// relative) moved codes at full width, up to 0.0095 against 1/255.  The
// row sum t_i crosses the log-sum grid too, so it is summed exactly: every
// T1 value is 0 or a float32 in [1/255, 1], a multiple of 2^-32, so the
// kernel adds them as int64 fixed point and rounds the sum to float32
// once (the plain version sums in float64, exact below 2^21 keys, and
// rounds once): the same bits in any order.  A row sum in float32 in
// another order than the plain version's moved a row's log-sum code at a
// grid boundary (on an H100, tools/logdomain_row_check.py: one row in
// 10240 at D 256 and at D 128, up to 0.0098 against 1/255).  What can
// still differ from the plain version: P @ V's
// split-TF32 rounding (about 1e-6; no grid follows it).
//
// What bounds it on an H100: operations, as for flash attention (kernel
// F): 4*D FLOPs per visible (row, key) pair, half of them the scores in f32
// FMAs (67 TFLOP/s), half P @ V in split TF32 (three products, 495
// TFLOP/s).  The tiling is kernel F's (attn_tiles.cuh): K and V tiles of 32
// keys through a two-stage cp.async ring serving the GQA group, P @ V in
// warps of 16 rows with mma fragments, causal tiles past a warp's last
// position skipped.  The scores are a 4 x 2 register micro-tile per thread
// over the block's q rows in shared memory, in twice as many warps as P @ V
// has (the second half only scores and copies).  Each float4 read feeds
// few FMAs, so the scores ask about 3 bytes of shared memory per FMA where
// the SM serves one: shared-memory bandwidth, not the FMA units, bounds
// them.  Two instances, chosen by the wrapper's plan:
// * resident (the row tile's f32 scores fit beside the ring): Q.K^T once,
//   each score written to shared memory with the row max taken on the way;
//   then all threads, four a row, codes and row sums, then weights in
//   place; then P @ V with V through the same ring;
// * two-pass (longer keys): a first Q.K^T for the row max, a second for
//   the codes, kept as bytes in a device scratch (one byte per (row, key),
//   a slice a block, so any length runs), and the row sums; P @ V from the
//   codes.  With no codes in shared memory three blocks share an SM; that
//   beat codes in shared memory (one block an SM) at 2048 keys.
// The exps are table reads; the per-score work a subtraction, a rint
// quantization and a lookup per pass.
// Head dim 256 (PaliGemma) runs the same layout: the ring and the q rows
// take 133 KB of shared memory there (66 KB at D 128), so the resident
// instance holds up to 352 keys (608 at D 128) and the two-pass instance
// takes the rest; a P @ V warp's accumulators are 128 registers a lane.

#include "attn_tiles.cuh"

namespace {

using namespace attn_tiles;

constexpr int BK = 32;              // keys a tile
constexpr int ROWS = 4 * WARP_ROWS; // rows a block: four P @ V warps
constexpr int THREADS = 4 * ROWS;   // eight warps: the scores take all of
                                    // them, P @ V the first four
constexpr int TABLE = 256;

// the instances, in the order of the wrapper's LD_INSTANCES
enum Instance { kTwoPass = 0, kResident = 1 };

struct Grid {         // an 8-bit uniform grid: lo, step, float32(1 / step)
  float lo, step, inv_step;
};

struct Grids {
  Grid score;         // [-r, 0]
  Grid logsum;        // [-r, log(Lk + 1)]
  Grid logp;          // [-2r, 0]
};

__device__ __forceinline__ int q8code(float x, const Grid& g) {
  float c = rintf(__fmul_rn(__fsub_rn(x, g.lo), g.inv_step));
  c = fminf(fmaxf(c, 0.0f), 255.0f);
  return (int)c;
}

__device__ __forceinline__ float q8value(int c, const Grid& g) {
  return __fadd_rn(__fmul_rn((float)c, g.step), g.lo);
}

template <int D>
struct Layout {
  static constexpr int P = D + 4;           // K, V and Q tile rows
  static constexpr size_t TILE = (size_t)BK * P * sizeof(float);
  static constexpr size_t TABLES = 3 * TABLE * sizeof(float);
};

// Row pitch of the scores (resident, floats) or codes (two-pass, bytes):
// the keys rounded up to a tile, plus 8 so a half-warp's 8-byte score
// accesses hit distinct banks.
inline int score_pitch(int Lk) { return (Lk + BK - 1) / BK * BK + 8; }

// Dynamic shared memory: the ring | the tables | a float per row (the row
// max, resident; the row sum, two-pass) | Q rows | the scores (resident).
template <int D>
__host__ __device__ constexpr size_t offset_q() {
  return STAGES * Layout<D>::TILE + Layout<D>::TABLES + ROWS * sizeof(float);
}
template <int D>
__host__ __device__ constexpr size_t offset_s() {
  return offset_q<D>() + (size_t)ROWS * Layout<D>::P * sizeof(float);
}
template <int D>
size_t layout_bytes(int instance, int Lk) {
  const size_t scores = (size_t)ROWS * score_pitch(Lk) * sizeof(float);
  return offset_s<D>() + (instance == kResident ? scores : 0);
}

// Bytes of the device scratch the two-pass instance needs: a row tile's
// codes for every block.
size_t scratch_bytes(int B, int Hq, int Hkv, int Lq, int Lk) {
  const size_t tiles = ((size_t)(Hq / Hkv) * Lq + ROWS - 1) / ROWS;
  return (size_t)B * Hkv * tiles * ROWS * score_pitch(Lk);
}

struct Args {
  const float* q;     // q_l (B, Hq, Lq, D), contiguous
  const float* k;     // k_l, v_l (B, Hkv, Lk, D), contiguous
  const float* v;
  void* out;
  int out_bf16;
  int Hq, Hkv, Lq, Lk, causal, sp;
  Grids gr;
  const float* tables;  // T0 | T1 | T2
  unsigned char* codes; // two-pass: the device scratch
};

// s[u][w] = q_s[ra + (rows/4) u] . k_s[ja + 16w]: one fmaf chain per
// score in d order from 0, as the plain version's f32 matmul sums on the
// card, so that no score code moves against it.
template <int D>
__device__ __forceinline__ void fma_scores(float (&s)[4][2], const float* qs,
                                           const float* ks, int ra, int ja,
                                           int rstep) {
  constexpr int P = Layout<D>::P;
#pragma unroll
  for (int u = 0; u < 4; ++u) s[u][0] = s[u][1] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 q[4], k[2];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      q[u] = *reinterpret_cast<const float4*>(qs + (ra + rstep * u) * P + d);
#pragma unroll
    for (int w = 0; w < 2; ++w)
      k[w] = *reinterpret_cast<const float4*>(ks + (ja + 16 * w) * P + d);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        float x = fmaf(q[u].x, k[w].x, s[u][w]);
        x = fmaf(q[u].y, k[w].y, x);
        x = fmaf(q[u].z, k[w].z, x);
        s[u][w] = fmaf(q[u].w, k[w].w, x);
      }
  }
}

// A row's max over the sixteen lanes that share it.
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// A row-sum term in 2^-32 units: T1 values are multiples of 2^-32 in
// [0, 1], so the product and the conversion are exact.
__device__ __forceinline__ long long fixed32(float x) {
  return __float2ll_rn(__fmul_rn(x, 4294967296.0f));
}

// An exact fixed-point row sum, rounded to float32 once (through double:
// exact below 2^53 units).
__device__ __forceinline__ float fixed32_to_float(long long x) {
  return __double2float_rn((double)x * 2.3283064365386963e-10);
}

// A row's fixed-point partial sum over the sixteen lanes that share it.
__device__ __forceinline__ long long sum16(long long x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int D, bool RESIDENT>
__global__ void __launch_bounds__(THREADS)
logdomain_flash_kernel(const Args a) {
  using Lt = Layout<D>;
  constexpr int NB = BK / 8;
  constexpr int NPASS_K = RESIDENT ? 1 : 2;
  constexpr int rows = ROWS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int ra = threadIdx.x >> 4;          // score micro-tile: rows ra +
  const int ja = threadIdx.x & 15;          // (rows/4) u, keys ja + 16w
  constexpr int rstep = rows / 4;
  const Tile t(a.Hq, a.Hkv, a.Lq, a.Lk, a.causal, rows);
  const WarpRows w(t, warp, g);
  float* tab = reinterpret_cast<float*>(smem + STAGES * Lt::TILE);
  float* row_stat = tab + 3 * TABLE;
  float* qs = reinterpret_cast<float*>(smem + offset_q<D>());
  float* S = reinterpret_cast<float*>(smem + offset_s<D>());  // resident
  unsigned char* codes =                    // two-pass: this block's slice
      RESIDENT ? nullptr
               : a.codes + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                               rows * a.sp;
  for (int i = threadIdx.x; i < 3 * TABLE; i += blockDim.x)
    tab[i] = a.tables[i];
  const float* T0 = tab;
  const float* T1 = tab + TABLE;
  const float* T2 = tab + 2 * TABLE;

  const size_t kv_base = ((size_t)t.b * a.Hkv + t.h) * a.Lk * D;
  const int n_tiles = (t.n_keys + BK - 1) / BK;
  const int total = (NPASS_K + 1) * n_tiles;
  auto slot = [&](int it) {
    return reinterpret_cast<float*>(smem + (it & 1) * Lt::TILE);
  };
  auto issue = [&](int it) {
    const int pass = it / n_tiles;
    issue_rows<float, D>(slot(it), Lt::P,
                         (pass == NPASS_K ? a.v : a.k) + kv_base, D,
                         (it - pass * n_tiles) * BK, BK, a.Lk);
  };
  auto advance = [&](int it) {              // tile it landed, it-1 consumed
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < total) issue(it + 1);
    cp_async_commit();
  };
  if (total > 0) issue(0);
  cp_async_commit();
  for (int idx = threadIdx.x; idx < rows * (D / 4); idx += blockDim.x) {
    const int r = idx / (D / 4);            // q rows, 16 bytes at a time
    const int c = idx % (D / 4);
    *reinterpret_cast<float4*>(qs + r * Lt::P + 4 * c) =
        r < t.rows_here ? *reinterpret_cast<const float4*>(
                              a.q + t.out_offset(r, D) + 4 * c)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  // Q.K^T in the micro-tile: the row max (and, two-pass, the codes and
  // the row sums) for rows ra + (rows/4) u, all warps
  float m[4], m_safe[4];
  long long tsum[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    m[u] = -INFINITY;
    m_safe[u] = 0.0f;
    tsum[u] = 0;
  }
  int it = 0;
  for (int pass = 0; pass < NPASS_K; ++pass) {
    if (pass == 1) {                        // two-pass: the max is final
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        m[u] = max16(m[u]);
        m_safe[u] = isfinite(m[u]) ? m[u] : 0.0f;
      }
    }
    for (int jt = 0; jt < n_tiles; ++jt, ++it) {
      advance(it);
      const int j0 = jt * BK;
      float s[4][2];
      fma_scores<D>(s, qs, slot(it), ra, ja, rstep);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = ra + rstep * u;
        const int pos = t.pos(r);
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int j = j0 + ja + 16 * v;
          const bool ok = r < t.rows_here && j < t.Lk && (!t.causal || j <= pos);
          const float x = ok ? s[u][v] : -INFINITY;
          if (pass == 0) {
            m[u] = fmaxf(m[u], x);
            if (RESIDENT) S[(size_t)r * a.sp + j] = x;
          } else {                          // codes and the row sum
            int c = 0;
            if (ok) {
              c = q8code(__fsub_rn(x, m_safe[u]), a.gr.score);
              tsum[u] += fixed32(T1[c]);
            }
            codes[(size_t)r * a.sp + j] = (unsigned char)c;
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {             // resident: max; two-pass: sum
    const float x =
        RESIDENT ? max16(m[u]) : fixed32_to_float(sum16(tsum[u]));
    if (ja == 0) row_stat[ra + rstep * u] = x;
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float lt[2] = {0.0f, 0.0f};
  auto weight = [&](int c, int i) {
    return T2[q8code(__fsub_rn(T0[c], lt[i]), a.gr.logp)];
  };
  // P @ V over the mma rows g, g + 8 of each warp of the first half (the
  // second half has no rows: w.n_keys = 0), after the softmax: right after
  // the barrier that publishes the scores (or codes) and row statistics,
  // resident rows are turned into weights by all threads, four a row
  const int w_tiles = (w.n_keys + BK - 1) / BK;
  for (int jt = 0; jt < n_tiles; ++jt, ++it) {
    advance(it);
    if (jt == 0 && RESIDENT) {              // row r = tid / 4: codes and
      const int r = threadIdx.x >> 2;       // row sums, then weights, in
      const int part = threadIdx.x & 3;     // place, 16 bytes at a time
      float* srow = S + (size_t)r * a.sp;
      const float ms = isfinite(row_stat[r]) ? row_stat[r] : 0.0f;
      long long ts = 0;
      for (int j = 4 * part; j < n_tiles * BK; j += 16) {
        float4* p = reinterpret_cast<float4*>(srow + j);
        float x[4] = {p->x, p->y, p->z, p->w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (x[e] == -INFINITY) {
            x[e] = -1.0f;
          } else {
            const int c = q8code(__fsub_rn(x[e], ms), a.gr.score);
            ts += fixed32(T1[c]);
            x[e] = (float)c;
          }
        }
        *p = make_float4(x[0], x[1], x[2], x[3]);
      }
      ts += __shfl_xor_sync(FULL, ts, 1);
      ts += __shfl_xor_sync(FULL, ts, 2);
      const float ltr = q8value(
          q8code(logf(fmaxf(fixed32_to_float(ts), 1e-9f)), a.gr.logsum),
          a.gr.logsum);
      for (int j = 4 * part; j < n_tiles * BK; j += 16) {
        float4* p = reinterpret_cast<float4*>(srow + j);
        float c[4] = {p->x, p->y, p->z, p->w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[e] = c[e] < 0.0f ? 0.0f
                             : T2[q8code(__fsub_rn(T0[(int)c[e]], ltr),
                                         a.gr.logp)];
        *p = make_float4(c[0], c[1], c[2], c[3]);
      }
      __syncthreads();                      // P @ V reads every thread's rows
    } else if (jt == 0) {                   // two-pass: lt from the row sums
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float ts = w.ok[i] ? row_stat[w.row[i]] : 0.0f;
        lt[i] = q8value(q8code(logf(fmaxf(ts, 1e-9f)), a.gr.logsum),
                        a.gr.logsum);
      }
    }
    if (jt >= w_tiles) continue;
    const float* vs = slot(it);
#pragma unroll
    for (int ks = 0; ks < NB; ++ks) {
      const int j = jt * BK + ks * 8 + 2 * tq;
      float p[2][2];                        // [row][key 2t, 2t+1]
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (RESIDENT) {
          const float2 x = *reinterpret_cast<const float2*>(
              S + (size_t)w.row[i] * a.sp + j);
          p[i][0] = x.x;
          p[i][1] = x.y;
        } else {
          const uchar2 c = *reinterpret_cast<const uchar2*>(
              codes + (size_t)w.row[i] * a.sp + j);
          p[i][0] = w.sees(t, i, j) ? weight(c.x, i) : 0.0f;
          p[i][1] = w.sees(t, i, j + 1) ? weight(c.y, i) : 0.0f;
        }
      }
      const FragA f = split_a(p[0][0], p[1][0], p[0][1], p[1][1]);
      pv_step<float, D>(o, f, vs + (ks * 8 + 2 * tq) * Lt::P, g);
    }
  }
  cp_async_wait_all();
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (w.ok[i])
      store_row<D>(a.out, a.out_bf16, t.out_offset(w.row[i], D), o, i, 1.0f,
                   tq);
}

// ---- the quantize launch ---------------------------------------------------

struct QuantIn {      // one operand: (B, H, L, D), strided, f32 or bf16
  const void* src;
  float* dst;         // contiguous
  int bf16, H, L;
  long long sb, sh, sl;
  long long n;        // elements
};

struct LogGrid {      // the DMMul grid's f32 constants (core.logdomain)
  float scale;        // q's 1/sqrt(D)
  float lo, inv_step; // log_lo, 1/step
  float dead;         // |x| under this flushes to 0
  float floor;        // |x| is clamped to this before the log
};

__device__ __forceinline__ float log_quantize1(float x, const LogGrid& lg,
                                              const float* dec) {
  const float ax = fabsf(x);
  if (ax < lg.dead) return 0.0f;
  const int c = (int)fminf(fmaxf(rintf(__fmul_rn(
      __fsub_rn(logf(fmaxf(ax, lg.floor)), lg.lo), lg.inv_step)), 0.0f),
      255.0f);
  return x > 0.0f ? dec[c] : (x < 0.0f ? -dec[c] : x);   // NaN stays
}

template <int D>
__global__ void __launch_bounds__(256)
log_quantize_kernel(const QuantIn q, const QuantIn k, const QuantIn v,
                    const LogGrid lg, const float* dec_g) {
  __shared__ float dec[TABLE];
  for (int i = threadIdx.x; i < TABLE; i += blockDim.x) dec[i] = dec_g[i];
  __syncthreads();
  const long long nq = q.n / 4, nk = k.n / 4, total = nq + 2 * nk;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const bool is_q = i < nq;
    const QuantIn in = is_q ? q : (i < nq + nk ? k : v);
    const long long e = 4 * (is_q ? i : (i < nq + nk ? i - nq : i - nq - nk));
    const int d = (int)(e % D);
    const unsigned row = (unsigned)(e / D);  // rows < 2^31 (the wrapper)
    const unsigned l = row % in.L;
    const unsigned bh = row / in.L;
    const long long at = (long long)(bh / in.H) * in.sb +
                         (long long)(bh % in.H) * in.sh +
                         (long long)l * in.sl + d;
    float x[4];
    if (in.bf16) {
      load_vec<__nv_bfloat16, 4>(
          x, static_cast<const __nv_bfloat16*>(in.src) + at);
    } else {
      load_vec<float, 4>(x, static_cast<const float*>(in.src) + at);
    }
    float y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      y[u] = log_quantize1(is_q ? __fmul_rn(x[u], lg.scale) : x[u], lg, dec);
    *reinterpret_cast<float4*>(in.dst + e) = make_float4(y[0], y[1], y[2],
                                                         y[3]);
  }
}

template <int D, bool RESIDENT>
int launch(const Args& a, int instance, int B, cudaStream_t stream) {
  const size_t smem = layout_bytes<D>(instance, a.Lk);
  auto kernel = logdomain_flash_kernel<D, RESIDENT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rows = (a.Hq / a.Hkv) * a.Lq;
  dim3 grid(B * a.Hkv, (n_rows + ROWS - 1) / ROWS);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v (B, Hq|Hkv, Lq|Lk, D): float32 or bfloat16 each (flags), D in
// {16, 32, 64, 128, 256} contiguous, fewer than 2^31 rows each, strides
// (batch, head, position) in elements in `strides` (9
// values: q, k, v), multiples of 4 with 16-byte aligned bases; q_l, k_l,
// v_l the contiguous float32 outputs.  consts: q's scale, then the DMMul
// grid's log_lo, 1/step, flush threshold and log floor (5 host floats);
// dec: the grid's 256 magnitudes exp(code * step + log_lo) on the device.
// Returns the cudaError_t of the launch.
int logdomain_quantize_launch(const void* q, const void* k, const void* v,
                              float* ql, float* kl, float* vl, int q_bf16,
                              int k_bf16, int v_bf16, int B, int Hq, int Hkv,
                              int Lq, int Lk, int D, const long long* strides,
                              const float* consts, const float* dec,
                              int sms, void* stream) {
  const QuantIn qi{q, ql, q_bf16, Hq, Lq, strides[0], strides[1], strides[2],
                   (long long)B * Hq * Lq * D};
  const QuantIn ki{k, kl, k_bf16, Hkv, Lk, strides[3], strides[4],
                   strides[5], (long long)B * Hkv * Lk * D};
  const QuantIn vi{v, vl, v_bf16, Hkv, Lk, strides[6], strides[7],
                   strides[8], (long long)B * Hkv * Lk * D};
  const LogGrid lg{consts[0], consts[1], consts[2], consts[3], consts[4]};
  const long long groups = (qi.n + 2 * ki.n) / 4;
  const long long want = (groups + 255) / 256;
  const int blocks = (int)(want < 8LL * sms ? want : 8LL * sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_head_dim(D, [&](auto dim) {
    log_quantize_kernel<decltype(dim)::value><<<blocks, 256, 0, st>>>(
        qi, ki, vi, lg, dec);
    return (int)cudaGetLastError();
  });
}

// q_l (B, Hq, Lq, D), k_l/v_l (B, Hkv, Lk, D): contiguous float32 (the
// quantize launch's outputs); out (B, Hq, Lq, D) contiguous, bfloat16 if
// out_bf16 else float32; D in {16, 32, 64, 128, 256}.  instance: 0 two-pass,
// its codes in `codes`, a device scratch of `codes_bytes` (at least
// logdomain_flash_scratch_bytes); 1 resident (one score pass; `codes`
// unused).  grids: 9 host floats,
// (lo, step, 1/step) of the score, log-sum and log-softmax grids; tables:
// T0 | T1 | T2 (768 floats on the device).  Returns the cudaError_t.
int logdomain_flash_launch(const float* q, const float* k, const float* v,
                           void* out, int out_bf16, int B, int Hq, int Hkv,
                           int Lq, int Lk, int D, int causal, int instance,
                           const float* grids, const float* tables,
                           void* codes, size_t codes_bytes, void* stream) {
  if ((instance != kTwoPass && instance != kResident) ||
      (instance == kTwoPass &&
       (!codes || codes_bytes < scratch_bytes(B, Hq, Hkv, Lq, Lk))))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.out_bf16 = out_bf16;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Lq = Lq;
  a.Lk = Lk;
  a.causal = causal;
  a.sp = score_pitch(Lk);
  a.gr.score = {grids[0], grids[1], grids[2]};
  a.gr.logsum = {grids[3], grids[4], grids[5]};
  a.gr.logp = {grids[6], grids[7], grids[8]};
  a.tables = tables;
  a.codes = static_cast<unsigned char*>(codes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch_head_dim(D, [&](auto dim) {
    constexpr int kD = decltype(dim)::value;
    return instance == kResident ? launch<kD, true>(a, instance, B, st)
                                : launch<kD, false>(a, instance, B, st);
  });
}

// Dynamic shared memory of one block of the given instance; 0 for a D
// the kernel does not take.
size_t logdomain_flash_smem_bytes(int instance, int D, int Lk) {
  if (D != 16 && D != 32 && D != 64 && D != 128 && D != 256) return 0;
  size_t bytes = 0;
  dispatch_head_dim(D, [&](auto dim) {
    bytes = layout_bytes<decltype(dim)::value>(instance, Lk);
    return 0;
  });
  return bytes;
}

// Bytes of the device scratch the two-pass instance needs for these
// shapes.
size_t logdomain_flash_scratch_bytes(int B, int Hq, int Hkv, int Lq,
                                     int Lk) {
  return scratch_bytes(B, Hq, Hkv, Lq, Lk);
}

}  // extern "C"
