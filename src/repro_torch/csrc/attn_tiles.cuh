// Tile code shared by the causal GQA attention kernels: flash attention
// (flash_attention.cu, kernel F) and log-domain flash attention
// (logdomain_flash.cu, kernel C).  Each kernel keeps only its own softmax
// (and C its own score tile); the block's place, the K/V ring, the
// split-TF32 tensor-core products, F's score tile, the masks, P @ V and
// the output store live here.
//
// Layout: one block per (sequence, KV head, tile of rows), rows ordered
// r = i*G + g, so one K/V tile in shared memory serves every query head of
// the GQA group at consecutive positions — K/V are read at head h and never
// repeated.  Row tiles with the most keys are scheduled first, and a causal
// tile's keys stop at its last position.  Each warp owns 16 query rows:
// its scores, its softmax state and its P @ V accumulators stay in the
// registers of mma.sync fragments (m16n8k8), so the softmax needs only
// quad shuffles and no barrier.  K/V tiles stream through a two-stage
// cp.async ring (16-byte copies, rows past Lk zero-filled), one barrier a
// tile: the next tile lands under the current tile's math.  Ragged lengths
// are masked, so no length has to be a multiple of a tile.
//
// Split TF32: every f32 operand x is split into hi = x rounded to TF32 and
// lo = x - hi (exact) truncated to TF32, and a product accumulates
// lo*hi + hi*lo + hi*hi in the tensor cores' f32 accumulators — about
// 2^-21 relative per product, where one TF32 product would be 2^-11.  The
// split is integer and f32 arithmetic (an add and a mask for hi, a
// subtraction and a mask for lo), which took kernel F from 0.287 to 0.227
// ms on an H100 against cvt.rna.tf32.f32.  A bf16 value is exact in TF32,
// so a bf16 operand drops its lo products (two products instead of
// three).
//
// Operand layouts, chosen so every shared-memory access is conflict-free
// at D = 32..256 and vectorized (a row pitch of D + 4 floats is 4 banks
// past a multiple of 32 at D = 128 and 256 alike):
// * Q.K^T contracts over d in groups of GW = 32: in k-step kk of a group,
//   lane quad-index t holds d = GW*grp + 8t + 2kk (+1), so a lane reads 8
//   consecutive d of one K row (two float4) for four k-steps.  Q uses the
//   same permutation of d (any permutation of the contraction gives the
//   same sum).  K rows are padded to D + 4 floats (bf16: D + 32 halves).
// * P @ V takes P straight from the score fragment: key 2t and 2t + 1 of
//   an 8-key step play k = t and t + 4, so V's rows 2t and 2t + 1 are read.
//   Output columns of four n-blocks interleave (n-block u, column j ->
//   32*grp + 4j + u), so a lane reads four consecutive columns of a V row
//   (one float4) and stores eight consecutive outputs.  V rows are padded to
//   D + 4 floats (bf16: D + 8 halves).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace attn_tiles {

constexpr int WARP_ROWS = 16;     // query rows per warp (one m16 tile)
constexpr int STAGES = 2;         // K/V ring depth
constexpr unsigned FULL = 0xffffffffu;

// ---- PTX -------------------------------------------------------------------

// d += a (16x8, row) * b (8x8, col) in TF32 with f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; with ok false nothing is read and the 16
// bytes are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- end PTX ---------------------------------------------------------------

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr bool TF32_EXACT = false;
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool TF32_EXACT = true;   // 8 mantissa bits <= 10
};

// Row pitches of the K and V tiles, in elements (see the header note).
template <typename T, int D>
struct Pitch {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int K = F32 ? D + 4 : (D <= 32 ? D : D + 32);
  static constexpr int V = F32 ? D + 4 : D + 8;
};

// The contraction's groups: GW d values per group, PER per lane, KPG
// k-steps per group; NG output n-blocks per V group.
template <int D>
struct Groups {
  static constexpr int GW = D < 32 ? D : 32;
  static constexpr int PER = GW / 4;
  static constexpr int KPG = GW / 8;
  static constexpr int NG = D / 8 < 4 ? D / 8 : 4;
};

struct Strides {            // elements between batches, heads, positions
  long long b, h, l;
};

// This block's place: sequence b, KV head h, rows r0 .. r0 + rows_here.
struct Tile {
  int b, h, G, Hq, Lq, Lk, causal;
  int r0, rows_here, shift, n_keys;

  __device__ Tile(int Hq_, int Hkv, int Lq_, int Lk_, int causal_,
                  int rows) {
    Hq = Hq_;
    Lq = Lq_;
    Lk = Lk_;
    causal = causal_;
    b = blockIdx.x / Hkv;
    h = blockIdx.x % Hkv;
    G = Hq / Hkv;
    r0 = (gridDim.y - 1 - blockIdx.y) * rows;   // most keys first
    rows_here = min(rows, G * Lq - r0);
    shift = Lk - Lq;                            // query i sits at i + shift
    n_keys = causal ? max(0, min(Lk, pos(rows_here - 1) + 1)) : Lk;
  }

  __device__ int pos(int r) const { return (r0 + r) / G + shift; }

  // offset of row r's D-vector in q (strided) and in out (contiguous)
  __device__ long long q_offset(int r, const Strides& s) const {
    const int i = (r0 + r) / G;
    const int g = (r0 + r) % G;
    return b * s.b + (long long)(h * G + g) * s.h + (long long)i * s.l;
  }
  __device__ long long out_offset(int r, int D) const {
    const int i = (r0 + r) / G;
    const int g = (r0 + r) % G;
    return (((long long)b * Hq + h * G + g) * Lq + i) * D;
  }
};

// The two rows a lane holds in its warp's fragments (g and g + 8 of the
// warp's 16), whether they exist, their positions, and the keys the warp
// needs (0 for a warp past the tile's end).
struct WarpRows {
  int row[2], pos[2];
  bool ok[2];
  int n_keys;

  __device__ WarpRows(const Tile& t, int warp, int g) {
    const int base = warp * WARP_ROWS;
    for (int i = 0; i < 2; ++i) {
      row[i] = base + g + 8 * i;
      ok[i] = row[i] < t.rows_here;
      pos[i] = t.pos(row[i]);
    }
    const int last = min(base + WARP_ROWS, t.rows_here) - 1;
    n_keys = last < base ? 0
             : t.causal  ? max(0, min(t.Lk, t.pos(last) + 1))
                         : t.Lk;
  }

  // key j is visible to the lane's row i
  __device__ bool sees(const Tile& t, int i, int j) const {
    return ok[i] && j < t.Lk && (!t.causal || j <= pos[i]);
  }
};

// ---- split TF32 products -----------------------------------------------------

struct FragA {              // an m16k8 A fragment, split
  uint32_t hi[4], lo[4];
};

constexpr uint32_t TF32_MASK = 0xffffe000u;   // sign, exponent, 10 bits

// x rounded to the nearest TF32 value (ties away from zero), as bits;
// finite x only
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & TF32_MASK;
}

// x - hi, exact in f32, truncated to TF32
__device__ __forceinline__ uint32_t tf32_rest(float x, uint32_t hi) {
  return __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & TF32_MASK;
}

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  const float a[4] = {a0, a1, a2, a3};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f.hi[i] = tf32_round(a[i]);
    f.lo[i] = tf32_rest(a[i], f.hi[i]);
  }
  return f;
}

// d += A * B for B = (b0, b1), split; B_EXACT: b0 and b1 are TF32 values
template <bool B_EXACT>
__device__ __forceinline__ void mma_split(float (&d)[4], const FragA& a,
                                          float b0, float b1) {
  if (B_EXACT) {
    mma_tf32(d, a.lo, __float_as_uint(b0), __float_as_uint(b1));
    mma_tf32(d, a.hi, __float_as_uint(b0), __float_as_uint(b1));
  } else {
    const uint32_t h0 = tf32_round(b0), h1 = tf32_round(b1);
    const uint32_t r0 = tf32_rest(b0, h0), r1 = tf32_rest(b1, h1);
    mma_tf32(d, a.lo, h0, h1);
    mma_tf32(d, a.hi, r0, r1);
    mma_tf32(d, a.hi, h0, h1);
  }
}

// N consecutive elements of shared memory (16-byte aligned for N*size
// >= 16) as floats
template <typename T, int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const T* src) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      if constexpr (N >= 4) {
        const float4 x = *reinterpret_cast<const float4*>(src + i);
        dst[i] = x.x;
        dst[i + 1] = x.y;
        dst[i + 2] = x.z;
        dst[i + 3] = x.w;
      }
    }
    if constexpr (N == 2) {
      const float2 x = *reinterpret_cast<const float2*>(src);
      dst[0] = x.x;
      dst[1] = x.y;
    }
  } else {
    static_assert(N == 2 || N == 4 || N == 8, "bf16 vector of 2, 4 or 8");
    if constexpr (N == 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(src);
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dst[2 * i] = __uint_as_float(w[i] << 16);
        dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else if constexpr (N == 4) {
      const uint2 x = *reinterpret_cast<const uint2*>(src);
      dst[0] = __uint_as_float(x.x << 16);
      dst[1] = __uint_as_float(x.x & 0xffff0000u);
      dst[2] = __uint_as_float(x.y << 16);
      dst[3] = __uint_as_float(x.y & 0xffff0000u);
    } else {
      const uint32_t x = *reinterpret_cast<const uint32_t*>(src);
      dst[0] = __uint_as_float(x << 16);
      dst[1] = __uint_as_float(x & 0xffff0000u);
    }
  }
}

// ---- the K/V ring --------------------------------------------------------------

// Rows j0 .. j0 + n of a (sequence, head)'s K or V into a tile of `pitch`
// elements a row, 16-byte cp.async pieces spread over the block's threads;
// rows past Lk are zero-filled.  The caller commits.
template <typename T, int D>
__device__ __forceinline__ void issue_rows(T* dst, int pitch, const T* src,
                                           long long row_stride, int j0,
                                           int n, int Lk) {
  constexpr int EPC = 16 / sizeof(T);      // elements a piece
  constexpr int CH = D / EPC;              // pieces a row
  for (int idx = threadIdx.x; idx < n * CH; idx += blockDim.x) {
    const int j = idx / CH;
    const int c = idx % CH;
    const bool ok = j0 + j < Lk;
    const T* s = src + (ok ? (long long)(j0 + j) * row_stride : 0) + c * EPC;
    cp_async16(dst + j * pitch + c * EPC, s, ok);
  }
}

// ---- the score tile --------------------------------------------------------------

// s[nb] = Q . K^T for the warp's 16 rows and keys 8nb .. 8nb + 8 of the K
// tile `ks` (pitch Pitch<T, D>::K); qfrag(k_step, f) gives the raw A
// fragment {Q[g][d], Q[g+8][d], Q[g][d+1], Q[g+8][d+1]} of a k-step.
template <typename T, int D, int NB, typename QFrag>
__device__ __forceinline__ void score_tile(float (&s)[NB][4], const T* ks,
                                           QFrag&& qfrag, int g, int t) {
  using Gr = Groups<D>;
  constexpr int PK = Pitch<T, D>::K;
  constexpr int CH = NB < 4 ? NB : 4;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.0f;
#pragma unroll
  for (int c = 0; c < NB; c += CH) {
#pragma unroll
    for (int grp = 0; grp < D / Gr::GW; ++grp) {
      float kv[CH][Gr::PER];
#pragma unroll
      for (int u = 0; u < CH; ++u)
        load_vec<T, Gr::PER>(
            kv[u], ks + ((c + u) * 8 + g) * PK + Gr::GW * grp + Gr::PER * t);
#pragma unroll
      for (int kk = 0; kk < Gr::KPG; ++kk) {
        float q[4];
        qfrag(grp * Gr::KPG + kk, q);
        const FragA a = split_a(q[0], q[1], q[2], q[3]);
#pragma unroll
        for (int u = 0; u < CH; ++u)
          mma_split<Elem<T>::TF32_EXACT>(s[c + u], a, kv[u][2 * kk],
                                         kv[u][2 * kk + 1]);
      }
    }
  }
}

// Scores of keys the lane's rows cannot see become -inf.
template <int NB>
__device__ __forceinline__ void mask_tile(float (&s)[NB][4], const Tile& t,
                                          const WarpRows& w, int j0, int tq) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = j0 + nb * 8 + 2 * tq + e;
      if (!w.sees(t, 0, j)) s[nb][e] = -INFINITY;
      if (!w.sees(t, 1, j)) s[nb][2 + e] = -INFINITY;
    }
}

// The A row-major index of the fragment {row g key 2t, row g+8 key 2t,
// row g key 2t+1, row g+8 key 2t+1} (see the header note on P @ V).
// o += P(16 x 8 keys) @ V(rows `vrow`, `vrow` + pitch) for one 8-key step.
template <typename T, int D>
__device__ __forceinline__ void pv_step(float (&o)[D / 8][4], const FragA& p,
                                        const T* vrow, int g) {
  using Gr = Groups<D>;
  constexpr int NG = Gr::NG;
  constexpr int PV = Pitch<T, D>::V;
#pragma unroll
  for (int grp = 0; grp < D / (8 * NG); ++grp) {
    float v0[NG], v1[NG];
    load_vec<T, NG>(v0, vrow + 8 * NG * grp + NG * g);
    load_vec<T, NG>(v1, vrow + PV + 8 * NG * grp + NG * g);
#pragma unroll
    for (int u = 0; u < NG; ++u)
      mma_split<Elem<T>::TF32_EXACT>(o[grp * NG + u], p, v0[u], v1[u]);
  }
}

// Row i (0: g, 1: g + 8) of the P @ V accumulators, times `inv`, to its
// output row: the lane's 2*NG consecutive columns of each group.
template <int D>
__device__ __forceinline__ void store_row(void* out, bool bf16,
                                          long long offset,
                                          const float (&o)[D / 8][4], int i,
                                          float inv, int t) {
  constexpr int NG = Groups<D>::NG;
#pragma unroll
  for (int grp = 0; grp < D / (8 * NG); ++grp) {
    float x[2 * NG];
#pragma unroll
    for (int u = 0; u < NG; ++u) {
      x[u] = o[grp * NG + u][2 * i] * inv;
      x[NG + u] = o[grp * NG + u][2 * i + 1] * inv;
    }
    const long long at = offset + 8 * NG * grp + 2 * NG * t;
    if (bf16) {
      uint32_t w[NG];
#pragma unroll
      for (int u = 0; u < NG; ++u) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * u], x[2 * u + 1]);
        w[u] = *reinterpret_cast<const uint32_t*>(&h);
      }
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + at;
      if constexpr (NG == 4)
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
      float* dst = static_cast<float*>(out) + at;
#pragma unroll
      for (int k = 0; k < 2 * NG; k += 4)
        *reinterpret_cast<float4*>(dst + k) =
            make_float4(x[k], x[k + 1], x[k + 2], x[k + 3]);
    }
  }
}

// f(std::integral_constant<int, D>) for the head dims the kernels take.
template <typename F>
int dispatch_head_dim(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace attn_tiles
