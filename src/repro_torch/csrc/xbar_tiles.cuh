// Shared tile code of the crossbar kernels: the pipelined SIMT f32 GEMM
// main loop of B (dual_compute.cu), E (crossbar_vmm.cu) and G
// (nldpe_qmatmul.cu), their staged epilogue, and the ACAM breakpoint
// search of B and D (acam_activation.cu).
//
// Main loop.  A block computes a BM x BN output tile; K runs in steps of
// BK through a ring of STAGES raw operand tiles in dynamic shared memory,
// filled with cp.async (16-byte cg copies where the rows are 16-byte
// aligned, 4-byte copies or plain byte loads where they are not), so the
// copies of two steps ahead are in flight while the block computes.  The
// block turns each step's raw tiles into a float32 compute tile once
// ("transform": W_eff formed from the four A-SL cell tiles, or int8 codes
// dequantized), into one of two compute tiles: step t + 1's transform
// runs halfway through step t's FMAs, as straight-line code (every
// per-thread loop has a trip count fixed at compile time), so the
// compiler interleaves the two, and one barrier per step suffices.  Every
// thread accumulates its TM x TN outputs with IEEE fmaf in k order, from
// 0 — one fmaf chain over k = 0 .. K-1 per output, in every tile variant
// (no split K, no TF32, no tensor cores), so B, E and G give the same
// bits whatever the tile, and D∘E equals B.  Ragged M/N/K edges are
// zero-filled in the ring (a zero operand adds +0), never read and never
// stored; nothing is padded in device memory.
//
// Tile variants, chosen per call by `choose` from the call's shape:
//   Small  16 x  32, 2 x 2 per thread, 128 threads, BK 32 — M <= 16 (a
//          decode tick or a lockstep decode step): 344 blocks for
//          N = 11008 and three resident per SM, so enough cell bytes are
//          in flight to stream them at the card's memory rate;
//   Large 128 x 128, 8 x 8 per thread, 256 threads, BK 8 — M >= 128 with
//          at least one block per SM (a prefill chunk, a lockstep
//          prefill, G's large product); the M tiles of one N strip are
//          neighbours in the grid, so L2 serves the cells to all of them;
//   Mid    64 x  64, 4 x 4 per thread, 256 threads, BK 16 — the rest
//          (16 < M < 128, and shapes too small for one Large block per SM,
//          such as G's 512 x 512 x 128).
//
// Epilogue.  The accumulator tile goes through shared memory, and the
// block's live outputs are spread over all its threads, neighbouring
// threads on neighbouring columns (coalesced stores), each through a
// functor: the identity for E and G, the ACAM unit for B.
//
// ACAM unit.  A table (bits x rows of lo <= y <= hi intervals) is compiled
// in PyTorch (core/acam.py, compile_thresholds) into its sorted
// breakpoints b_0 <= ... <= b_{n-1} and 2n + 1 codes: code[2i + 1] is the
// code at y == b_i, code[2i] the code on the open gap (b_{i-1}, b_i) (gap
// 0 below b_0, gap n above b_{n-1}).  `acam_value` finds the first
// breakpoint not below y by binary search (NaN finds none below it: gap 0,
// code 0, as in the row walk) and dequantizes with separate float32
// roundings (__fmul_rn, __fadd_rn), as the port's plain eval_table does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace xbar {

// ---- cp.async -----------------------------------------------------------

// Copy `src_bytes` (0 or B) of B = 4, 8 or 16 bytes and zero-fill the rest
// of B: 16-byte copies bypass L1 (cg), smaller ones cannot (ca).
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(B), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Whether a row-major matrix can be copied in 16-byte chunks: its base is
// 16-byte aligned and every row starts on a 16-byte boundary.
inline bool rows_aligned16(const void* p, long long row_bytes) {
  return ((uintptr_t)p % 16 == 0) && (row_bytes % 16 == 0);
}

// f(i) for i = threadIdx.x, threadIdx.x + THREADS, ... below N, with the
// trip count fixed at compile time: the calls unroll into straight-line
// code that the compiler can interleave with the FMAs around it.
template <int N, int THREADS, class F>
__device__ __forceinline__ void for_each(const F& f) {
#pragma unroll
  for (int r = 0; r < (N + THREADS - 1) / THREADS; ++r) {
    const int i = r * THREADS + threadIdx.x;
    if (N % THREADS == 0 || i < N) f(i);
  }
}

// Rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major (rows x cols) T
// matrix into shared memory (row stride SLD elements), zero outside the
// matrix.  `vec`: the matrix is rows_aligned16, so a chunk of a tile row
// (16 bytes, or the whole row where it is 4 or 8 bytes) is either wholly
// inside or wholly outside it.  Otherwise each element is copied on its
// own: a 4-byte cp.async for float, a plain load for int8.
template <class T, int R, int C, int SLD, int THREADS>
__device__ __forceinline__ void copy_tile(T* s, const T* g, int rows,
                                          int cols, int r0, int c0,
                                          bool vec) {
  constexpr int ROW_BYTES = C * (int)sizeof(T);
  constexpr int CB = ROW_BYTES < 16 ? ROW_BYTES : 16;  // chunk bytes
  constexpr int V = CB / (int)sizeof(T);
  constexpr bool CHUNKED = (CB == 4 || CB == 8 || CB == 16) && C % V == 0;
  if constexpr (CHUNKED) {
    if (vec) {
      constexpr int CPR = C / V;  // chunks per row
      for_each<R * CPR, THREADS>([&](int i) {
        const int r = i / CPR;
        const int c = (i % CPR) * V;
        const int gr = r0 + r;
        const int gc = c0 + c;
        const bool ok = gr < rows && gc < cols;
        cp_async<CB>(s + r * SLD + c, ok ? g + (size_t)gr * cols + gc : g,
                     ok ? CB : 0);
      });
      return;
    }
  }
  for (int i = threadIdx.x; i < R * C; i += THREADS) {
    const int r = i / C;
    const int c = i % C;
    const int gr = r0 + r;
    const int gc = c0 + c;
    const bool ok = gr < rows && gc < cols;
    if constexpr (sizeof(T) == 4) {
      cp_async<4>(s + r * SLD + c, ok ? g + (size_t)gr * cols + gc : g,
                  ok ? 4 : 0);
    } else {
      s[r * SLD + c] = ok ? g[(size_t)gr * cols + gc] : T(0);
    }
  }
}

// ---- tile variants ------------------------------------------------------

template <int BM_, int BN_, int BK_, int TM_, int TN_, int STAGES_,
          int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int THREADS = (BM / TM) * (BN / TN);
  static constexpr int TX = BN / TN;          // threads along N
  // a warp covers 8 threads along N by 4 along M, so its vector loads of
  // the compute tile touch 8 and 4 neighbouring groups: one shared-memory
  // wavefront each
  static_assert(TX % 8 == 0 && (BM / TM) % 4 == 0, "warp tiling");
  // a thread's rows (columns) come in groups of VM (VN) neighbours, the
  // groups BM / (TM / VM) apart, so a warp's vector loads of the compute
  // tile are conflict-free
  static constexpr int VM = TM < 4 ? TM : 4, VN = TN < 4 ? TN : 4;
  static constexpr int COMPUTE_FLOATS = BK * BM + BK * BN;
  static constexpr int TILE_FLOATS = BM * BN;  // the epilogue's staging
};

using Small = Tile<16, 32, 32, 2, 2, 3, 3>;
using Mid = Tile<64, 64, 16, 4, 4, 3, 3>;
using Large = Tile<128, 128, 8, 8, 8, 3, 2>;

enum Variant { SMALL = 0, MID = 1, LARGE = 2 };

// The tile for an (M, K) x (K, N) product on a card with `sms` SMs.
inline Variant choose(int M, int N, int sms) {
  if (M <= 16) return SMALL;
  const long long large = (long long)((M + 127) / 128) * ((N + 127) / 128);
  if (M >= 128 && large >= sms) return LARGE;
  return MID;
}

inline int sm_count() {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

// f(tile) with the tile `choose` picks for (M, N) on this card.
template <class F>
inline auto with_tile(int M, int N, F&& f) {
  switch (choose(M, N, sm_count())) {
    case SMALL: return f(Small{});
    case LARGE: return f(Large{});
    default: return f(Mid{});
  }
}

// The thread's column (x) and row (y) in the block's TX x (BM / TM)
// thread grid: warps tile it in 8 x 4 blocks of lanes.
template <class T>
__device__ __forceinline__ int thread_x() {
  const int warp = threadIdx.x / 32;
  return (warp % (T::TX / 8)) * 8 + threadIdx.x % 8;
}
template <class T>
__device__ __forceinline__ int thread_y() {
  const int warp = threadIdx.x / 32;
  return (warp / (T::TX / 8)) * 4 + (threadIdx.x % 32) / 8;
}

template <class T>
__device__ __forceinline__ int tile_row(int i) {
  return (i / T::VM) * (T::BM / (T::TM / T::VM)) + thread_y<T>() * T::VM +
         i % T::VM;
}
template <class T>
__device__ __forceinline__ int tile_col(int j) {
  return (j / T::VN) * (T::BN / (T::TN / T::VN)) + thread_x<T>() * T::VN +
         j % T::VN;
}

template <int V>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x; dst[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = src[i];
  }
}

// Block ids walk the M tiles of one N strip first.
template <class T>
__device__ __forceinline__ void tile_origin(int M, int& m0, int& n0) {
  const int mt = (M + T::BM - 1) / T::BM;
  m0 = (blockIdx.x % mt) * T::BM;
  n0 = (blockIdx.x / mt) * T::BN;
}

template <class T>
inline unsigned grid_blocks(int M, int N) {
  return (unsigned)(((M + T::BM - 1) / T::BM) * ((N + T::BN - 1) / T::BN));
}

// ---- the main loop ------------------------------------------------------
//
// `Op` names the raw stage of one K step (STAGE_BYTES), issues its copies
// (`load(stage, k0, m0, n0)`) and turns a landed stage into a compute tile
// (`transform(stage, a_c, b_c)`: a_c is BK x BM, b_c BK x BN, both
// k-major).  `ring` holds T::STAGES stages; `comp` two compute tiles, so
// that step t + 1 is transformed into one while step t is computed from
// the other, with one barrier per step.

template <class T, class Op>
__device__ __forceinline__ void transform_step(const Op& op,
                                               const unsigned char* ring,
                                               float* comp, int t) {
  float* a_c = comp + (t % 2) * T::COMPUTE_FLOATS;
  op.transform(ring + (t % T::STAGES) * Op::STAGE_BYTES, a_c,
               a_c + T::BK * T::BM);
}

template <class T, class Op>
__device__ __forceinline__ void gemm_tile(const Op& op, unsigned char* ring,
                                          float* comp, int K, int m0, int n0,
                                          float (&acc)[T::TM][T::TN]) {
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;
  const int tr = thread_y<T>() * T::VM;
  const int tc = thread_x<T>() * T::VN;
  const int steps = (K + T::BK - 1) / T::BK;
#pragma unroll
  for (int s = 0; s < T::STAGES; ++s) {
    if (s < steps) op.load(ring + s * Op::STAGE_BYTES, s * T::BK, m0, n0);
    cp_async_commit();
    if (s == T::STAGES - 2) {  // step 0 landed: transform it
      cp_async_wait<T::STAGES - 2>();
      __syncthreads();
      transform_step<T>(op, ring, comp, 0);
    }
  }
  for (int t = 0; t < steps; ++t) {
    // step t + 1's copies (this thread's, then everyone's) have landed,
    // step t's compute tile is complete, step t - 1's is free, and so is
    // the ring slot step t held
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();
    if (t + T::STAGES < steps)
      op.load(ring + (t % T::STAGES) * Op::STAGE_BYTES,
              (t + T::STAGES) * T::BK, m0, n0);
    cp_async_commit();
    const float* a_c = comp + (t % 2) * T::COMPUTE_FLOATS;
    const float* b_c = a_c + T::BK * T::BM;
#pragma unroll
    for (int kk = 0; kk < T::BK; ++kk) {
      // step t + 1's compute tile, made halfway through step t's FMAs in
      // one straight-line block, so the compiler interleaves the two (past
      // the last step it transforms a stale slot into the spare tile)
      if (kk == T::BK / 2) transform_step<T>(op, ring, comp, t + 1);
      float a[T::TM], b[T::TN];
#pragma unroll
      for (int g = 0; g < T::TM / T::VM; ++g)
        load_vec<T::VM>(a + g * T::VM,
                        a_c + kk * T::BM + g * (T::BM / (T::TM / T::VM)) + tr);
#pragma unroll
      for (int g = 0; g < T::TN / T::VN; ++g)
        load_vec<T::VN>(b + g * T::VN,
                        b_c + kk * T::BN + g * (T::BN / (T::TN / T::VN)) + tc);
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the epilogue
}

// ---- the crossbar operands (B and E) ------------------------------------
//
// x (M, K) float32 row-major; four (K, N) float32 conductance cells whose
// effective weight is
//   W_eff = ((G+ - G-) + (G+res - G-res) * res_scale) * inv,
// each operation rounded on its own so no FMA contraction moves a value.

template <class T>
struct CrossbarOp {
  static constexpr int XLD = T::BK + 4;  // x rows, padded, 16-byte aligned
  static constexpr int X_FLOATS = T::BM * XLD;
  static constexpr int CELL_FLOATS = T::BK * T::BN;
  static constexpr int STAGE_BYTES = 4 * (X_FLOATS + 4 * CELL_FLOATS);
  const float* x;
  const float* cell[4];  // G+, G-, G+res, G-res
  float res_scale, inv;
  int M, N, K;
  bool x_vec, cells_vec;

  __device__ __forceinline__ void load(unsigned char* stage, int k0, int m0,
                                       int n0) const {
    float* s = reinterpret_cast<float*>(stage);
    copy_tile<float, T::BM, T::BK, XLD, T::THREADS>(s, x, M, K, m0, k0,
                                                    x_vec);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      copy_tile<float, T::BK, T::BN, T::BN, T::THREADS>(
          s + X_FLOATS + c * CELL_FLOATS, cell[c], K, N, k0, n0, cells_vec);
  }

  __device__ __forceinline__ float weff(float gp, float gn, float rp,
                                        float rn) const {
    const float main = __fsub_rn(gp, gn);
    const float res = __fmul_rn(__fsub_rn(rp, rn), res_scale);
    return __fmul_rn(__fadd_rn(main, res), inv);
  }

  // Four neighbours at a time: x's four k of one row, transposed; four
  // W_eff of one row of the cells.
  __device__ __forceinline__ void transform(const unsigned char* stage,
                                            float* a_c, float* b_c) const {
    const float* s = reinterpret_cast<const float*>(stage);
    for_each<T::BM * T::BK / 4, T::THREADS>([&](int i) {
      const int m = i % T::BM;
      const int k = (i / T::BM) * 4;
      const float4 v = *reinterpret_cast<const float4*>(s + m * XLD + k);
      a_c[k * T::BM + m] = v.x;
      a_c[(k + 1) * T::BM + m] = v.y;
      a_c[(k + 2) * T::BM + m] = v.z;
      a_c[(k + 3) * T::BM + m] = v.w;
    });
    const float4* c = reinterpret_cast<const float4*>(s + X_FLOATS);
    constexpr int C4 = CELL_FLOATS / 4;
    for_each<C4, T::THREADS>([&](int i) {
      const float4 p = c[i], n = c[C4 + i], rp = c[2 * C4 + i],
                   rn = c[3 * C4 + i];
      reinterpret_cast<float4*>(b_c)[i] =
          make_float4(weff(p.x, n.x, rp.x, rn.x), weff(p.y, n.y, rp.y, rn.y),
                      weff(p.z, n.z, rp.z, rn.z), weff(p.w, n.w, rp.w, rn.w));
    });
  }
};

// Whether four (K, N) cell matrices can be copied in 16-byte chunks.
inline bool cells_aligned16(const float* gp, const float* gn,
                            const float* rp, const float* rn, int N) {
  return rows_aligned16(gp, 4LL * N) && rows_aligned16(gn, 4LL * N) &&
         rows_aligned16(rp, 4LL * N) && rows_aligned16(rn, 4LL * N);
}

// Bytes of the ring of operand stages, at least the epilogue's staging
// tile; the two compute tiles (COMPUTE_FLOATS each) follow it in shared
// memory.
template <class T>
__host__ __device__ constexpr int ring_bytes(int stage_bytes) {
  return T::STAGES * stage_bytes > 4 * T::TILE_FLOATS
             ? T::STAGES * stage_bytes
             : 4 * T::TILE_FLOATS;
}

// Shared-memory bytes of a kernel on tile T with operand stages of
// `stage_bytes` and `extra_bytes` after the compute tile.
template <class T>
inline size_t smem_bytes(int stage_bytes, size_t extra_bytes) {
  return (size_t)ring_bytes<T>(stage_bytes) +
         sizeof(float) * 2 * T::COMPUTE_FLOATS + extra_bytes;
}

// ---- the epilogue -------------------------------------------------------

// Stage the accumulator tile in `tile` (the ring, free after the main
// loop), then write fn(value) for every live output of the block, the
// block's threads along the columns.
template <class T, class Fn>
__device__ __forceinline__ void store_tile(const float (&acc)[T::TM][T::TN],
                                           float* tile, float* out, int M,
                                           int N, int m0, int n0,
                                           const Fn& fn) {
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j)
      tile[tile_row<T>(i) * T::BN + tile_col<T>(j)] = acc[i][j];
  __syncthreads();
  const int live_rows = min(T::BM, M - m0);
  const int live_cols = min(T::BN, N - n0);
  for (int i = threadIdx.x; i < live_rows * T::BN; i += T::THREADS) {
    const int r = i / T::BN;
    const int c = i % T::BN;
    if (c < live_cols)
      out[(size_t)(m0 + r) * N + n0 + c] = fn(tile[r * T::BN + c]);
  }
}

struct Identity {
  __device__ __forceinline__ float operator()(float y) const { return y; }
};

// ---- the ACAM unit ------------------------------------------------------

// Copy a compiled ACAM map (n breakpoints, 2n + 1 codes) into shared
// memory; the caller synchronizes before the first use.
__device__ __forceinline__ void load_map(const float* bp, const int* code,
                                         float* bp_s, int* code_s, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) bp_s[i] = bp[i];
  for (int i = threadIdx.x; i < 2 * n + 1; i += blockDim.x)
    code_s[i] = code[i];
}

inline size_t map_bytes(int n) {
  return sizeof(float) * (size_t)n + sizeof(int) * (2 * (size_t)n + 1);
}

// One ACAM unit on one value: the first breakpoint not below y, then the
// code there (y equal to it) or on the gap below it, dequantized.
__device__ __forceinline__ float acam_value(float y, const float* bp,
                                            const int* code, int n,
                                            float out_lo, float out_step) {
  int first = 0;
  int len = n;
  while (len > 0) {
    const int half = len >> 1;
    if (bp[first + half] < y) {
      first += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  const int c = (first < n && bp[first] == y) ? code[2 * first + 1]
                                              : code[2 * first];
  return __fadd_rn(__fmul_rn((float)c, out_step), out_lo);
}

struct Acam {
  const float* bp;
  const int* code;
  int n;
  float out_lo, out_step;
  __device__ __forceinline__ float operator()(float y) const {
    return acam_value(y, bp, code, n, out_lo, out_step);
  }
};

}  // namespace xbar
