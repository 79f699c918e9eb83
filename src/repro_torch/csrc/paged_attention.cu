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
//   sentinels: their pages (and scale rows) are never read and contribute
//   nothing.  A row with no valid position gives 0.  Positions at or past
//   lengths[b] + Q - 1 are never read.
//
// The rows of one (sequence b, KV head h) are r = g*Q + j (G = Hq / Hkv):
// they share every K/V position, so a block owns a tile of those rows and
// streams the positions once for the whole tile.  The wrapper
// (kernels/paged_attention/ops.py, `plan`) picks one of two instances from
// G*Q, and the number of splits of the position axis:
//
// Decode instance (G*Q <= 16: a decode tick, G = 8, Q = 1, has 8 rows).
//   Bound by bytes: each K/V element feeds 2 FLOPs per row, and 8 rows are
//   far below the card's ridge.  The work per sequence is small, so what
//   costs time is latency; the design keeps many copies in flight and no
//   block barrier in the main loop.  Rows = G*Q rounded up to 8 (R = 8 or
//   16), 128 threads = 4 warps, each warp an independent streamer: warp w
//   takes the block's position chunks w, w + 4, ... (8 positions each)
//   through its own cp.async ring (2 stages for f32 pools, 3 for bf16, 4
//   for 8-bit codes), so each warp needs only __syncwarp.  Scores: the D
//   dims are split over lanes (a float4 each; D/4 lanes per position), q
//   sits in registers, and the R partial dot products are summed over the
//   lanes by a transposing butterfly (each step halves the values a lane
//   carries: R - 1 + log2(D/4 / R) shuffles per position, not R log2(D/4)).
//   The online softmax runs one lane per row; P @ V keeps R float4
//   accumulators per lane.  At the end the four warps' (max, sum, acc)
//   merge through shared memory in warp order.
//
// Chunk instance (G*Q > 16: chunk prefill, 512 rows at G = 8, Q = 64).
//   Bound by operations: at 128 rows every K/V float feeds 256 FLOPs.  A
//   block owns 64 rows (G*Q <= 64) or 128 rows, 256 threads: thread
//   (rg, pg) = (tid / 16, tid % 16) computes RM = 4 or 8 rows x 4
//   positions of Q.K^T (positions pg + 16c) from float4 loads of q and k
//   laid out d-quad major ([D/4][rows or positions][4]): per four dims,
//   RM + 4 float4 loads feed 16 RM FMAs (2.7 FMAs per shared float at RM =
//   8).  The same thread owns RM rows x D/16 dims of P @ V (8 x 8 at D =
//   128: each shared float feeds 4 FMAs), so the rows' running max, sum
//   and correction stay in registers (16-lane shuffles) and P goes through
//   shared memory only between the two halves of one warp (__syncwarp).
//   K/V stream through a 2-stage cp.async ring of 64 positions: f32 pools
//   land straight in the compute layouts, so a stage costs one barrier;
//   bf16 and code pools land raw and are widened/decoded into an f32 tile
//   (a second barrier).  With 128-row tiles a (sequence, KV head)'s
//   positions are staged ceil(G*Q / 128) times (4 at G = 8, Q = 64).
//   1 block per SM (225 KB of shared memory at f32, D = 128).
//
// Both instances:
//   * stage positions, not pages: a stage's positions may span pages (any
//     page size); each position's K (or V) row is one contiguous run of
//     D elements of the pool, copied as 16-byte cp.async.cg pieces (a
//     code pool's 4-byte scales with 4-byte copies), zero-filled for a
//     sentinel page or past the block's range; the next step's block-table
//     entries are read, and its copies issued, while this step computes;
//   * raw bytes land in shared memory; bf16 widens and an int8 code
//     decodes as table[code + 128] * scale only after, from a 256-entry
//     f32 table (core.quantization.kv_table, built with the plain
//     version's formula).  The f32 and code instances run one schedule and
//     one sum order on the same floats, so a code pool gives the bits of
//     an f32 pool holding its decoded values;
//   * splits of the position axis: decode cuts the block table's width
//     into the grid's splits (known before the length, so the first
//     block-table reads go out with the length's); chunk cuts each
//     sequence's positions at fixed absolute stage boundaries:
//     ch_split_stages(RM) stages a split (3 for 128-row tiles, 2 for
//     64-row ones), doubled until at most CH_MAX_SPLITS splits cover the
//     sequence.  Nothing of the other sequences of the launch enters, and
//     a query row's positions fall into the same splits at the same
//     stages whatever the chunk's start and the row's index in it (a
//     masked position adds an exact 0, an empty split merges as one), so
//     a row's output is bit-invariant to the batch and to the chunking, as
//     long as its sequence stays in one doubling regime (up to
//     CH_MAX_SPLITS * 3 * 64 = 3072 positions at 128-row tiles).
//     A split with no position writes nothing; the first block of each
//     sequence records
//     how many splits are busy, and a second launch merges their (max,
//     sum, acc) triples in split order, one block per (sequence, KV head,
//     row) (flash-decoding).  Merging in the same launch instead (the last
//     block of a row tile to take an atomic ticket merges every split) was
//     measured slower on an H100 in both instances, since one block then
//     merges a whole tile alone;
//   * IEEE f32 arithmetic throughout: fmaf dot products, expf; no TF32, no
//     tensor cores.
//
// Head dim 256 (PaliGemma's 8/1 heads).  Decode: D/4 = 64 lanes a position
// would be two warps, so a lane takes two float4s (dims 4l and 128 + 4l)
// and a position is one warp; q and the accumulators are then 2R float4s
// a lane, 64 registers each at R = 8, so only G*Q <= 8 takes the decode
// instance there (R = 16 would hold 256 registers of them: G*Q of 9-16
// takes the chunk instance's 64-row tile).  Chunk: one 64-position f32
// stage is 128 KB of K and V, and the 64-row q tile 64 KB, so a stage
// holds 32 positions (200.8 KB at f32 and bf16, 170.3 KB for codes) and
// only 64-row tiles exist; a split is 4 stages of 32, the same 128
// absolute positions as 2 stages of 64 at the other head dims, so a row's
// sum order is batch- and chunk-invariant there too (up to CH_MAX_SPLITS
// * 128 = 2048 positions).  At D <= 128 both instances run the same
// operations in the same order as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TABLE = 256;         // int8 decode table entries (code + 128)

constexpr int DEC_THREADS = 128;   // decode instance: 4 independent warps
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_SW = 8;          // positions per warp step
constexpr int DEC_STEP = DEC_SW * DEC_WARPS;   // positions per block step

constexpr int CH_THREADS = 256;    // chunk instance
constexpr int CH_STAGES = 2;

// chunk positions per stage: 64, 32 at D = 256 (see the header note)
template <int D>
__host__ __device__ constexpr int ch_positions() {
  return D > 128 ? 32 : 64;
}

// decode: float4s a lane takes of a position's D (one warp spans D <= 128)
template <int D>
__host__ __device__ constexpr int dec_vectors() {
  return D > 128 ? D / 128 : 1;
}

// Decode ring depth by pool element size (the same shared bytes per stage
// buy more positions in flight for narrower pools).
template <typename T>
constexpr int dec_stages() {
  return sizeof(T) == 4 ? 2 : sizeof(T) == 2 ? 3 : 4;
}

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const float* k_scale;   // code pools
  const float* v_scale;
  const float* table;
  const int* bt;
  const int* lengths;
  float* out;
  float* part_acc;        // splits > 1: (B*Hkv, splits, G*Q, D)
  float* part_ml;         //             (B*Hkv, splits, G*Q, 2)
  int* busy;              //             (B,): busy splits per sequence
  int Hq, Hkv, Q, P, ps, NB;
  int splits;             // grid splits of the position axis
  float scale;
};

// ---- cp.async -------------------------------------------------------------

// 16 bytes (or, with ok false, 16 zero bytes and no read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- pool rows --------------------------------------------------------------

// The pool row (index of a D-element row, P*Hkv*ps < 2^31) of logical
// position `pos` of (b, h) on block `blk` (row_of: read from the block
// table), or -1 for a position past `limit`, past the block table, or on a
// sentinel page.
__device__ __forceinline__ int pool_row(const Args& a, int h, int pos,
                                        int limit, int blk) {
  return pos < limit && blk >= 0 && blk < a.P
             ? (blk * a.Hkv + h) * a.ps + pos % a.ps
             : -1;
}

__device__ __forceinline__ int row_of(const Args& a, int b, int h, int pos,
                                      int limit) {
  const int page = pos / a.ps;
  return pool_row(a, h, pos, limit,
                  page < a.NB ? __ldg(a.bt + (size_t)b * a.NB + page) : -1);
}

// Four consecutive elements (element e, a multiple of 4) of a raw row in
// shared memory, widened to f32; a code row decodes through the table.
template <typename T>
__device__ __forceinline__ float4 load4(const unsigned char* row, int e,
                                        const float* tab, float sc) {
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float4*>(row + 4 * e);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + 2 * e);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  } else {
    const char4 c = *reinterpret_cast<const char4*>(row + e);
    return make_float4(tab[c.x + 128] * sc, tab[c.y + 128] * sc,
                       tab[c.z + 128] * sc, tab[c.w + 128] * sc);
  }
}

// ---- partial triples --------------------------------------------------------

// Element d of row `row` merged over the partials of the first `busy`
// splits (those that hold positions), in split order; eight splits' loads
// go out at once.
__device__ __forceinline__ float merge_splits(const Args& a, int bh, int row,
                                              int d, int D, int n_rows,
                                              int busy) {
  constexpr int U = 8;
  const size_t p0 = (size_t)bh * a.splits * n_rows + row;
  float m_all = -INFINITY;
  for (int s0 = 0; s0 < busy; s0 += U) {
    float m[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      m[u] = s0 + u < busy
                 ? __ldcg(a.part_ml + (p0 + (size_t)(s0 + u) * n_rows) * 2)
                 : -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) m_all = fmaxf(m_all, m[u]);
  }
  const float m_safe = isfinite(m_all) ? m_all : 0.0f;
  float l_all = 0.0f, acc = 0.0f;
  for (int s0 = 0; s0 < busy; s0 += U) {
    float m[U], l[U], x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t pr = p0 + (size_t)(s0 + u) * n_rows;
      const bool in = s0 + u < busy;
      m[u] = in ? __ldcg(a.part_ml + pr * 2) : -INFINITY;
      l[u] = in ? __ldcg(a.part_ml + pr * 2 + 1) : 0.0f;
      x[u] = in ? __ldcg(a.part_acc + pr * D + d) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u < busy) {
        const float e = isfinite(m[u]) ? expf(m[u] - m_safe) : 0.0f;
        l_all = fmaf(l[u], e, l_all);
        acc = fmaf(x[u], e, acc);
      }
    }
  }
  return acc / (l_all == 0.0f ? 1.0f : l_all);
}

// Decode: the splits that hold positions of a sequence of length `len`
// (a split past the length does nothing and writes nothing).  The table's
// width is cut into the grid's splits of whole block steps.
__device__ __forceinline__ int decode_busy(const Args& a, int len) {
  const int nuw = (a.NB * a.ps + DEC_STEP - 1) / DEC_STEP;
  const int nc = (len + a.Q - 1 + DEC_SW - 1) / DEC_SW;   // warp chunks
  int busy = 0;
  while (busy < a.splits && busy * nuw / a.splits * DEC_WARPS < nc) ++busy;
  return busy;
}

// Merge the busy splits' partials in a second launch: one block per
// (b*Hkv + h, row); the first block of each sequence recorded its number
// of busy splits.
__global__ void paged_attention_kernel_combine(Args a, int D) {
  const int bh = blockIdx.x, row = blockIdx.y;
  const int b = bh / a.Hkv, h = bh % a.Hkv, G = a.Hq / a.Hkv;
  const int n_rows = G * a.Q;
  const int busy = __ldg(a.busy + b);
  const size_t orow =
      ((size_t)b * a.Hq + (size_t)h * G) * a.Q * D + (size_t)row * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x)
    a.out[orow + d] = merge_splits(a, bh, row, d, D, n_rows, busy);
}

// ---- decode instance ------------------------------------------------------

// Sum each of R values over the LD lanes of a lane group (lane bits below
// LD), transposing as it goes: each step sends half of the values a lane
// still carries to its partner and keeps the other half, so a lane ends
// with max(1, R / LD) sums, of rows roff, roff + 1, ...  M is the step's
// lane mask, N the number of values carried into it.
template <int R, int M, int N>
struct Butterfly {
  static constexpr int NN = N > 1 ? N / 2 : 1;       // carried out
  using Next = Butterfly<R, M / 2, NN>;
  static constexpr int NL = Next::NL;
  // lane bits summed without transposing: a lane writes its rows iff 0
  static constexpr int PLAIN = (N > 1 ? 0 : M) | Next::PLAIN;
  __device__ __forceinline__ static void run(float (&v)[R], int lane,
                                             int& roff) {
    if constexpr (M >= 1) {
      if constexpr (N > 1) {
        constexpr int H = N / 2;
        const bool upper = (lane & M) != 0;
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const float send = upper ? v[i] : v[i + H];
          const float keep = upper ? v[i + H] : v[i];
          v[i] = keep + __shfl_xor_sync(FULL, send, M);
        }
        if (upper) roff += H;
      } else {
        v[0] += __shfl_xor_sync(FULL, v[0], M);
      }
      Next::run(v, lane, roff);
    }
  }
};

template <int R, int N>
struct Butterfly<R, 0, N> {
  static constexpr int NL = N;
  static constexpr int PLAIN = 0;
  __device__ __forceinline__ static void run(float (&)[R], int, int&) {}
};

template <typename T, int D, int R>
struct DecodeLayout {
  static constexpr int E = sizeof(T);
  static constexpr bool kCodes = std::is_same<T, int8_t>::value;
  static constexpr int NST = dec_stages<T>();
  static constexpr int ROWB = D * E;                 // bytes per position
  static constexpr int SLOT_K = 0;
  static constexpr int SLOT_V = DEC_SW * ROWB;
  static constexpr int SLOT_KS = 2 * DEC_SW * ROWB;  // code pools
  static constexpr int SLOT_VS = SLOT_KS + DEC_SW * 4;
  static constexpr int SLOT_OK = SLOT_KS + (kCodes ? 2 * DEC_SW * 4 : 0);
  static constexpr int SLOT = SLOT_OK + DEC_SW * 4;
  static constexpr int SC = NST * SLOT;              // scores [SW][R]
  static constexpr int CR = SC + DEC_SW * R * 4;     // correction [R]
  static constexpr int WARP = CR + R * 4;
  static constexpr int TAB = kCodes ? TABLE * 4 : 0;
  static constexpr int RING = TAB + DEC_WARPS * WARP;
  static constexpr int MERGE = DEC_WARPS * R * (D + 2) * 4;
  static constexpr int SMEM = RING > MERGE ? RING : MERGE;
};

template <typename T, int D, int R>
__global__ void __launch_bounds__(DEC_THREADS)
paged_attention_kernel_decode(Args a) {
  using L = DecodeLayout<T, D, R>;
  constexpr int VPL = dec_vectors<D>();  // float4s a lane, a position
  constexpr int LD = D / (4 * VPL);   // lanes per position
  constexpr int PL = 32 / LD;         // positions per warp step
  constexpr int CPR = L::ROWB / 16;   // 16-byte pieces per position row
  constexpr int NST = L::NST;
  using BF = Butterfly<R, LD / 2, R>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pl = lane / LD, ld = lane % LD;
  const int bh = blockIdx.x, b = bh / a.Hkv, h = bh % a.Hkv;
  const int G = a.Hq / a.Hkv, Q = a.Q, n_rows = G * Q;
  // this split's block steps (4 warp chunks of 8 positions each) of the
  // table's width: known before the length, so the first block-table
  // reads go out with the length's
  const int split = blockIdx.z;
  const int nuw = (a.NB * a.ps + DEC_STEP - 1) / DEC_STEP;
  const int c0 = split * nuw / a.splits * DEC_WARPS;
  const int c1w = (split + 1) * nuw / a.splits * DEC_WARPS;
  int pre[NST - 1];                   // the first steps' block-table rows
#pragma unroll
  for (int n = 0; n < NST - 1; ++n) {
    const int pos = (c0 + warp + DEC_WARPS * n) * DEC_SW + lane;
    const int page = pos / a.ps;
    pre[n] = lane < DEC_SW && page < a.NB
                 ? __ldg(a.bt + (size_t)b * a.NB + page) : -1;
  }
  const int len = __ldg(a.lengths + b);
  const int limit = len + Q - 1;      // no row attends at or past this
  const int nc = (limit + DEC_SW - 1) / DEC_SW;       // warp chunks
  if (split == 0 && h == 0 && tid == 0 && a.splits > 1)
    a.busy[b] = decode_busy(a, len);
  if (c0 >= nc) return;               // past the length: not a busy split
  const int c1 = min(nc, c1w);
  const int mine = c1 - c0 > warp ? (c1 - c0 - warp + DEC_WARPS - 1) /
                                        DEC_WARPS : 0;

  float* tab = reinterpret_cast<float*>(smem);
  unsigned char* wbase = smem + L::TAB + warp * L::WARP;
  float* sc = reinterpret_cast<float*>(wbase + L::SC);
  float* cr = reinterpret_cast<float*>(wbase + L::CR);
  const unsigned char* kpool = static_cast<const unsigned char*>(a.k);
  const unsigned char* vpool = static_cast<const unsigned char*>(a.v);

  // warp-step n: positions (c0 + warp + 4n) * SW .. + SW into slot
  // n % NST; lane p < SW looks up position p's row, the others take it by
  // shuffle, so the step's block-table reads are in flight together
  // (`blk`: this lane's block-table entry, read before the length came,
  // or LOOKUP to read it now)
  constexpr int PIECES = DEC_SW * CPR;
  constexpr int LOOKUP = -2;
  auto issue = [&](int n, int blk) {
    if (n < mine) {
      unsigned char* slot = wbase + (n % NST) * L::SLOT;
      const int p0 = (c0 + warp + DEC_WARPS * n) * DEC_SW;
      int mine_row = -1;
      if (lane < DEC_SW)
        mine_row = blk == LOOKUP ? row_of(a, b, h, p0 + lane, limit)
                                 : pool_row(a, h, p0 + lane, limit, blk);
#pragma unroll
      for (int k = 0; k < (PIECES + 31) / 32; ++k) {
        const int i = lane + 32 * k;
        const int p = min(i / CPR, DEC_SW - 1), piece = i % CPR;
        const int row = __shfl_sync(FULL, mine_row, p);
        if (i < PIECES) {
          const bool ok = row >= 0;
          const size_t off = ok ? (size_t)row * L::ROWB + piece * 16 : 0;
          cp_async16(slot + L::SLOT_K + p * L::ROWB + piece * 16,
                     kpool + off, ok);
          cp_async16(slot + L::SLOT_V + p * L::ROWB + piece * 16,
                     vpool + off, ok);
          if (piece == 0) {
            reinterpret_cast<int*>(slot + L::SLOT_OK)[p] = ok;
            if constexpr (L::kCodes) {
              cp_async4(slot + L::SLOT_KS + p * 4, a.k_scale + (ok ? row : 0),
                        ok);
              cp_async4(slot + L::SLOT_VS + p * 4, a.v_scale + (ok ? row : 0),
                        ok);
            }
          }
        }
      }
    }
    cp_async_commit();                // one group per step, empty or not
  };

#pragma unroll
  for (int n = 0; n < NST - 1; ++n) issue(n, pre[n]);
  if constexpr (L::kCodes) {
    for (int i = tid; i < TABLE; i += DEC_THREADS) tab[i] = a.table[i];
  }

  // q rows of (b, h) are contiguous: (b*Hq + h*G)*Q*D + r*D
  const size_t row_base = ((size_t)b * a.Hq + (size_t)h * G) * Q * D;
  // lane ld holds dims 4 ld + 4 LD u of vector u
  float4 qv[R][VPL];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int u = 0; u < VPL; ++u)
      qv[r][u] = r < n_rows ? *reinterpret_cast<const float4*>(
                                  a.q + row_base + (size_t)r * D + 4 * ld +
                                  4 * LD * u)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 acc[R][VPL];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int u = 0; u < VPL; ++u)
      acc[r][u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float m_run = -INFINITY, l_run = 0.0f;     // lane r < R: row r
  if constexpr (L::kCodes) __syncthreads();  // the table

  for (int n = 0; n < mine; ++n) {
    issue(n + NST - 1, LOOKUP);
    cp_async_wait<NST - 1>();
    __syncwarp();
    const unsigned char* slot = wbase + (n % NST) * L::SLOT;
    const int* okp = reinterpret_cast<const int*>(slot + L::SLOT_OK);
    const float* ksc = reinterpret_cast<const float*>(slot + L::SLOT_KS);
    const float* vsc = reinterpret_cast<const float*>(slot + L::SLOT_VS);
    const int p0 = (c0 + warp + DEC_WARPS * n) * DEC_SW;

    // scores: lane group pl takes position it*PL + pl
#pragma unroll
    for (int it = 0; it < DEC_SW / PL; ++it) {
      const int p = it * PL + pl;
      float4 k4[VPL];
#pragma unroll
      for (int u = 0; u < VPL; ++u)
        k4[u] = load4<T>(slot + L::SLOT_K + p * L::ROWB, 4 * ld + 4 * LD * u,
                         tab, L::kCodes ? ksc[p] : 1.0f);
      float part[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4& q0 = qv[r][0];
        part[r] = fmaf(q0.w, k4[0].w,
                       fmaf(q0.z, k4[0].z, fmaf(q0.y, k4[0].y,
                                                q0.x * k4[0].x)));
#pragma unroll
        for (int u = 1; u < VPL; ++u) {
          const float4& q = qv[r][u];
          part[r] = fmaf(q.w, k4[u].w, fmaf(q.z, k4[u].z, fmaf(
              q.y, k4[u].y, fmaf(q.x, k4[u].x, part[r]))));
        }
      }
      int roff = 0;
      BF::run(part, ld, roff);
      if ((ld & BF::PLAIN) == 0) {
        const bool ok = okp[p] != 0;
#pragma unroll
        for (int i = 0; i < BF::NL; ++i) {
          const int r = roff + i;
          const bool live = ok && r < n_rows && p0 + p < len + r % Q;
          sc[p * R + r] = live ? part[i] * a.scale : -INFINITY;
        }
      }
    }
    __syncwarp();

    // online softmax: lane r owns row r
    if (lane < R) {
      float mx = -INFINITY;
#pragma unroll
      for (int p = 0; p < DEC_SW; ++p) mx = fmaxf(mx, sc[p * R + lane]);
      const float m_new = fmaxf(m_run, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      float sum = 0.0f;
#pragma unroll
      for (int p = 0; p < DEC_SW; ++p) {
        const float e = expf(sc[p * R + lane] - m_safe);   // -inf -> 0
        sc[p * R + lane] = e;
        sum += e;
      }
      const float corr = isfinite(m_run) ? expf(m_run - m_safe) : 0.0f;
      l_run = l_run * corr + sum;
      m_run = m_new;
      cr[lane] = corr;
    }
    __syncwarp();

    // P @ V: lane (pl, ld) accumulates dims 4ld.. over positions it*PL + pl
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float c = cr[r];
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        float4& o = acc[r][u];
        o.x *= c; o.y *= c; o.z *= c; o.w *= c;
      }
    }
#pragma unroll
    for (int it = 0; it < DEC_SW / PL; ++it) {
      const int p = it * PL + pl;
      float4 v4[VPL];
#pragma unroll
      for (int u = 0; u < VPL; ++u)
        v4[u] = load4<T>(slot + L::SLOT_V + p * L::ROWB, 4 * ld + 4 * LD * u,
                         tab, L::kCodes ? vsc[p] : 1.0f);
#pragma unroll
      for (int r4 = 0; r4 < R / 4; ++r4) {
        const float4 pr = *reinterpret_cast<const float4*>(sc + p * R + 4 * r4);
        const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int u = 0; u < VPL; ++u) {
            float4& o = acc[4 * r4 + e][u];
            o.x = fmaf(pv[e], v4[u].x, o.x);
            o.y = fmaf(pv[e], v4[u].y, o.y);
            o.z = fmaf(pv[e], v4[u].z, o.z);
            o.w = fmaf(pv[e], v4[u].w, o.w);
          }
        }
      }
    }
    __syncwarp();                     // the slot is refilled next step
  }
  cp_async_wait<0>();

  // sum the lane groups' accumulators (positions pl, pl + PL, ...)
#pragma unroll
  for (int m = LD; m < 32; m <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
        float4& o = acc[r][u];
        o.x += __shfl_xor_sync(FULL, o.x, m);
        o.y += __shfl_xor_sync(FULL, o.y, m);
        o.z += __shfl_xor_sync(FULL, o.z, m);
        o.w += __shfl_xor_sync(FULL, o.w, m);
      }
    }
  }

  // merge the four warps' triples in warp order, through shared memory
  __syncthreads();                    // every warp is done with its ring
  float* wacc = reinterpret_cast<float*>(smem);   // [warps][R][D]
  float* wml = wacc + DEC_WARPS * R * D;          // [warps][R][2]
  if (pl == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int u = 0; u < VPL; ++u)
        *reinterpret_cast<float4*>(wacc + (warp * R + r) * D + 4 * ld +
                                   4 * LD * u) = acc[r][u];
  }
  if (lane < R) {
    wml[(warp * R + lane) * 2] = m_run;
    wml[(warp * R + lane) * 2 + 1] = l_run;
  }
  __syncthreads();
  const bool whole = a.splits == 1;
  for (int i = tid; i < n_rows * D; i += DEC_THREADS) {
    const int r = i / D, d = i % D;
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w)
      m_all = fmaxf(m_all, wml[(w * R + r) * 2]);
    const float m_safe = isfinite(m_all) ? m_all : 0.0f;
    float l_all = 0.0f, o = 0.0f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float m = wml[(w * R + r) * 2];
      if (isfinite(m)) {
        const float e = expf(m - m_safe);
        l_all = fmaf(wml[(w * R + r) * 2 + 1], e, l_all);
        o = fmaf(wacc[(w * R + r) * D + d], e, o);
      }
    }
    if (whole) {
      a.out[row_base + (size_t)r * D + d] = o / (l_all == 0.0f ? 1.0f : l_all);
    } else {
      const size_t pr = ((size_t)bh * a.splits + split) * n_rows + r;
      a.part_acc[pr * D + d] = o;
      if (d == 0) {
        a.part_ml[pr * 2] = m_all;
        a.part_ml[pr * 2 + 1] = l_all;
      }
    }
  }
}

// ---- chunk instance ---------------------------------------------------------

// Chunk splits: split s takes stages [s * per, (s + 1) * per) of the
// sequence, per = ch_split_stages(RM, S) doubled until CH_MAX_SPLITS
// splits cover the sequence's stages: 3 x 64 = 192 positions a split at
// 128-row tiles, 128 at 64-row ones (2 stages of 64, or 4 of 32 at D =
// 256).  kernels/paged_attention/ops.py sizes the grid with the same
// constants, for the longest sequence the table holds.
constexpr int CH_MAX_SPLITS = 16;
__host__ __device__ constexpr int ch_split_stages(int rm, int s) {
  return (rm == 8 ? 3 : 2) * 64 / s;
}

template <typename T, int D, int RM>
struct ChunkLayout {
  static constexpr int E = sizeof(T);
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kCodes = std::is_same<T, int8_t>::value;
  static constexpr int RT = 16 * RM;                 // rows per block
  static constexpr int S = ch_positions<D>();        // positions a stage
  static constexpr int ROWB = D * E;
  static constexpr int PT = RT + 4;                  // padded P row
  // shared memory, bytes: Qc [D/4][RT][4] | ring | (Kc, Vc) | Pt | table
  static constexpr int Q_OFF = 0;
  static constexpr int RING_OFF = Q_OFF + RT * D * 4;
  static constexpr int SLOT_K = 0;                   // f32: Kc layout
  static constexpr int SLOT_V = S * ROWB;
  static constexpr int SLOT_KS = 2 * S * ROWB;
  static constexpr int SLOT_VS = SLOT_KS + S * 4;
  static constexpr int SLOT_OK = SLOT_KS + (kCodes ? 2 * S * 4 : 0);
  static constexpr int SLOT = SLOT_OK + S * 4;
  static constexpr int KC_OFF = RING_OFF + CH_STAGES * SLOT;
  static constexpr int VC_OFF = KC_OFF + (kF32 ? 0 : S * D * 4);
  static constexpr int PT_OFF = VC_OFF + (kF32 ? 0 : S * D * 4);
  static constexpr int TAB_OFF = PT_OFF + S * PT * 4;
  static constexpr int SMEM = TAB_OFF + (kCodes ? TABLE * 4 : 0);
};

template <typename T, int D, int RM>
__global__ void __launch_bounds__(CH_THREADS, 1)
paged_attention_kernel_chunk(Args a) {
  using L = ChunkLayout<T, D, RM>;
  constexpr int RT = L::RT, DQ = D / 4, S = L::S;
  constexpr int NC = S / 16;          // positions a thread scores a stage
  constexpr int CPR = L::ROWB / 16;
  constexpr int VW = D / 16 >= 4 ? 4 : D / 16;  // P@V: dims per vector
  constexpr int NV = D / (16 * VW);             // vectors per thread
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, rg = tid >> 4, pg = tid & 15;
  const int bh = blockIdx.x, b = bh / a.Hkv, h = bh % a.Hkv;
  const int G = a.Hq / a.Hkv, Q = a.Q, n_rows = G * Q;
  const int tile = blockIdx.y, r0 = tile * RT;
  const int rows_here = min(RT, n_rows - r0);
  const int split = blockIdx.z;
  const int len = __ldg(a.lengths + b);
  const int limit = len + Q - 1;
  const int nst = (limit + S - 1) / S;
  // per doubles until at most min(CH_MAX_SPLITS, grid splits) splits cover
  // the sequence: ops.plan's grid holds the capped count for any length
  // the table takes, so only a narrower grid (the tests force one)
  // doubles it further
  const int most = min(CH_MAX_SPLITS, a.splits);
  int per = ch_split_stages(RM, S);
  while ((nst + per - 1) / per > most) per *= 2;
  const int nsp = (nst + per - 1) / per;            // busy splits
  if (split == 0 && h == 0 && tile == 0 && tid == 0 && a.splits > 1)
    a.busy[b] = nsp;
  if (split >= nsp) return;           // not a busy split
  const size_t prow = ((size_t)bh * a.splits + split) * n_rows;
  const int s0 = split * per, s1 = min(s0 + per, nst);

  float* qc = reinterpret_cast<float*>(smem + L::Q_OFF);
  float* pt = reinterpret_cast<float*>(smem + L::PT_OFF);
  float* tab = reinterpret_cast<float*>(smem + L::TAB_OFF);
  const unsigned char* kpool = static_cast<const unsigned char*>(a.k);
  const unsigned char* vpool = static_cast<const unsigned char*>(a.v);

  // stage t: positions t*S .. t*S + S into ring slot `slot_i`; a thread
  // looks up the rows of its pieces first (`lookup`, the block-table reads
  // in flight together), and issues the copies later (`issue`)
  constexpr int PIECES = S * CPR;
  constexpr int ITERS = (PIECES + CH_THREADS - 1) / CH_THREADS;
  int rows[ITERS];
  auto lookup = [&](int t) {
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int i = tid + CH_THREADS * k;
      rows[k] = i < PIECES ? row_of(a, b, h, t * S + i / CPR, limit) : -1;
    }
  };
  auto issue = [&](int slot_i) {
    unsigned char* slot = smem + L::RING_OFF + slot_i * L::SLOT;
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int i = tid + CH_THREADS * k;
      if (i >= PIECES) continue;
      const int p = i / CPR, piece = i % CPR;
      const bool ok = rows[k] >= 0;
      const size_t off = ok ? (size_t)rows[k] * L::ROWB + piece * 16 : 0;
      // f32 K lands d-quad major ([D/4][S][4]); the rest as rows
      const int kdst = L::kF32 ? (piece * S + p) * 16 : p * L::ROWB + piece * 16;
      cp_async16(slot + L::SLOT_K + kdst, kpool + off, ok);
      cp_async16(slot + L::SLOT_V + p * L::ROWB + piece * 16, vpool + off, ok);
      if (piece == 0) {
        reinterpret_cast<int*>(slot + L::SLOT_OK)[p] = ok;
        if constexpr (L::kCodes) {
          cp_async4(slot + L::SLOT_KS + p * 4, a.k_scale + (ok ? rows[k] : 0),
                    ok);
          cp_async4(slot + L::SLOT_VS + p * 4, a.v_scale + (ok ? rows[k] : 0),
                    ok);
        }
      }
    }
    cp_async_commit();
  };

  if (s0 < s1) {
    lookup(s0);
    issue(0);
  }
  // the row tile's queries, d-quad major: qc[(dq * RT + r) * 4 ..]
  const size_t row_base = ((size_t)b * a.Hq + (size_t)h * G) * Q * D;
  for (int i = tid; i < RT * DQ; i += CH_THREADS) {
    const int r = i / DQ, dq = i % DQ;
    const float4 v = r < rows_here
                         ? *reinterpret_cast<const float4*>(
                               a.q + row_base + (size_t)(r0 + r) * D + 4 * dq)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(qc + (dq * RT + r) * 4) = v;
  }
  if constexpr (L::kCodes) {
    for (int i = tid; i < TABLE; i += CH_THREADS) tab[i] = a.table[i];
  }

  int lim[RM];                        // row attends positions < lim
  float m_run[RM], l_run[RM];
  float acc[RM][NV * VW];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + rg * RM + i;
    lim[i] = r < n_rows ? len + r % Q : 0;
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < NV * VW; ++e) acc[i][e] = 0.0f;
  }

  for (int t = s0; t < s1; ++t) {
    const int slot_i = (t - s0) % CH_STAGES;
    const bool next = t + 1 < s1;
    cp_async_wait<0>();
    __syncthreads();                  // stage t visible; stage t-1 done
    if (next) lookup(t + 1);
    const unsigned char* slot = smem + L::RING_OFF + slot_i * L::SLOT;
    const int* okp = reinterpret_cast<const int*>(slot + L::SLOT_OK);
    const float* kc;
    const float* vc;
    if constexpr (L::kF32) {
      kc = reinterpret_cast<const float*>(slot + L::SLOT_K);
      vc = reinterpret_cast<const float*>(slot + L::SLOT_V);
    } else {
      float* kw = reinterpret_cast<float*>(smem + L::KC_OFF);
      float* vw = reinterpret_cast<float*>(smem + L::VC_OFF);
      const float* ksc = reinterpret_cast<const float*>(slot + L::SLOT_KS);
      const float* vsc = reinterpret_cast<const float*>(slot + L::SLOT_VS);
      for (int i = tid; i < S * DQ; i += CH_THREADS) {
        const int p = i / DQ, dq = i % DQ;
        const unsigned char* kr = slot + L::SLOT_K + p * L::ROWB;
        const unsigned char* vr = slot + L::SLOT_V + p * L::ROWB;
        *reinterpret_cast<float4*>(kw + (dq * S + p) * 4) =
            load4<T>(kr, 4 * dq, tab, L::kCodes ? ksc[p] : 1.0f);
        *reinterpret_cast<float4*>(vw + p * D + 4 * dq) =
            load4<T>(vr, 4 * dq, tab, L::kCodes ? vsc[p] : 1.0f);
      }
      __syncthreads();
      kc = kw;
      vc = vw;
    }

    // Q.K^T: rows rg*RM + i x positions pg + 16c
    float s[RM][NC];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) s[i][c] = 0.0f;
#pragma unroll 2
    for (int dq = 0; dq < DQ; ++dq) {
      float4 kf[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        kf[c] = *reinterpret_cast<const float4*>(kc + (dq * S + pg + 16 * c) * 4);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 qf =
            *reinterpret_cast<const float4*>(qc + (dq * RT + rg * RM + i) * 4);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          s[i][c] = fmaf(qf.x, kf[c].x, s[i][c]);
          s[i][c] = fmaf(qf.y, kf[c].y, s[i][c]);
          s[i][c] = fmaf(qf.z, kf[c].z, s[i][c]);
          s[i][c] = fmaf(qf.w, kf[c].w, s[i][c]);
        }
      }
    }

    if (next) issue(slot_i ^ 1);      // lands while this stage finishes

    // online softmax over the 16 lanes (pg) that share a row group
    bool okc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) okc[c] = okp[pg + 16 * c] != 0;
    float corr[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        s[i][c] = okc[c] && t * S + pg + 16 * c < lim[i]
                      ? s[i][c] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int m = 1; m < 16; m <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, m));
      const float m_new = fmaxf(m_run[i], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        s[i][c] = expf(s[i][c] - m_safe);              // -inf -> 0
        sum += s[i][c];
      }
#pragma unroll
      for (int m = 1; m < 16; m <<= 1) sum += __shfl_xor_sync(FULL, sum, m);
      corr[i] = isfinite(m_run[i]) ? expf(m_run[i] - m_safe) : 0.0f;
      l_run[i] = l_run[i] * corr[i] + sum;
      m_run[i] = m_new;
    }
    // P^T tile: pt[p * PT + row], written and read by this half-warp only
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int i4 = 0; i4 < RM / 4; ++i4)
        *reinterpret_cast<float4*>(pt + (pg + 16 * c) * L::PT + rg * RM + 4 * i4) =
            make_float4(s[4 * i4][c], s[4 * i4 + 1][c], s[4 * i4 + 2][c],
                        s[4 * i4 + 3][c]);
    }
    __syncwarp();

    // P @ V: rows rg*RM + i, dims n*16*VW + pg*VW + u
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int e = 0; e < NV * VW; ++e) acc[i][e] *= corr[i];
#pragma unroll 4
    for (int p = 0; p < S; ++p) {
      float vv[NV * VW];
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        const float* src = vc + p * D + n * 16 * VW + pg * VW;
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          vv[4 * n] = x.x; vv[4 * n + 1] = x.y;
          vv[4 * n + 2] = x.z; vv[4 * n + 3] = x.w;
        } else if constexpr (VW == 2) {
          const float2 x = *reinterpret_cast<const float2*>(src);
          vv[2 * n] = x.x; vv[2 * n + 1] = x.y;
        } else {
          vv[n] = src[0];
        }
      }
#pragma unroll
      for (int i4 = 0; i4 < RM / 4; ++i4) {
        const float4 pr =
            *reinterpret_cast<const float4*>(pt + p * L::PT + rg * RM + 4 * i4);
        const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < NV * VW; ++e)
            acc[4 * i4 + u][e] = fmaf(pv[u], vv[e], acc[4 * i4 + u][e]);
      }
    }
  }
  cp_async_wait<0>();

  const bool whole = a.splits == 1;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int rl = rg * RM + i;
    if (rl >= rows_here) continue;
    const int r = r0 + rl;
    const float l = l_run[i] == 0.0f ? 1.0f : l_run[i];
    const size_t pr = prow + r;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
#pragma unroll
      for (int u = 0; u < VW; ++u) {
        const int d = n * 16 * VW + pg * VW + u;
        if (whole)
          a.out[row_base + (size_t)r * D + d] = acc[i][n * VW + u] / l;
        else
          a.part_acc[pr * D + d] = acc[i][n * VW + u];
      }
    }
    if (!whole && pg == 0) {
      a.part_ml[pr * 2] = m_run[i];
      a.part_ml[pr * 2 + 1] = l_run[i];
    }
  }
}

// ---- launch -----------------------------------------------------------------

// Launch one kernel instance, allowing it `smem` bytes of dynamic shared
// memory first (once per instance: `done`).
template <typename K>
int launch_one(K kernel, dim3 grid, int threads, int smem, bool& done,
               const Args& a, cudaStream_t stream) {
  if (!done && smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  done = true;
  kernel<<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Whether head dim D has the 16-row decode and 128-row chunk instances:
// not at D = 256 (see the header note), where only rows 8 and 64 exist.
template <int D>
__host__ __device__ constexpr bool wide_tiles() {
  return D <= 128;
}

template <typename T, int D>
int launch_rows(const Args& a, int B, int rows, cudaStream_t stream) {
  const int n_rows = (a.Hq / a.Hkv) * a.Q;
  const dim3 grid(B * a.Hkv, (n_rows + rows - 1) / rows, a.splits);
  static bool done[4] = {};           // rows 8, 16, 64, 128
  int err = (int)cudaErrorInvalidValue;
  switch (rows) {
    case 8:
      err = launch_one(paged_attention_kernel_decode<T, D, 8>, grid,
                       DEC_THREADS, DecodeLayout<T, D, 8>::SMEM, done[0], a,
                       stream);
      break;
    case 16:
      if constexpr (wide_tiles<D>())
        err = launch_one(paged_attention_kernel_decode<T, D, 16>, grid,
                         DEC_THREADS, DecodeLayout<T, D, 16>::SMEM, done[1],
                         a, stream);
      else
        return err;
      break;
    case 64:
      err = launch_one(paged_attention_kernel_chunk<T, D, 4>, grid,
                       CH_THREADS, ChunkLayout<T, D, 4>::SMEM, done[2], a,
                       stream);
      break;
    case 128:
      if constexpr (wide_tiles<D>())
        err = launch_one(paged_attention_kernel_chunk<T, D, 8>, grid,
                         CH_THREADS, ChunkLayout<T, D, 8>::SMEM, done[3], a,
                         stream);
      else
        return err;
      break;
    default:
      return err;
  }
  if (err || a.splits == 1) return err;
  paged_attention_kernel_combine<<<dim3(B * a.Hkv, n_rows), 128, 0, stream>>>(
      a, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, int B, int D, int rows, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_rows<T, 16>(a, B, rows, stream);
    case 32: return launch_rows<T, 32>(a, B, rows, stream);
    case 64: return launch_rows<T, 64>(a, B, rows, stream);
    case 128: return launch_rows<T, 128>(a, B, rows, stream);
    case 256: return launch_rows<T, 256>(a, B, rows, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
size_t smem_of(int rows, int D) {
#define SMEM_D(DV)                                                         \
  if (D == DV) {                                                           \
    if (rows == 8) return DecodeLayout<T, DV, 8>::SMEM;                    \
    if (rows == 16) return DecodeLayout<T, DV, 16>::SMEM;                  \
    if (rows == 64) return ChunkLayout<T, DV, 4>::SMEM;                    \
    if (rows == 128) return ChunkLayout<T, DV, 8>::SMEM;                   \
  }
  SMEM_D(16)
  SMEM_D(32)
  SMEM_D(64)
  SMEM_D(128)
#undef SMEM_D
  if (D == 256) {
    if (rows == 8) return DecodeLayout<T, 256, 8>::SMEM;
    if (rows == 64) return ChunkLayout<T, 256, 4>::SMEM;
  }
  return 0;
}

}  // namespace

extern "C" {

// Shared memory one block of the instance with `rows` query rows (8 or 16:
// decode; 64 or 128: chunk) needs for head dim D and pool kind (0 f32,
// 1 bf16, 2 int8 codes); 0 for a combination that does not exist.  The
// wrapper's plan computes the same and checks it against the card.
size_t paged_attention_smem_bytes(int rows, int D, int kv_kind) {
  if (kv_kind == 2) return smem_of<int8_t>(rows, D);
  if (kv_kind == 1) return smem_of<__nv_bfloat16>(rows, D);
  return smem_of<float>(rows, D);
}

// kv_kind: 0 = float32 pools, 1 = bfloat16 pools, 2 = int8 code pools with
// k_scale/v_scale (P, Hkv, ps) floats and the 256-entry decode table
// (unused, and may be null, for fp pools); D in {16, 32, 64, 128, 256};
// rows picks the instance (8 or 16: decode, 64 or 128: chunk; 8 or 64 at
// D = 256); the grid has
// `splits` splits of the position axis per (sequence, KV head, row tile)
// (chunk: at least the busy splits of the longest sequence the table can
// hold, as ops.plan computes them); the pools' pointers are 16-byte
// aligned.  With splits > 1,
// part_acc/part_ml/busy are scratch of (B*Hkv, splits, G*Q, D) and
// (B*Hkv, splits, G*Q, 2) floats and (B,) ints, merged by a second launch.
// Returns the cudaError_t of the launches.
int paged_attention_launch(const float* q, const void* k_pages,
                           const void* v_pages, int kv_kind,
                           const float* k_scale, const float* v_scale,
                           const float* table, const int* bt,
                           const int* lengths, float* out, float* part_acc,
                           float* part_ml, int* busy, int B, int Hq,
                           int Hkv, int Q, int D, int P, int ps, int NB,
                           int rows, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{q, k_pages, v_pages, k_scale, v_scale, table, bt, lengths, out,
         splits > 1 ? part_acc : nullptr, splits > 1 ? part_ml : nullptr,
         splits > 1 ? busy : nullptr, Hq, Hkv, Q, P, ps, NB, splits,
         1.0f / sqrtf((float)D)};
  if (kv_kind == 2) return launch_d<int8_t>(a, B, D, rows, s);
  if (kv_kind == 1) return launch_d<__nv_bfloat16>(a, B, D, rows, s);
  return launch_d<float>(a, B, D, rows, s);
}

}  // extern "C"
