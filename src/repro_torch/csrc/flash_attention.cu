// Causal GQA flash attention: online softmax over streamed K/V tiles, both
// products on the tensor cores in split TF32.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_kernel (pallas_call at :87; body _flash_kernel at :30);
//   in serving, the lax twin repro/nn/attention.py blockwise_attention,
//   which the OFF whole-prompt prefill runs.
//
// Computes, for q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D), all float32 or all
// bfloat16 (read as they are; strided over batch, head and position, D
// contiguous), G = Hq/Hkv:
//   out[b, h*G+g, i] = softmax_j(q_i . k_j * scale) @ v over the keys
//   j <= i + Lk - Lq (causal; queries sit at the end of the KV axis) or
//   all keys (not causal), K/V read at head h, written contiguous in q's
//   dtype.  A row with no visible key gives 0.  `scale` is 1/sqrt(D) as
//   the caller rounds it; q is scaled (rounded, never fused) before the
//   dot products, as the reference scales it.
//
// What bounds it on an H100: operations.  Each (row, key) pair costs 4*D
// FLOPs against K/V bytes that serve a whole row tile.  In f32 FMAs (67
// TFLOP/s) that is 0.128 ms at the lockstep prefill's (8, 16/2, 512, 128);
// in split TF32 on the tensor cores (495 TFLOP/s dense, three products
// for f32 operands, two where K/V are bf16) 0.052 ms (bf16: 0.035).  The
// design (attn_tiles.cuh, shared with kernel C): one block of eight warps
// per (sequence, KV head, 128 rows); each warp keeps its 16 rows' scaled
// queries in shared memory and its scores, softmax state and P @ V
// accumulators in mma fragments, so the online softmax is quad shuffles
// and P feeds P @ V from registers; K/V tiles (32 keys in f32, 64 in
// bf16) stream through a two-stage cp.async ring, one barrier a tile;
// causal tiles past a warp's last position are skipped (they would add
// exactly nothing).  f32 softmax with expf (no fast math).  Measured on an
// H100 (tools/compare_attn_kernels.py and variants of this source with a
// part cut out): the time follows the count of mma.sync TF32 products —
// f32 operands take 1.7x the bf16 time for 1.5x the products — and moves
// by under 4% with the ring's depth, the key tile's depth or four warps in
// place of eight; mma.sync issues m16n8k8 TF32 at well under the 495
// TFLOP/s that wgmma reaches, the lever left.
//
// Head dim 256 (PaliGemma, RecurrentGemma): the layout above needs 265 KB
// of shared memory at f32 (the ring 133 KB, 128 scaled q rows of 258
// floats 132 KB) and 273 KB at bf16, over the 227 KB a block may have.
// The D 256 instance keeps the layout and halves the block: four warps,
// 64 rows (f32 194.5 KB, bf16 202.5 KB).  Each warp's P @ V accumulators
// are then 128 registers a lane, which the one-block-an-SM launch bound
// leaves room for.  Splitting the output's D over warp pairs would keep
// 128 rows a block but score every (row, key) twice; q held in registers
// would not fit beside the accumulators.  The ring, the tiles and the sum
// order are those of the other head dims.

#include "attn_tiles.cuh"

namespace {

using namespace attn_tiles;

// warps a block: eight, four at head dim 256 (see the note above)
template <int D>
struct Block {
  static constexpr int WARPS = D > 128 ? 4 : 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int ROWS = WARP_ROWS * WARPS;
};

template <typename T, int D>
struct Layout {
  static constexpr int ROWS = Block<D>::ROWS;
  static constexpr int BK = sizeof(T) == 4 ? 32 : 64;   // keys a tile
  static constexpr int PK = Pitch<T, D>::K;
  static constexpr int PV = Pitch<T, D>::V;
  static constexpr int QP = D + 2;          // q rows: float2 reads, no conflicts
  static constexpr size_t K_BYTES = (size_t)BK * PK * sizeof(T);
  static constexpr size_t STAGE = K_BYTES + (size_t)BK * PV * sizeof(T);
  static constexpr size_t Q_BYTES = (size_t)ROWS * QP * sizeof(float);
  static constexpr size_t BYTES = STAGES * STAGE + Q_BYTES;
};

template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  void* out;
  Strides sq, sk, sv;
  int Hq, Hkv, Lq, Lk, causal;
  float scale;
};

// The warp's 16 rows of q, times `scale` (rounded), into its shared-memory
// rows; rows past the tile's end are 0.
template <typename T, int D>
__device__ __forceinline__ void load_q(float* qs, const Args<T>& a,
                                       const Tile& t, int warp, int lane) {
  constexpr int QP = Layout<T, D>::QP;
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CH = D / EPC;
  for (int idx = lane; idx < WARP_ROWS * CH; idx += 32) {
    const int r = idx / CH;
    const int c = idx % CH;
    const int row = warp * WARP_ROWS + r;
    float x[EPC];
    if (row < t.rows_here) {
      load_vec<T, EPC>(x, a.q + t.q_offset(row, a.sq) + c * EPC);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) x[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < EPC; e += 2)
      *reinterpret_cast<float2*>(qs + r * QP + c * EPC + e) =
          make_float2(__fmul_rn(x[e], a.scale), __fmul_rn(x[e + 1], a.scale));
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Block<D>::THREADS, 1)
flash_attention_kernel(const Args<T> a) {
  using L = Layout<T, D>;
  using Gr = Groups<D>;
  constexpr int NB = L::BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t(a.Hq, a.Hkv, a.Lq, a.Lk, a.causal, L::ROWS);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const T* kb = a.k + t.b * a.sk.b + t.h * a.sk.h;
  const T* vb = a.v + t.b * a.sv.b + t.h * a.sv.h;
  const int n_tiles = (t.n_keys + L::BK - 1) / L::BK;

  auto issue = [&](int it) {
    T* st = reinterpret_cast<T*>(smem + (it & 1) * L::STAGE);
    issue_rows<T, D>(st, L::PK, kb, a.sk.l, it * L::BK, L::BK, t.Lk);
    issue_rows<T, D>(st + L::K_BYTES / sizeof(T), L::PV, vb, a.sv.l,
                     it * L::BK, L::BK, t.Lk);
  };
  if (n_tiles > 0) issue(0);
  cp_async_commit();

  float* qs = reinterpret_cast<float*>(smem + STAGES * L::STAGE) +
              warp * WARP_ROWS * L::QP;
  load_q<T, D>(qs, a, t, warp, lane);
  __syncwarp();
  auto qfrag = [&](int ks, float (&f)[4]) {
    const int d = Gr::GW * (ks / Gr::KPG) + Gr::PER * tq + 2 * (ks % Gr::KPG);
    const float2 x = *reinterpret_cast<const float2*>(qs + g * L::QP + d);
    const float2 y = *reinterpret_cast<const float2*>(qs + (g + 8) * L::QP + d);
    f[0] = x.x;
    f[1] = y.x;
    f[2] = x.y;
    f[3] = y.y;
  };

  const WarpRows w(t, warp, g);
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();                        // tile it landed; it-1 consumed
    if (it + 1 < n_tiles) issue(it + 1);
    cp_async_commit();
    const int j0 = it * L::BK;
    if (j0 >= w.n_keys) continue;           // nothing of it visible here
    const T* st = reinterpret_cast<const T*>(smem + (it & 1) * L::STAGE);

    float s[NB][4];
    score_tile<T, D, NB>(s, st, qfrag, g, tq);
    mask_tile<NB>(s, t, w, j0, tq);

#pragma unroll
    for (int i = 0; i < 2; ++i) {           // online softmax, rows g, g+8
      float mx = -INFINITY;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        mx = fmaxf(mx, fmaxf(s[nb][2 * i], s[nb][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.0f;
      float sum = 0.0f;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[nb][2 * i + e] - m_safe);   // -inf -> 0
          s[nb][2 * i + e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      const float corr = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.0f;
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][2 * i] *= corr;
        o[n][2 * i + 1] *= corr;
      }
    }

    const T* vs = st + L::K_BYTES / sizeof(T);
#pragma unroll
    for (int ks = 0; ks < NB; ++ks) {       // P @ V, P from the fragments
      const FragA p = split_a(s[ks][0], s[ks][2], s[ks][1], s[ks][3]);
      pv_step<T, D>(o, p, vs + (ks * 8 + 2 * tq) * L::PV, g);
    }
  }
  cp_async_wait_all();

  const bool bf16 = !std::is_same<T, float>::value;
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (w.ok[i])
      store_row<D>(a.out, bf16, t.out_offset(w.row[i], D), o, i,
                   1.0f / (l[i] == 0.0f ? 1.0f : l[i]), tq);
}

template <typename T, int D>
int launch(const Args<T>& a, int B, cudaStream_t stream) {
  const size_t smem = Layout<T, D>::BYTES;
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rows = (a.Hq / a.Hkv) * a.Lq;
  dim3 grid(B * a.Hkv, (n_rows + Block<D>::ROWS - 1) / Block<D>::ROWS);
  kernel<<<grid, Block<D>::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 int B, int Hq, int Hkv, int Lq, int Lk, int D, int causal,
                 float scale, const long long* strides, cudaStream_t st) {
  Args<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.out = out;
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Lq = Lq;
  a.Lk = Lk;
  a.causal = causal;
  a.scale = scale;
  return dispatch_head_dim(D, [&](auto dim) {
    return launch<T, decltype(dim)::value>(a, B, st);
  });
}

}  // namespace

extern "C" {

// q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D): all float32 (bf16 = 0) or all
// bfloat16 (bf16 = 1), D contiguous, strides (batch, head, position) in
// elements in `strides` (q, k, v: 9 values), every row 16-byte aligned;
// out (B, Hq, Lq, D) contiguous in the same dtype; D in {16, 32, 64, 128,
// 256}.
// Returns the cudaError_t of the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int bf16, int B, int Hq, int Hkv,
                           int Lq, int Lk, int D, int causal, float scale,
                           const long long* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_typed<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Lq, Lk, D,
                                       causal, scale, strides, st);
  return launch_typed<float>(q, k, v, out, B, Hq, Hkv, Lq, Lk, D, causal,
                             scale, strides, st);
}

// Dynamic shared memory of one block for element size `elem_bytes` (4 or
// 2) and head dim D; 0 for a D the kernel does not take.
size_t flash_attention_smem_bytes(int elem_bytes, int D) {
  if (D != 16 && D != 32 && D != 64 && D != 128 && D != 256) return 0;
  return (size_t)dispatch_head_dim(D, [&](auto dim) {
    constexpr int kD = decltype(dim)::value;
    return (int)(elem_bytes == 2 ? Layout<__nv_bfloat16, kD>::BYTES
                                 : Layout<float, kD>::BYTES);
  });
}

}  // extern "C"
