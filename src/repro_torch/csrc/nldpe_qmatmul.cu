// Log-domain DMMul over 8-bit ACAM codes (paper Eq 3), the fused mode.
//
// Replaces: src/repro/kernels/nldpe_qmatmul/kernel.py, nldpe_qmatmul_kernel
//   (pallas_call at :61; body _qmm_kernel at :30).
//
// Computes, for A (M, K) and B (K, N) in the analog engine's wire format —
// centered int8 codes (code - 128) and int8 signs in {-1, 0, +1} — and the
// log grid's step and floor log_lo:
//   A^ = sign * exp((code + 128) * step + log_lo), B^ likewise,
//   C  = A^ @ B^                                   (f32 accumulation).
// The multiply-add before exp is one fused rounding (__fmaf_rn), as XLA
// contracts the reference kernel's `code * step + log_lo` under jit; exp is
// the accurate expf (no fast math).
//
// What bounds it on an H100: f32 operations at the shapes that matter
// (2*M*K*N; 34.4 GFLOP at 4096 x 2048 x 2048, 0.513 ms at 67 TFLOP/s); the
// int8 operands are 2 bytes per element.  The design is the pipelined
// main loop of xbar_tiles.cuh with the int8 operands: the raw code and
// sign tiles stream in through cp.async, each K step dequantizes them
// once into the compute tile (one expf per staged element), and the
// register tiles accumulate with IEEE fmaf.  The tile is chosen from the
// shape: 128 x 128 where that gives every SM a block (the large product),
// 64 x 64 for the small products of one head.  Ragged M/N/K edges are
// zero-filled in shared memory (sign 0), where the TPU wrapper pads.

#include "xbar_tiles.cuh"

namespace {

using namespace xbar;

__device__ __forceinline__ float dequant(int8_t code, int8_t sign,
                                         float step, float log_lo) {
  const float c = (float)((int)code + 128);
  return (float)sign * expf(__fmaf_rn(c, step, log_lo));
}

// A (M, K) and B (K, N) as int8 codes and signs, staged raw.
template <class T>
struct CodesOp {
  static constexpr int A_BYTES = T::BM * T::BK;
  static constexpr int B_BYTES = T::BK * T::BN;
  static constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
  const int8_t* a_code;
  const int8_t* a_sign;
  const int8_t* b_code;
  const int8_t* b_sign;
  int M, N, K;
  float step, log_lo;
  bool a_vec, b_vec;

  __device__ __forceinline__ void load(unsigned char* stage, int k0, int m0,
                                       int n0) const {
    int8_t* s = reinterpret_cast<int8_t*>(stage);
    copy_tile<int8_t, T::BM, T::BK, T::BK, T::THREADS>(s, a_code, M, K, m0,
                                                       k0, a_vec);
    copy_tile<int8_t, T::BM, T::BK, T::BK, T::THREADS>(s + A_BYTES, a_sign,
                                                       M, K, m0, k0, a_vec);
    copy_tile<int8_t, T::BK, T::BN, T::BN, T::THREADS>(
        s + 2 * A_BYTES, b_code, K, N, k0, n0, b_vec);
    copy_tile<int8_t, T::BK, T::BN, T::BN, T::THREADS>(
        s + 2 * A_BYTES + B_BYTES, b_sign, K, N, k0, n0, b_vec);
  }

  // Four neighbours at a time (one 4-byte load of codes, one of signs):
  // A's four k of one row, transposed; four of one row of B.
  __device__ __forceinline__ void transform(const unsigned char* stage,
                                            float* a_c, float* b_c) const {
    for_each<A_BYTES / 4, T::THREADS>([&](int i) {
      const int m = i % T::BM;
      const int k = (i / T::BM) * 4;
      const char4 c = *reinterpret_cast<const char4*>(stage + m * T::BK + k);
      const char4 g =
          *reinterpret_cast<const char4*>(stage + A_BYTES + m * T::BK + k);
      a_c[k * T::BM + m] = dequant(c.x, g.x, step, log_lo);
      a_c[(k + 1) * T::BM + m] = dequant(c.y, g.y, step, log_lo);
      a_c[(k + 2) * T::BM + m] = dequant(c.z, g.z, step, log_lo);
      a_c[(k + 3) * T::BM + m] = dequant(c.w, g.w, step, log_lo);
    });
    const char4* bc = reinterpret_cast<const char4*>(stage + 2 * A_BYTES);
    for_each<B_BYTES / 4, T::THREADS>([&](int i) {
      const char4 c = bc[i];
      const char4 g = bc[B_BYTES / 4 + i];
      reinterpret_cast<float4*>(b_c)[i] = make_float4(
          dequant(c.x, g.x, step, log_lo), dequant(c.y, g.y, step, log_lo),
          dequant(c.z, g.z, step, log_lo), dequant(c.w, g.w, step, log_lo));
    });
  }
};

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
nldpe_qmatmul_kernel(const int8_t* __restrict__ a_code,
                     const int8_t* __restrict__ a_sign,
                     const int8_t* __restrict__ b_code,
                     const int8_t* __restrict__ b_sign,
                     float* __restrict__ out, int M, int N, int K,
                     float step, float log_lo, bool a_vec, bool b_vec) {
  using Op = CodesOp<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* comp =
      reinterpret_cast<float*>(smem + ring_bytes<T>(Op::STAGE_BYTES));
  int m0, n0;
  tile_origin<T>(M, m0, n0);
  const Op op{a_code, a_sign, b_code, b_sign, M, N, K, step, log_lo, a_vec,
              b_vec};
  float acc[T::TM][T::TN];
  gemm_tile<T>(op, smem, comp, K, m0, n0, acc);
  store_tile<T>(acc, reinterpret_cast<float*>(smem), out, M, N, m0, n0,
                Identity{});
}

template <class T>
int launch(const int8_t* a_code, const int8_t* a_sign, const int8_t* b_code,
           const int8_t* b_sign, float* out, int M, int N, int K, float step,
           float log_lo, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(CodesOp<T>::STAGE_BYTES, 0);
  cudaError_t err = cudaFuncSetAttribute(
      nldpe_qmatmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool a_vec = rows_aligned16(a_code, K) && rows_aligned16(a_sign, K);
  const bool b_vec = rows_aligned16(b_code, N) && rows_aligned16(b_sign, N);
  nldpe_qmatmul_kernel<T><<<grid_blocks<T>(M, N), T::THREADS, smem,
                            stream>>>(a_code, a_sign, b_code, b_sign, out, M,
                                      N, K, step, log_lo, a_vec, b_vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile variant (xbar::Variant) a launch at (M, N) takes.
int nldpe_qmatmul_variant(int M, int N) {
  return (int)choose(M, N, sm_count());
}

// Returns the cudaError_t of the launch.
int nldpe_qmatmul_launch(const int8_t* a_code, const int8_t* a_sign,
                         const int8_t* b_code, const int8_t* b_sign,
                         float* out, int M, int N, int K, float step,
                         float log_lo, void* stream) {
  return with_tile(M, N, [&](auto tile) {
    return launch<decltype(tile)>(a_code, a_sign, b_code, b_sign, out, M, N,
                                  K, step, log_lo,
                                  static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
