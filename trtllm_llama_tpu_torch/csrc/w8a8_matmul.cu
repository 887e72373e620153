// W8A8 (int8 activation x int8 weight) matmul with the dequantizing
// epilogue, for few rows (decode / short prefill).
//
// Replaces: trtllm_llama_tpu/ops/pallas/w8a8_matmul.py::w8a8_matmul_stacked
// (and w8a8_matmul, its 2-D form, which the wrapper runs as a weight with
// one unit layer) at the rows below W8A8_GEMM_MIN_ROWS
// (ops/kernels/w8a8_matmul.py); the int8 tensor-core GEMM of
// w8a8_gemm.cu takes the rows from there on.
//
// Computes, for one layer of the stacked weight q[L, K, N] int8:
//   acc[m, n] = sum_k int32(xq[m, k]) * int32(q[k, n])     (exact in int32:
//               |acc| <= 128 * 128 * K < 2^31 for K < 131,000)
//   y[m, n]   = (float(acc) * s_x[m]) * s_w[n]             (f32, that order)
// s_x is per row (dynamic per-token) or one value (static per-tensor); s_w
// is per output channel or one value (per-tensor). Returns y as f32 [M, N].
//
// What bounds it on the H100: the weight bytes. At M <= 16 the product does
// 2*M operations per weight byte, far below the ~590 int8 operations per
// byte at which the tensor cores, not HBM (3.35 TB/s), become the limit. So
// the design streams q once and keeps the loop free of conversions:
//   - the weight is N-contiguous: each thread reads 4 K-rows x 16 columns
//     (four 16-byte loads; a warp covers 512 contiguous bytes of each row),
//     transposes every 4x4 byte block with 8 __byte_perm into one 32-bit
//     word of 4 K-values per column, and accumulates with __dp4a against
//     the activation's K-quads staged in shared memory: no int -> float
//     conversion and no float math in the loop;
//   - K is split across blocks (split-K, as in woq_matmul.cu) so even
//     N = 4096 launches ~2 blocks per SM; int32 partials add exactly, and a
//     second launch sums them in a fixed order, converts and scales.
// M larger than MR loops over row tiles inside the block, re-reading the
// block's weight tile from L2: correct at any M, but from ~16 rows on the
// dp4a rate, not HBM, binds it. Prefill rows go to the int8 wgmma GEMM
// (w8a8_gemm.cu), which shares this file's transposes and reduce
// (w8a8.cuh).
#include "w8a8.cuh"

using namespace tllm;

namespace {

constexpr int kTN = 32;              // threads along N: one warp
constexpr int kTK = 8;               // warps along K
constexpr int kVec = 16;             // int8 columns per thread (16 bytes)
constexpr int kBN = kTN * kVec;      // 512 output columns per block
constexpr int kThreads = kTN * kTK;  // 256
constexpr int kKT = 512;             // K rows of x staged per pass
constexpr int kQT = kKT / 4;         // ... as 32-bit K-quads

template <int MR>
__global__ void __launch_bounds__(kThreads)
    w8a8_partial_kernel(const int8_t* __restrict__ x,
                        const int8_t* __restrict__ q, int* __restrict__ part,
                        int M, int K, int N, int kc) {
  __shared__ int xs[MR][kQT];                 // staged K-quads of x
  __shared__ int red[MR * kVec * kTN];        // cross-warp reduction

  const int tn = threadIdx.x;
  const int tk = threadIdx.y;
  const int tid = tk * kTN + tn;
  const int n0 = blockIdx.x * kBN + tn * kVec;
  const bool n_ok = n0 < N;                   // N % 16 == 0 (wrapper)
  const int ks = blockIdx.y;
  const int k_begin = ks * kc;                // kc % 4 == 0 (wrapper)
  const int k_end = min(K, k_begin + kc);     // K % 4 == 0 (wrapper)

  for (int m0 = 0; m0 < M; m0 += MR) {
    int acc[MR][kVec];
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[r][j] = 0;

    for (int kt = k_begin; kt < k_end; kt += kKT) {
      const int nq = min(kKT, k_end - kt) / 4;
      for (int i = tid; i < MR * nq; i += kThreads) {
        const int r = i / nq;
        const int j = i - r * nq;
        const int m = m0 + r;
        xs[r][j] = m < M ? *reinterpret_cast<const int*>(
                               x + static_cast<size_t>(m) * K + kt + 4 * j)
                         : 0;
      }
      __syncthreads();
      if (n_ok) {
        const int8_t* qp = q + static_cast<size_t>(kt) * N + n0;
#pragma unroll 2
        for (int j = tk; j < nq; j += kTK) {
          const int8_t* p = qp + static_cast<size_t>(4 * j) * N;
          int4 rows[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            rows[i] = __ldg(reinterpret_cast<const int4*>(
                p + static_cast<size_t>(i) * N));
          uint32_t cols[kVec];
          w8a8::transpose4x4(rows[0].x, rows[1].x, rows[2].x, rows[3].x, cols + 0);
          w8a8::transpose4x4(rows[0].y, rows[1].y, rows[2].y, rows[3].y, cols + 4);
          w8a8::transpose4x4(rows[0].z, rows[1].z, rows[2].z, rows[3].z, cols + 8);
          w8a8::transpose4x4(rows[0].w, rows[1].w, rows[2].w, rows[3].w, cols + 12);
#pragma unroll
          for (int r = 0; r < MR; ++r) {
            const int xv = xs[r][j];
#pragma unroll
            for (int c = 0; c < kVec; ++c)
              acc[r][c] = __dp4a(static_cast<int>(cols[c]), xv, acc[r][c]);
          }
        }
      }
      __syncthreads();  // xs is restaged by the next pass
    }

    // Sum the kTK warps' accumulators (int32: exact in any order).
    for (int w = 0; w < kTK; ++w) {
      if (tk == w) {
#pragma unroll
        for (int r = 0; r < MR; ++r)
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            int* p = &red[(r * kVec + j) * kTN + tn];
            *p = (w == 0 ? 0 : *p) + acc[r][j];
          }
      }
      __syncthreads();
    }
    for (int i = tid; i < MR * kBN; i += kThreads) {
      const int r = i / kBN;
      const int c = i - r * kBN;
      const int m = m0 + r;
      const int n = blockIdx.x * kBN + c;
      if (m < M && n < N)
        part[(static_cast<size_t>(ks) * M + m) * N + n] =
            red[(r * kVec + (c % kVec)) * kTN + c / kVec];
    }
    __syncthreads();  // red is reused by the next row tile
  }
}

template <int MR>
cudaError_t launch(const void* x, const void* q, const void* sx, int sx_step,
                   const void* sw, int sw_step, void* out, void* part, int M,
                   int K, int N, int ksplit, int kc, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, ksplit);
  const dim3 block(kTN, kTK);
  w8a8_partial_kernel<MR><<<grid, block, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(q),
      static_cast<int*>(part), M, K, N, kc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return w8a8::launch_reduce(part, sx, sx_step, sw, sw_step, out, M, N,
                             ksplit, stream);
}

}  // namespace

// x [M, K] int8, q [K, N] int8 of ONE layer and sw its scales (the wrapper
// offsets the stacked arrays); sx [M] (sx_step 1) or [1] (sx_step 0), sw [N]
// (sw_step 1) or [1] (sw_step 0); out [M, N] f32; part [ksplit, M, N] int32
// scratch. K % 4 == 0, kc % 4 == 0, N % 16 == 0; mr in {1, 2, 4, 8}: rows
// per register tile.
extern "C" int tllm_w8a8_matmul_stacked(const void* x, const void* q,
                                        const void* sx, int sx_step,
                                        const void* sw, int sw_step, void* out,
                                        void* part, int M, int K, int N,
                                        int ksplit, int kc, int mr, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mr) {
    case 1:
      return launch<1>(x, q, sx, sx_step, sw, sw_step, out, part, M, K, N, ksplit, kc, s);
    case 2:
      return launch<2>(x, q, sx, sx_step, sw, sw_step, out, part, M, K, N, ksplit, kc, s);
    case 4:
      return launch<4>(x, q, sx, sx_step, sw, sw_step, out, part, M, K, N, ksplit, kc, s);
    case 8:
      return launch<8>(x, q, sx, sx_step, sw, sw_step, out, part, M, K, N, ksplit, kc, s);
    default:
      return cudaErrorInvalidValue;
  }
}
