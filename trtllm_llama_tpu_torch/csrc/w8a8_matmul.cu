// W8A8 (int8 activation x int8 weight) matmul with the dequantizing
// epilogue, for few rows (decode / short prefill): one launch.
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
// What bounds it on the H100: the weight bytes. At M <= 4 the product does
// 2 to 8 operations per weight byte, far below the ~590 int8 operations per
// byte at which the tensor cores, not HBM (3.35 TB/s), become the limit. So
// the design streams q once, in one launch, on gemv_stream.cuh's stream
// (the column tile, the register ring issued before x is staged, the
// one-pass block sum, the K splits merged by the last block of a column
// tile, in split order), and keeps the loop free of conversions:
//   - the weight is N-contiguous: a thread's step is 4 K-rows x 16 columns
//     (four 16-byte loads of 4 consecutive stored rows); it transposes every
//     4x4 byte block with 8 __byte_perm into one 32-bit word of 4 K-values
//     per column and accumulates with __dp4a against the activation's
//     K-quads staged in shared memory: no int -> float conversion and no
//     float math in the loop; 2 steps (8 loads, 32 KB a block at one row)
//     stay in flight in a register ring (gemv_stream.cuh's swap_load);
//   - int32 partial sums add exactly in any order, so the split merge and
//     the block sum give the plain version's sums bit for bit, and the
//     epilogue converts and scales once (w8a8::dequant).
// M larger than the row tile (1, 2 or 4 rows) loops over row tiles inside
// the block, re-reading the block's weight tile: correct at any M, but
// from ~16 rows on the dp4a rate, not HBM, binds it. Prefill rows go to the
// int8 wgmma GEMM (w8a8_gemm.cu), which shares this file's transposes
// (w8a8.cuh).
#include "gemv_stream.cuh"
#include "w8a8.cuh"

using namespace tllm;

namespace {

using stream::kThreads;
using stream::kVec;

struct Params {
  const int8_t* x;     // [M, K]
  const int8_t* q;     // [K, ldw] of one layer, from column 0 of N
  const float* sx;     // [M] (sx_step 1) or [1] (sx_step 0)
  int sx_step;
  const float* sw;     // [N] (sw_step 1) or [1] (sw_step 0)
  int sw_step;
  float* out;          // [M, N]
  int* part;           // [ksplit, M, N] workspace (ksplit > 1)
  int* counters;       // [column tiles] workspace, 0 between launches
  int M, K, N;         // N: the columns computed (a window of ldw)
  int ldw;             // row stride of q
  int kc;              // K rows of a split (a multiple of 16)
  int ksplit;
  int lanes;           // threads along N (gemv_stream.cuh Tile)
};

// 4-row steps a thread keeps in flight (4 loads each): 2 at one row.
template <int MR>
__host__ __device__ constexpr int ring_depth() {
  return MR == 1 ? 2 : 1;
}

// Dynamic shared memory: x's K-quads [MR][kc / 4] and the block sum
// [kWarps][MR][bn], int32.
template <int MR>
size_t smem_bytes(const Params& p) {
  return 4 * (static_cast<size_t>(MR) * (p.kc / 4) +
              static_cast<size_t>(stream::kWarps) * MR * kVec * p.lanes);
}

// The dequantizing epilogue: (f32(acc) * s_x[m]) * s_w[n].
struct Epilogue {
  const float* sx;
  int sx_step;
  const float* sw;
  int sw_step;
  float* out;
  int N;
  __device__ __forceinline__ float2 load(int m, int n) const {
    return make_float2(sx[m * sx_step], sw[n * sw_step]);
  }
  __device__ __forceinline__ void store(int acc, int m, int n,
                                        float2 in) const {
    out[static_cast<size_t>(m) * N + n] = w8a8::dequant(acc, in.x, in.y);
  }
};

template <int MR>
__global__ void __launch_bounds__(kThreads, 2) dp4a_kernel(const Params p) {
  constexpr int kDQ = ring_depth<MR>();
  extern __shared__ __align__(16) int smem_i[];

  const stream::Tile t = stream::tile_of(p.lanes);
  const int tid = threadIdx.x;
  const int split = blockIdx.y;
  const int k_begin = split * p.kc;                 // kc % 16 == 0
  const int nq = (min(p.K, k_begin + p.kc) - k_begin) / 4;  // K % 4 == 0
  const int n_tile = blockIdx.x * t.bn;
  const int n0 = n_tile + t.ln * kVec;
  // this thread's K-quads: t.slot + j * t.rows, j < mine
  const int mine = n0 < p.N && nq > t.slot
                       ? (nq - t.slot + t.rows - 1) / t.rows : 0;
  const int8_t* wp =
      p.q + (static_cast<size_t>(k_begin) + 4 * t.slot) * p.ldw + n0;
  const size_t step = static_cast<size_t>(4 * t.rows) * p.ldw;

  int* xs = smem_i;                               // [MR][kc / 4]
  int* red = xs + MR * (p.kc / 4);                // block sum
  const stream::Splits<int> sp{p.M, p.N, n_tile, split, p.ksplit, p.part,
                               p.counters};
  const Epilogue epi{p.sx, p.sx_step, p.sw, p.sw_step, p.out, p.N};

  for (int m0 = 0; m0 < p.M; m0 += MR) {
    // the weight's first bytes go out before x is staged
    int4 ring[kDQ][4];
#pragma unroll
    for (int i = 0; i < kDQ; ++i)
      if (i < mine) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          ring[i][u] = stream::load16(wp + i * step + static_cast<size_t>(u) * p.ldw);
      }
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int m = m0 + r;
      for (int j = tid; j < nq; j += kThreads)
        xs[r * (p.kc / 4) + j] =
            m < p.M ? *reinterpret_cast<const int*>(
                          p.x + static_cast<size_t>(m) * p.K + k_begin + 4 * j)
                    : 0;
    }
    __syncthreads();

    int acc[MR][kVec];
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int c = 0; c < kVec; ++c) acc[r][c] = 0;
    for (int j0 = 0; j0 < mine; j0 += kDQ) {
#pragma unroll
      for (int i = 0; i < kDQ; ++i) {
        const int j = j0 + i;
        const int8_t* next = wp + (j + kDQ) * step;
        int4 rows[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          rows[u] = stream::swap_load(ring[i][u],
                                      next + static_cast<size_t>(u) * p.ldw,
                                      j + kDQ < mine);
        if (j >= mine) continue;
        // the step's 4x4 byte blocks transposed into K-quads per column
        uint32_t cols[kVec];
        w8a8::transpose4x4(rows[0].x, rows[1].x, rows[2].x, rows[3].x, cols + 0);
        w8a8::transpose4x4(rows[0].y, rows[1].y, rows[2].y, rows[3].y, cols + 4);
        w8a8::transpose4x4(rows[0].z, rows[1].z, rows[2].z, rows[3].z, cols + 8);
        w8a8::transpose4x4(rows[0].w, rows[1].w, rows[2].w, rows[3].w, cols + 12);
        const int qi = t.slot + j * t.rows;
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          const int xv = xs[r * (p.kc / 4) + qi];
#pragma unroll
          for (int c = 0; c < kVec; ++c)
            acc[r][c] = __dp4a(static_cast<int>(cols[c]), xv, acc[r][c]);
        }
      }
    }

    stream::block_sum<int, MR>(acc, t, red);
    stream::tile_out<int, MR>(red, t, sp, m0, epi);
    __syncthreads();  // xs and red are restaged by the next row tile
  }
  stream::merge_splits<int>(t, sp, epi);
}

template <int MR>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if ((p.lanes != 8 && p.lanes != 16 && p.lanes != 32) || MR * p.lanes > 32 ||
      (p.ksplit > 1 && (p.part == nullptr || p.counters == nullptr)))
    return cudaErrorInvalidValue;
  const dim3 grid((p.N + kVec * p.lanes - 1) / (kVec * p.lanes), p.ksplit);
  return tllm::stream::launch<dp4a_kernel<MR>>(grid, smem_bytes<MR>(p),
                                              stream, p);
}

}  // namespace

// x [M, K] int8, q [K, ldw] int8 of ONE layer and sw its scales (the
// wrapper offsets the stacked arrays, and for a window [start, start + N)
// of the ldw columns q and a per-channel sw by start; ldw == N for the
// whole); sx [M] (sx_step 1) or [1] (sx_step 0), sw [N]
// (sw_step 1) or [1] (sw_step 0); out [M, N] f32; part [ksplit, M, N] int32
// and counters [column tiles] of the stream's workspace (null at ksplit 1).
// K % 4 == 0, kc % 16 == 0, N % 16 == 0; mr in {1, 2, 4}: rows per
// register tile; lanes threads along N (the wrapper's gemv_plan).
extern "C" int tllm_w8a8_matmul_stacked(const void* x, const void* q,
                                        const void* sx, int sx_step,
                                        const void* sw, int sw_step, void* out,
                                        void* part, void* counters, int M,
                                        int K, int N, int ldw, int ksplit,
                                        int kc, int mr, int lanes, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Params p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(q),
                 static_cast<const float*>(sx), sx_step,
                 static_cast<const float*>(sw), sw_step,
                 static_cast<float*>(out), static_cast<int*>(part),
                 static_cast<int*>(counters), M, K, N, ldw, kc, ksplit,
                 lanes};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mr) {
    case 1: return launch<1>(p, s);
    case 2: return launch<2>(p, s);
    case 4: return launch<4>(p, s);
    default: return cudaErrorInvalidValue;
  }
}
