// The weight stream of the one-launch GEMVs of few rows: the weight-only /
// e4m3 body (woq_gemv.cuh) and the W8A8 dp4a body (w8a8_matmul.cu).
//
// Both stream a weight stored [K, N] (N contiguous) once per row tile and
// are bound by its bytes on the H100 (3.35 TB/s): at M <= 4 they do 2 to 8
// operations a byte. What this header gives them:
//   - the tile: a block of kThreads threads covers a column tile of
//     16 * lanes columns (lanes = 8, 16 or 32 threads along N, each loading
//     16 contiguous bytes of a stored row) and kThreads / lanes stored rows
//     at a time; the wrapper picks lanes and the K split (gemv_plan in
//     ops/kernels/woq_matmul.py) so that the grid of column tiles x K splits
//     is one wave of two blocks an SM;
//   - swap_load: the register ring's step. A thread keeps its next rows in
//     a ring of 16-byte registers; one asm statement takes a row out of
//     its slot and issues the slot's next load in place (predicated off
//     past the thread's last row), so every load goes out the moment its
//     slot frees and stays in flight while the rows before it are
//     consumed (as separate statements the compiler batched the loads of
//     a whole turn of the ring, halving the bytes in flight). The bodies
//     fill the ring before their prologue, so the weight's first bytes
//     are in flight while x is staged;
//   - block_sum: the block's threads that hold the same columns summed in
//     one pass (shuffles across the lanes of a warp, then the warps through
//     shared memory in a fixed order);
//   - the K splits merged inside the launch: with more than one split each
//     block leaves its sums in the per-stream workspace
//     (ops/kernels/_build.py::workspace) and takes an arrival ticket; the
//     last block of a column tile to arrive adds the splits up in split
//     order (so a call is bitwise repeatable whatever the arrival order),
//     finishes the outputs (scale, residual) and sets the counter back to 0
//     for the next launch on the stream. (A thread-block cluster summing
//     the splits through distributed shared memory was slower at
//     LLaMA-7B's wo shape: gemv_breakdown.py's "cluster merge" variant.)
#pragma once

#include <type_traits>

#include "common.cuh"

namespace tllm {
namespace stream {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 16;                // bytes (codes) a thread loads at once

// A thread's place in its block's column tile.
struct Tile {
  int lanes;   // threads along N
  int bn;      // columns of the tile: 16 * lanes
  int rows;    // stored rows the block covers at once: kThreads / lanes
  int slot;    // this thread's row slot (0 .. rows - 1)
  int ln;      // its lane along N: columns 16 ln .. 16 ln + 15 of the tile
  bool lead;   // the first lane of the warp on its columns
};

__device__ __forceinline__ Tile tile_of(int lanes) {
  const int lane = threadIdx.x & 31;
  const int shift = __ffs(lanes) - 1;
  Tile t;
  t.lanes = lanes;
  t.bn = kVec * lanes;
  t.rows = kThreads / lanes;
  t.ln = lane & (lanes - 1);
  t.slot = (threadIdx.x >> 5) * (32 >> shift) + (lane >> shift);
  t.lead = (lane >> shift) == 0;
  return t;
}

// One 16-byte load of the streamed weight, read once: no L1 line.
__device__ __forceinline__ int4 load16(const void* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Returns the row in slot and, when live, loads the 16 bytes at p into
// slot in the same statement.
__device__ __forceinline__ int4 swap_load(int4& slot, const void* p,
                                          bool live) {
  int4 v;
  asm volatile(
      "{\n"
      "  .reg .pred q;\n"
      "  setp.ne.b32 q, %9, 0;\n"
      "  mov.b32 %0, %4;\n"
      "  mov.b32 %1, %5;\n"
      "  mov.b32 %2, %6;\n"
      "  mov.b32 %3, %7;\n"
      "  @q ld.global.nc.L1::no_allocate.v4.s32 {%4, %5, %6, %7}, [%8];\n"
      "}"
      : "=&r"(v.x), "=&r"(v.y), "=&r"(v.z), "=&r"(v.w), "+r"(slot.x),
        "+r"(slot.y), "+r"(slot.z), "+r"(slot.w)
      : "l"(p), "r"(static_cast<int>(live)));
  return v;
}

__device__ __forceinline__ void store4(float* d, float a, float b, float c,
                                       float e) {
  *reinterpret_cast<float4*>(d) = make_float4(a, b, c, e);
}
__device__ __forceinline__ void store4(int* d, int a, int b, int c, int e) {
  *reinterpret_cast<int4*>(d) = make_int4(a, b, c, e);
}

// Sums acc over the threads of the block on the same columns: the lanes of
// a warp by a butterfly of shuffles (every lane ends with the same bits),
// then the kWarps warps' sums through red [kWarps][MR][bn] in warp order.
// Leaves the block's sum of (row r, column c) at red[r * bn + c], written
// by thread e % kThreads of e = r * bn + c (the epilogues read it there).
template <typename V, int MR>
__device__ __forceinline__ void block_sum(V (&acc)[MR][kVec], const Tile& t,
                                          V* red) {
  for (int o = t.lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < MR; ++r)
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], o);
  }
  const int warp = threadIdx.x >> 5;
  if (t.lead) {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      V* dst = red + (warp * MR + r) * t.bn + t.ln * kVec;
#pragma unroll
      for (int j = 0; j < kVec; j += 4)
        store4(dst + j, acc[r][j], acc[r][j + 1], acc[r][j + 2], acc[r][j + 3]);
    }
  }
  __syncthreads();
  const int n = MR * t.bn;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    V s = red[e];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w * n + e];
    red[e] = s;
  }
}

// Where a block's sums go: its split of a column tile and the workspace.
template <typename V>
struct Splits {
  int M, N;
  int n_tile;     // first column of the tile
  int split;      // this block's K split
  int ksplit;     // splits of a column tile
  V* part;        // [ksplit, M, N] workspace (ksplit > 1)
  int* counters;  // [column tiles] arrivals, 0 between launches
};

// After block_sum of the row tile at m0: each sum (m0 + r, column c) goes
// to the epilogue at one split, else into the workspace for merge_splits.
// E has load(m, n) -> float2 (the output's inputs besides the sum: scale,
// residual) and store(v, m, n, loaded).
template <typename V, int MR, class E>
__device__ __forceinline__ void tile_out(const V* red, const Tile& t,
                                         const Splits<V>& s, int m0,
                                         const E& epi) {
  const int n_sums = MR * t.bn;
  if (s.ksplit == 1) {
    for (int e = threadIdx.x; e < n_sums; e += kThreads) {
      const int m = m0 + e / t.bn, n = s.n_tile + e % t.bn;
      if (m < s.M && n < s.N) epi.store(red[e], m, n, epi.load(m, n));
    }
    return;
  }
  for (int e = threadIdx.x; e < n_sums; e += kThreads) {
    const int m = m0 + e / t.bn, n = s.n_tile + e % t.bn;
    if (m < s.M && n < s.N)
      s.part[(static_cast<size_t>(s.split) * s.M + m) * s.N + n] = red[e];
  }
}

// After the block's last row tile: the block takes an arrival ticket for
// its column tile; the last of the tile's splits to arrive sums every
// split's sums in split order and stores them. A thread takes 4 adjacent
// columns of a row (16-byte loads; N % 16 == 0) and issues up to 8
// splits' loads at once (16 at once made the fp8 and dp4a kernels spill
// registers); its first 4 outputs have their epilogue inputs loaded
// before the ticket, off the merge's critical path.
template <typename V, class E>
__device__ __forceinline__ void merge_splits(const Tile& t,
                                             const Splits<V>& s,
                                             const E& epi) {
  using V4 = typename std::conditional<std::is_same<V, float>::value, float4,
                                       int4>::type;
  if (s.ksplit == 1) return;
  const int quads = t.bn / 4;
  const int n_quads = s.M * quads;
  float2 pre[4];
  {
    const int e = threadIdx.x;
    const int n = s.n_tile + 4 * (e % quads);
    if (e < n_quads && n < s.N) {
#pragma unroll
      for (int q = 0; q < 4; ++q) pre[q] = epi.load(e / quads, n + q);
    }
  }
  __shared__ int last;
  __syncthreads();                   // every thread's sums are stored
  if (threadIdx.x == 0) {
    // the block's sums (this thread's through the barrier above) reach L2
    // before the ticket
    __threadfence();
    int* c = s.counters + blockIdx.x;
    last = atomicAdd(c, 1) == s.ksplit - 1;
    if (last) *c = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t mn = static_cast<size_t>(s.M) * s.N;
  for (int e = threadIdx.x; e < n_quads; e += kThreads) {
    const int m = e / quads, n = s.n_tile + 4 * (e % quads);
    if (n >= s.N) continue;
    const V4* p = reinterpret_cast<const V4*>(
        s.part + static_cast<size_t>(m) * s.N + n);
    V v[4] = {0, 0, 0, 0};
    for (int j0 = 0; j0 < s.ksplit; j0 += 8) {
      V4 part[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (j0 + u < s.ksplit) part[u] = __ldcg(p + (j0 + u) * mn / 4);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (j0 + u < s.ksplit) {
          v[0] += part[u].x;
          v[1] += part[u].y;
          v[2] += part[u].z;
          v[3] += part[u].w;
        }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      epi.store(v[q], m, n + q, e < kThreads ? pre[q] : epi.load(m, n + q));
  }
}

// Launch kernel on grid (column tiles, ksplit). Raises the kernel's
// dynamic shared memory limit (once per device and size) where smem needs
// it. (static: the limit below belongs to this library's copy of the
// kernel, also where several builds of one kernel are loaded side by side)
template <auto kernel, class P>
static cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream,
                          const P& p) {
  static int allowed[64] = {};     // the limit set, per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  // past 40 KB (48 KB less room for the kernel's static shared memory)
  if (smem > 40 * 1024 && static_cast<int>(smem) > allowed[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed[device] = static_cast<int>(smem);
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace stream
}  // namespace tllm
