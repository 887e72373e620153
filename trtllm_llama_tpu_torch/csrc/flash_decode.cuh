// One-token decode attention over one layer of a KV cache, in one launch,
// with one of two row addressings (a compile-time policy, kPaged):
//   - dense: the stacked cache [B, Hkv, S, D], a sequence's rows contiguous.
//     The body of kernel 3 (`dma_decode_attention`, every default decode
//     step) and row 9 (`fused_decode_attention`, the 'fused' mode), which
//     write the new token's row in place and attend, and of row 8
//     (`decode_attention_kernel`, the 'split' mode and
//     `decode_attention_at`), which attends read-only; all three enter
//     through decode_attention.cu, one library.
//   - paged: a layer's block pool [NB, Hkv, BS, D], sequence b's row j at
//     row j % BS of block tables[b, j / BS] (-1: the trash block NB - 1),
//     S = MB * BS (the table's width MB): row 14
//     (`paged_decode_attention`, every paged serving decode step), which
//     writes and attends; entry paged_decode_attention.cu.
//
// Replaces: trtllm_llama_tpu/ops/pallas/dma_decode_attention.py:156
// (dma_decode_attention, pallas_call at :207),
// trtllm_llama_tpu/ops/pallas/attention.py:185 (fused_decode_attention,
// pallas_call at :240), attention.py:72 (decode_attention_kernel,
// pallas_call at :109) and paged_decode_attention.py:157
// (paged_decode_attention, pallas_call at :218). The writers compute, for
// each sequence b with pos = positions[b] and n_live = min(pos + 1, S):
//   row pos = enc(k_new[b]), likewise v (when pos >= S the dense cache
//   drops the write and a paged pool takes it at row pos % BS of the trash
//   block; either then attends all S rows);
//   out[b, h] = softmax_f32((q[b, h] . dec(K[j])) * sm_scale, j < n_live)
//               @ dec(V), p @ v in f32;
// row 8 (Params::read_only) writes nothing and attends, with len =
// positions[b] (the cache length), n_live = min(len, S) rows, or at len <= 0
// all S rows with one score for every row (the reference masks them all to
// its finite NEG_INF), so p is uniform and the output the mean of dec(V).
// A float cache stores the value as is (enc / dec are the dtype cast), an
// int8 cache enc(x) = clamp(rint(x / scale), +-127) by true division (the
// JAX package's _quant_kv) and dec(c) = c * scale in f32, an e4m3 (fp8)
// cache enc(x) = the e4m3 code of x / scale (true division, nearest even,
// saturated at +-448: the JAX package's fp8_encode) and dec(c) = the code's
// exact value * scale in f32 (common.cuh; here the scale multiplies the f32
// sums, which moves them by a rounding).
//
// What bounds it on the H100: the live K/V bytes, 2 * B * Hkv * n_live * D *
// sizeof(cache element), at 3.35 TB/s (LLaMA-7B's bf16 cache at 8.2k rows:
// 0.040 ms; int8 or e4m3 0.020). At a large GQA group (Falcon-7B's 71 heads
// on one KV head) the f32 scoring on CUDA cores comes next. Design:
//   - Split the cache over the card in one launch. Grid (split, kv head x
//     head chunk, b); split s covers the whole 64-row tiles [s * tps,
//     (s + 1) * tps) of the S rows, clipped to n_live. The host picks
//     `splits` and `tps` from (B, Hkv, S, group) and the SM count alone
//     (ops/kernels/decode_attention.py::decode_split: one wave of two
//     blocks an SM), so no host sync; a block whose range starts past
//     n_live streams nothing and leaves an empty state. Each block leaves
//     its running max, sum and acc[D] per head in a small workspace (one per
//     CUDA stream, kept by the wrapper between calls, not allocated per
//     call) and takes an arrival ticket; the last of a (kv head, chunk,
//     b)'s splits to arrive merges them and resets the counter.
//     No combine launch. A thread-block cluster merging through
//     distributed shared memory was tried first: its launch cost ~25 us at
//     8k rows and ~8 us at one live row (decode_breakdown.py, H100).
//   - Serve the GQA group from as few reads as the heads allow: a block
//     serves up to kChunk query heads of its kv head (q in shared memory,
//     or in registers for LLaMA-7B's group of 1), so LLaMA-7B's and every
//     group up to 8 read each KV head's rows once. A larger group is cut
//     into balanced chunks of at most kChunk heads along grid y (Falcon-7B's
//     71: 8 x 8 + 7), each chunk re-reading its split's rows from L2 (0.27
//     MB at Falcon-7B's 1038 rows): a block serving all 71 heads spent its
//     time on f32 scoring on one SM and merging 32 splits of 71 heads
//     (0.066 ms against SDPA's 0.0106, decode_breakdown.py, H100).
//   - Stream raw bytes: 16-byte cp.async of the stored codes through a
//     4-stage ring of kRows-row stages (kRows * D * sizeof(element) <= 8 KB
//     a stage and operand), rows padded by 16 bytes so lanes reading other
//     rows hit other banks; codes read in registers as f32 (int8 by byte
//     permutes, e4m3 two codes a cvt.rn.f16x2.e4m3x2; the layer's scale
//     applied to the f32 sums). An e4m3 row has int8's bytes, so its stage
//     geometry (Shape) too.
//   - Warp w takes its rows of every stage for all of the block's heads:
//     lane (row, part) scores its part and the row's lanes add by
//     shuffles, so every warp works at a group of 1; the warp's online
//     softmax and p @ V (lane l: head dims [l * C, (l + 1) * C)) stay in
//     registers. One block barrier a stage (the ring); the warps merge once.
//   - The write race: only the block whose range holds pos touches row pos.
//     The thread that would cp.async a 16-byte chunk of that row encodes it
//     from k_new / v_new instead and stores it to the cache and to the
//     stage, so the block attends dec(enc(k_new)) as stored and no block
//     reads the row being written. A paged pool can alias that stored row
//     from other table rows (-1 entries all map to the trash block), so
//     there every block encodes each live row whose (block, row) is the
//     write's instead of reading it, and only head chunk 0 of the owner of
//     row pos stores it; at pos >= S head chunk 0 of the last split stores
//     the trash row before it stages anything. Two sequences that write or
//     read one trash row race, as in the reference.
//   - Paged rows: a block loads its split's slice of tables[b, :] once into
//     shared memory (-1 mapped to the trash block), and load_stage turns
//     each row into (block, row % BS) from there, row by row, so a BS that
//     does not divide the 64-row tile (24, 96) crosses blocks inside a
//     stage. The host sizes the slice (`table_slice`).
// Scores, the softmax and p @ V stay in f32 on CUDA cores, as the contract
// says.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace tllm {
namespace flash_decode {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // cache rows of a split's unit (decode_split)
constexpr int kStages = 4;     // cp.async ring
constexpr int kMaxSplits = 32;  // splits of one (kv head, b)

// Stage geometry of a cache element type and head dim.
template <typename TC, int D>
struct Shape {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(TC));
  static constexpr int kStride = kRowBytes + 16;  // padded row in a stage
  static constexpr int kRows = 8192 / kRowBytes >= 64   ? 64
                               : 8192 / kRowBytes >= 32 ? 32
                                                        : 16;
  static constexpr int kParts = kThreads / kRows;  // lanes scoring a row
  static constexpr int kPart = D / kParts;         // head dims of a part
  static constexpr int kCpr = kRowBytes / 16;      // 16-byte chunks a row
  static constexpr int kChunks = kRows * kCpr;
  static constexpr int kC = D / 32;                // head dims a lane in p @ V
  static constexpr int kStageBytes = kRows * kStride;
  static constexpr int kRingBytes = 2 * kStages * kStageBytes;
  static_assert(D % kParts == 0 && D % 32 == 0 && kRowBytes % 16 == 0,
                "unsupported head dim");
};

// q in shared memory, in its own dtype T, part by part: a part of kPart
// elements padded by 16 bytes, so the parts that a warp reads at once sit
// in different banks.
template <typename T, typename TC, int D>
__host__ __device__ constexpr int q_stride() {
  return Shape<TC, D>::kPart + 16 / static_cast<int>(sizeof(T));
}

// The alignment of n bytes read as one vector: their lowest set bit, at
// most 16 (the widest load).
constexpr size_t pack_align(size_t n) {
  return (n & (~n + 1)) < 16 ? (n & (~n + 1)) : 16;
}

template <typename E, int N>
struct alignas(pack_align(sizeof(E) * N)) Pack {
  E v[N];
};

__device__ __forceinline__ float raw_f(int8_t c) { return static_cast<float>(c); }
__device__ __forceinline__ float raw_f(__nv_fp8_e4m3 c) {
  return KVCodec<__nv_fp8_e4m3>::dec(c, 1.f);
}

// Four e4m3 codes (byte j of w is code j) as their exact values.
__device__ __forceinline__ void e4m3x4(uint32_t w, float* x) {
  fp8x2(w, x[0], x[1]);
  fp8x2(w >> 16, x[2], x[3]);
}
template <typename E>
__device__ __forceinline__ float raw_f(E v) {
  return to_f(v);
}

// x[i] = the N elements at p as f32, read as one vector: a float cache's
// values, an int8 or e4m3 cache's codes as their values (the kernels apply
// the layer's scale to the f32 sums: s * scale * sm_scale, and p @ V times
// scale). int8 codes go four at a time: each, offset by 128, is planted in
// the low mantissa of 2^23 by a byte permute and 2^23 + 128 subtracted,
// exactly and at the full rate (a conversion instruction runs at a quarter
// of it); e4m3 codes two a cvt.rn.f16x2.e4m3x2 and a widening each.
template <typename E, int N>
__device__ __forceinline__ void load_raw(const E* p, float (&x)[N]) {
  if constexpr (std::is_same<E, __nv_fp8_e4m3>::value && N % 4 == 0) {
    const Pack<uint32_t, N / 4> pw =
        *reinterpret_cast<const Pack<uint32_t, N / 4>*>(p);
#pragma unroll
    for (int w = 0; w < N / 4; ++w) e4m3x4(pw.v[w], x + 4 * w);
  } else if constexpr (std::is_same<E, int8_t>::value && N % 4 == 0) {
    const Pack<uint32_t, N / 4> pw =
        *reinterpret_cast<const Pack<uint32_t, N / 4>*>(p);
#pragma unroll
    for (int w = 0; w < N / 4; ++w) {
      const uint32_t u = pw.v[w] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[4 * w + j] =
            __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
            8388736.f;
    }
  } else {
    const Pack<E, N> pk = *reinterpret_cast<const Pack<E, N>*>(p);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = raw_f(pk.v[i]);
  }
}

struct Params {
  const void* q;
  const void* k_new;
  const void* v_new;
  void* kc;
  void* vc;
  const float* kv_scale;
  const int* positions;
  void* out;
  float* part;    // [B, Hkv, splits, group, D + 2]: the splits' states
  int* counters;  // [B, Hkv * head chunks]: arrivals, 0 between launches
  int Hq, Hkv, S;
  int tps;    // 64-row tiles a split covers
  int heads;  // query heads a block serves (a chunk of the group)
  float sm_scale;
  bool read_only;  // row 8: positions[] are cache lengths, no write
  // paged pools only: tables [B, mb], block size bs, the trash block and
  // the table entries a block's slice holds
  const int* tables;
  int mb, bs, trash, slice;
};

// What a block covers: split blockIdx.x of (kv head, head chunk) blockIdx.y
// of sequence blockIdx.z; its rows [row_begin, row_end) in n_st stages.
struct Block {
  int split, n_split, group, hk, hc, b, g0, heads;
  int pos, row_begin, row_end, n_st;
  bool uniform;     // read-only at a length <= 0: every row scores alike
  float kvs;
  size_t panel;     // dense: row 0 of (b, hk) in the layer's cache, in rows
  size_t new_base;  // (b, hk) in k_new / v_new, in elements
  int e0;            // paged: the table entry of row_begin
  int w_blk, w_row;  // paged: where the write lands
};

// The row of (pool block blk, row r in it) for kv head hk, in rows of the
// layer's pool [NB, Hkv, BS, D].
__device__ __forceinline__ size_t pool_row(const Params& p, int hk, int blk,
                                           int r) {
  return (static_cast<size_t>(blk) * p.Hkv + hk) * p.bs + r;
}

template <typename TC, int D, bool kPaged>
__device__ __forceinline__ Block block_of(const Params& p) {
  constexpr int kRows = Shape<TC, D>::kRows;
  Block k;
  k.split = blockIdx.x;
  k.n_split = gridDim.x;
  k.group = p.Hq / p.Hkv;
  const int n_hc = gridDim.y / p.Hkv;
  k.hk = blockIdx.y / n_hc;
  k.hc = blockIdx.y - k.hk * n_hc;
  k.b = blockIdx.z;
  k.g0 = k.hc * p.heads;
  k.heads = min(p.heads, k.group - k.g0);
  const int v = p.positions[k.b];
  // the write row (-1: none) and the rows attended
  k.pos = p.read_only ? -1 : v;
  k.uniform = p.read_only && v <= 0;
  const int n_live = !p.read_only ? min(v + 1, p.S) : v > 0 ? min(v, p.S)
                                                            : p.S;
  k.row_begin = k.split * p.tps * kTile;
  k.row_end = min(k.row_begin + p.tps * kTile, n_live);
  k.n_st = k.row_end > k.row_begin
               ? (k.row_end - k.row_begin + kRows - 1) / kRows
               : 0;
  k.kvs = p.kv_scale != nullptr ? *p.kv_scale : 1.f;
  k.panel = (static_cast<size_t>(k.b) * p.Hkv + k.hk) * p.S;
  k.new_base = (static_cast<size_t>(k.b) * p.Hkv + k.hk) * D;
  if constexpr (kPaged) {  // a writer: pos >= 0
    k.e0 = k.row_begin / p.bs;
    const int e = k.pos / p.bs;
    k.w_row = k.pos - e * p.bs;
    const int blk = e < p.mb ? p.tables[static_cast<size_t>(k.b) * p.mb + e]
                             : p.trash;
    k.w_blk = blk < 0 ? p.trash : blk;
  }
  return k;
}

// q of the block's heads into shared memory, part by part:
// qs[(g * kParts + part) * q_stride + j] = q[g, part * kPart + j].
template <typename T, typename TC, int D>
__device__ __forceinline__ void load_q(const Params& p, const Block& k,
                                       T* qs) {
  using Sh = Shape<TC, D>;
  const T* qg = static_cast<const T*>(p.q) +
                (static_cast<size_t>(k.b) * p.Hq + k.hk * k.group + k.g0) * D;
  for (int i = threadIdx.x; i < k.heads * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    qs[(g * Sh::kParts + d / Sh::kPart) * q_stride<T, TC, D>() +
       d % Sh::kPart] = qg[i];
  }
}

// The dot product of a thread's kPart cache elements with the same part of
// the q at qp (f32 products and sum).
template <typename T, int kPart>
__device__ __forceinline__ float dot_part(const T* qp, const float (&kx)[kPart]) {
  const Pack<T, kPart> qv = *reinterpret_cast<const Pack<T, kPart>*>(qp);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPart; ++j) s = fmaf(to_f(qv.v[j]), kx[j], s);
  return s;
}

// 16 bytes of the cache's element type: one cp.async chunk.
template <typename TC>
using Chunk = Pack<TC, 16 / static_cast<int>(sizeof(TC))>;

// Chunk cc of the new token's K and V rows of the block's (b, hk), encoded
// as the cache stores them.
template <typename T, typename TC>
__device__ __forceinline__ void encode_new(const Params& p, const Block& k,
                                           int cc, Chunk<TC>& kp,
                                           Chunk<TC>& vp) {
  constexpr int kEpc = 16 / static_cast<int>(sizeof(TC));  // elements a chunk
  const T* kn = static_cast<const T*>(p.k_new) + k.new_base + cc * kEpc;
  const T* vn = static_cast<const T*>(p.v_new) + k.new_base + cc * kEpc;
#pragma unroll
  for (int j = 0; j < kEpc; ++j) {
    kp.v[j] = KVCodec<TC>::enc(to_f(kn[j]), k.kvs);
    vp.v[j] = KVCodec<TC>::enc(to_f(vn[j]), k.kvs);
  }
}

// A paged write past the table (pos >= S): row pos % BS of the trash
// block, stored by head chunk 0 of the last split before it stages a row.
template <typename T, typename TC, int D>
__device__ __forceinline__ void write_past_table(const Params& p,
                                                 const Block& k) {
  using Sh = Shape<TC, D>;
  if (k.pos < p.S || k.hc != 0 || k.split != k.n_split - 1) return;
  const size_t off = pool_row(p, k.hk, k.w_blk, k.w_row) * Sh::kRowBytes;
  for (int cc = threadIdx.x; cc < Sh::kCpr; cc += kThreads) {
    Chunk<TC> kp, vp;
    encode_new<T, TC>(p, k, cc, kp, vp);
    *reinterpret_cast<Chunk<TC>*>(static_cast<unsigned char*>(p.kc) + off +
                                  cc * 16) = kp;
    *reinterpret_cast<Chunk<TC>*>(static_cast<unsigned char*>(p.vc) + off +
                                  cc * 16) = vp;
  }
}

// Stage i of the block's rows into ring slot i % kStages: rows row_begin +
// i * kRows + [0, kRows), those at or past row_end zero-filled by cp.async
// (src-size 0). The 16-byte chunks of the write's row are not read: the
// thread that would copy one encodes it from k_new / v_new, stores it to
// the stage and, for head chunk 0 at row pos, to the cache (the only write
// of the row). Paged: row -> (tbl[row / BS - e0], row % BS), tbl the
// block's slice of the table in shared memory.
template <typename T, typename TC, int D, bool kPaged>
__device__ __forceinline__ void load_stage(const Params& p, const Block& k,
                                           const int* tbl,
                                           unsigned char* ring, int i) {
  using Sh = Shape<TC, D>;
  const int row0 = k.row_begin + i * Sh::kRows;
  unsigned char* ks = ring + (i % kStages) * Sh::kStageBytes;
  unsigned char* vs = ring + (kStages + i % kStages) * Sh::kStageBytes;
  unsigned char* kbytes = static_cast<unsigned char*>(p.kc);
  unsigned char* vbytes = static_cast<unsigned char*>(p.vc);
  for (int c = threadIdx.x; c < Sh::kChunks; c += kThreads) {
    const int r = c / Sh::kCpr, cc = c - r * Sh::kCpr;
    const int row = row0 + r;
    const bool live = row < k.row_end;
    size_t at = 0;       // the row in the layer's cache or pool, in rows
    bool fresh = false;  // the row the write lands on
    if (live) {
      if constexpr (kPaged) {
        const int e = row / p.bs;
        const int blk = tbl[e - k.e0], in_blk = row - e * p.bs;
        at = pool_row(p, k.hk, blk, in_blk);
        fresh = blk == k.w_blk && in_blk == k.w_row;
      } else {
        at = k.panel + row;
        fresh = row == k.pos;  // only inside the owner's range (pos < S)
      }
    }
    const size_t goff = at * Sh::kRowBytes + cc * 16;
    unsigned char* kd = ks + r * Sh::kStride + cc * 16;
    unsigned char* vd = vs + r * Sh::kStride + cc * 16;
    if (fresh) {
      Chunk<TC> kp, vp;
      encode_new<T, TC>(p, k, cc, kp, vp);
      *reinterpret_cast<Chunk<TC>*>(kd) = kp;
      *reinterpret_cast<Chunk<TC>*>(vd) = vp;
      if (k.hc == 0 && row == k.pos) {
        *reinterpret_cast<Chunk<TC>*>(kbytes + goff) = kp;
        *reinterpret_cast<Chunk<TC>*>(vbytes + goff) = vp;
      }
    } else {
      gemm::cp_async16(gemm::smem_addr(kd), live ? kbytes + goff : kbytes,
                       live);
      gemm::cp_async16(gemm::smem_addr(vd), live ? vbytes + goff : vbytes,
                       live);
    }
  }
}

// After the block's state is in shared memory (running max mx[g], sum
// sm[g], acc fin[g][D] of raw V for its heads), write the output: at one
// split directly; else the block leaves its state in the workspace, takes
// an arrival ticket, and the last of the splits of its (kv head, chunk, b)
// to arrive merges all of them (the others return) and sets the counter
// back to 0 for the next launch. The merge loads every split's max and sum
// at once into `scratch` (2 * heads * splits floats of shared memory),
// weighs split j of head g by exp(m_j - max) / sum, then reads each live
// split's acc once, coalesced.
template <typename T, int D>
__device__ __forceinline__ void merge_splits(const Params& p, const Block& k,
                                             const float* mx, const float* sm,
                                             const float* fin,
                                             float* scratch) {
  constexpr int kState = D + 2;  // acc[D], max, sum
  __syncthreads();               // the block's state is complete
  T* out = static_cast<T*>(p.out) +
           (static_cast<size_t>(k.b) * p.Hq + k.hk * k.group + k.g0) * D;
  const int n = k.n_split;
  if (n == 1) {
    for (int i = threadIdx.x; i < k.heads * D; i += kThreads)
      out[i] = from_f<T>(fin[i] * k.kvs / sm[i / D]);  // int8: V's scale
    return;
  }
  // split j of head g at all + (j * group + g) * kState
  float* all = p.part + (static_cast<size_t>(k.b) * p.Hkv + k.hk) * n *
                            k.group * kState +
               static_cast<size_t>(k.g0) * kState;
  const size_t split_stride = static_cast<size_t>(k.group) * kState;
  float* mine = all + k.split * split_stride;
  for (int i = threadIdx.x; i < k.heads * kState; i += kThreads) {
    const int g = i / kState, j = i - g * kState;
    mine[i] = j < D ? fin[g * D + j] : j == D ? mx[g] : sm[g];
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (threadIdx.x == 0) {
    int* c = p.counters + static_cast<size_t>(k.b) * gridDim.y + blockIdx.y;
    last = atomicAdd(c, 1) == n - 1;
    if (last) *c = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* wm = scratch;                  // [heads][n]: split j's max, weight
  float* wl = scratch + k.heads * n;    // [heads][n]: split j's sum
  for (int i = threadIdx.x; i < k.heads * n; i += kThreads) {
    const int g = i / n, j = i - g * n;
    const float* st = all + j * split_stride + static_cast<size_t>(g) * kState;
    wm[i] = __ldcg(st + D);
    wl[i] = __ldcg(st + D + 1);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < k.heads; g += kThreads) {
    float m = kLowest;
    for (int j = 0; j < n; ++j) m = fmaxf(m, wm[g * n + j]);
    float l = 0.f;
    for (int j = 0; j < n; ++j) {  // a split with no live rows weighs 0
      const float w = expf(wm[g * n + j] - m);
      wm[g * n + j] = w;
      l = fmaf(w, wl[g * n + j], l);
    }
    const float r = k.kvs / l;  // int8: V's scale
    for (int j = 0; j < n; ++j) wm[g * n + j] *= r;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k.heads * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    const float* st = all + static_cast<size_t>(g) * kState + d;
    float a = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float w = wm[g * n + j];
      if (w != 0.f) a = fmaf(w, __ldcg(st + j * split_stride), a);  // live
    }
    out[i] = from_f<T>(a);
  }
}

constexpr int kChunk = 8;  // query heads a block serves, at most

// Dynamic shared memory of the warp kernel: the ring (which holds the
// warps' states at the end), q, the block's state per head, the merge's
// scratch, a paged block's slice of the table.
template <typename T, typename TC, int D>
constexpr int warp_smem_bytes(int heads, int splits, int slice) {
  using Sh = Shape<TC, D>;
  return Sh::kRingBytes +
         heads * Sh::kParts * q_stride<T, TC, D>() * static_cast<int>(sizeof(T)) +
         heads * (D + 2) * 4 + 2 * heads * splits * 4 + slice * 4;
}

// A chunk of at most kChunk heads of a group: warp w takes rows
// [w * kRw, (w + 1) * kRw) of every stage for all heads, lane (row, part)
// scoring its part and the row's kParts lanes adding by shuffles; the warp's
// online softmax runs over its rows by shuffles and its running max, sum
// and acc (lane l: head dims [l * C, (l + 1) * C)) stay in registers. One
// block barrier a stage (the ring); the warps merge once, at the end.
// Two blocks an SM (at most 128 registers a thread): a group of 1 at 8k
// rows has ~2 blocks per SM streaming. kH: the most heads (1, with q in
// registers, for LLaMA-7B's group of 1; or kChunk). kPaged: the rows'
// addressing (see the top of this file).
template <typename T, typename TC, int D, int kH, bool kPaged>
__global__ void __launch_bounds__(kThreads, 2)
    flash_decode_kernel(const Params p) {
  using Sh = Shape<TC, D>;
  constexpr int kParts = Sh::kParts, kPart = Sh::kPart, C = Sh::kC;
  constexpr int kRw = Sh::kRows / kWarps;  // rows of a stage a warp takes
  static_assert(kRw * kParts == 32, "a warp covers whole rows");
  static_assert(kWarps * kH * (D + 2) * 4 <= Sh::kRingBytes,
                "the warps' states fit the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  const Block k = block_of<TC, D, kPaged>(p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int part = lane % kParts;
  const int r = warp * kRw + lane / kParts;  // this lane's row of a stage
  constexpr int kQs = q_stride<T, TC, D>();
  unsigned char* ring = smem;
  T* qs = reinterpret_cast<T*>(smem + Sh::kRingBytes);
  float* fin = reinterpret_cast<float*>(qs + k.heads * kParts * kQs);  // [heads][D]
  float* mx = fin + k.heads * D;
  float* sm = mx + k.heads;
  float* scratch = sm + k.heads;
  int* tbl = reinterpret_cast<int*>(scratch + 2 * k.heads * k.n_split);
  if constexpr (kPaged) {  // the split's slice of the table, then the
                           // write past it
    const int n_e = k.n_st > 0 ? (k.row_end - 1) / p.bs - k.e0 + 1 : 0;
    for (int e = threadIdx.x; e < n_e; e += kThreads) {
      const int blk =
          p.tables[static_cast<size_t>(k.b) * p.mb + k.e0 + e];
      tbl[e] = blk < 0 ? p.trash : blk;
    }
    write_past_table<T, TC, D>(p, k);
    __syncthreads();
  }
  float qr[kH == 1 ? kPart : 1];  // a group of 1: this lane's part of q
  if constexpr (kH == 1) {
    const T* qg = static_cast<const T*>(p.q) +
                  (static_cast<size_t>(k.b) * p.Hq + k.hk * k.group + k.g0) *
                      D +
                  part * kPart;
#pragma unroll
    for (int j = 0; j < kPart; ++j) qr[j] = to_f(qg[j]);
  } else {
    load_q<T, TC, D>(p, k, qs);
  }
  const float qk_scale = p.sm_scale * k.kvs;

  float m[kH], l[kH], acc[kH][C];
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    m[h] = kLowest;
    l[h] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[h][c] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < k.n_st) load_stage<T, TC, D, kPaged>(p, k, tbl, ring, i);
    gemm::cp_async_commit();
  }
  for (int i = 0; i < k.n_st; ++i) {
    gemm::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; every warp is done with stage i - 1
    if (i + kStages - 1 < k.n_st)
      load_stage<T, TC, D, kPaged>(p, k, tbl, ring, i + kStages - 1);
    gemm::cp_async_commit();  // (an empty group keeps the count)
    const unsigned char* ks = ring + (i % kStages) * Sh::kStageBytes;
    const unsigned char* vs = ring + (kStages + i % kStages) * Sh::kStageBytes;
    const bool valid = k.row_begin + i * Sh::kRows + r < k.row_end;
    float kx[kPart];
    load_raw<TC, kPart>(
        reinterpret_cast<const TC*>(ks + r * Sh::kStride) + part * kPart, kx);
    float pv[kH];
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      pv[h] = 0.f;
      if (h < k.heads) {  // warp-uniform
        float s = 0.f;
        if constexpr (kH == 1) {
#pragma unroll
          for (int j = 0; j < kPart; ++j) s = fmaf(qr[j], kx[j], s);
        } else {
          s = dot_part<T, kPart>(qs + (h * kParts + part) * kQs, kx);
        }
#pragma unroll
        for (int o = kParts / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        s = !valid ? neg_infinity() : k.uniform ? 0.f : s * qk_scale;
        float mt = s;  // the max over the warp's rows (-inf if none live)
#pragma unroll
        for (int o = kParts; o < 32; o <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m[h], mt);
        const float e = expf(s - m_new);
        float es = e;  // each row once: lanes of one part, all rows
#pragma unroll
        for (int o = kParts; o < 32; o <<= 1)
          es += __shfl_xor_sync(0xffffffffu, es, o);
        const float a = expf(m[h] - m_new);
        l[h] = fmaf(l[h], a, es);
        m[h] = m_new;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[h][c] *= a;
        pv[h] = e;
      }
    }
#pragma unroll
    for (int rr = 0; rr < kRw; ++rr) {
      float v[C];
      load_raw<TC, C>(reinterpret_cast<const TC*>(
                          vs + (warp * kRw + rr) * Sh::kStride) + lane * C,
                      v);
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        if (h < k.heads) {
          const float ph = __shfl_sync(0xffffffffu, pv[h], rr * kParts);
#pragma unroll
          for (int c = 0; c < C; ++c) acc[h][c] = fmaf(ph, v[c], acc[h][c]);
        }
      }
    }
  }
  gemm::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' states go there

  float* wst = reinterpret_cast<float*>(ring);  // [kWarps][heads][D + 2]
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    if (h < k.heads) {
      float* w = wst + (warp * k.heads + h) * (D + 2);
#pragma unroll
      for (int c = 0; c < C; ++c) w[lane * C + c] = acc[h][c];
      if (lane == 0) {
        w[D] = m[h];
        w[D + 1] = l[h];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k.heads * D; i += kThreads) {
    const int h = i / D, d = i - h * D;
    float mm = kLowest;
    for (int w = 0; w < kWarps; ++w)
      mm = fmaxf(mm, wst[(w * k.heads + h) * (D + 2) + D]);
    float a = 0.f, ll = 0.f;
    for (int w = 0; w < kWarps; ++w) {  // a warp with no rows weighs 0
      const float* st = wst + (w * k.heads + h) * (D + 2);
      const float e = expf(st[D] - mm);
      a = fmaf(e, st[d], a);
      ll = fmaf(e, st[D + 1], ll);
    }
    fin[i] = a;
    if (d == 0) {
      mx[h] = mm;
      sm[h] = ll;
    }
  }
  merge_splits<T, D>(p, k, mx, sm, fin, scratch);
}

// Pointers and sizes of one launch (the cache pointers are the layer's).
struct Args {
  const void* q;
  const void* k_new;
  const void* v_new;
  void* kc;
  void* vc;
  const void* kv_scale;
  const void* positions;
  void* out;
  void* part;      // the workspace (null at one split)
  void* counters;
  int B, Hq, Hkv, S;
  int splits, tps;
  float sm_scale;
  cudaStream_t stream;
  bool read_only;  // row 8 (k_new / v_new null, positions the lengths)
  // paged pools (row 14): tables [B, mb] (null for a dense cache), the
  // block size, the trash block, the table entries a block's slice holds
  const void* tables;
  int mb, bs, trash, slice;
};

template <typename K>
cudaError_t launch_grid(K kernel, const Args& a, int chunks, int smem,
                        const Params& prm) {
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.Hkv * chunks, a.B), kThreads, smem, a.stream>>>(
      prm);
  return cudaGetLastError();
}

// A group of more than kChunk heads is cut into balanced chunks of at most
// kChunk along grid y (Falcon-7B's 71 as 8 x 8 + 7), each chunk's block
// reading its split's K/V again (from L2: 0.27 MB at Falcon-7B's 1038 rows).
template <typename T, typename TC, int D, bool kPaged>
cudaError_t launch(const Args& a) {
  const int group = a.Hq / a.Hkv;
  const int chunks = (group + kChunk - 1) / kChunk;
  const int heads = (group + chunks - 1) / chunks;
  const Params prm{a.q,  a.k_new, a.v_new, a.kc, a.vc,
                   static_cast<const float*>(a.kv_scale),
                   static_cast<const int*>(a.positions),
                   a.out, static_cast<float*>(a.part),
                   static_cast<int*>(a.counters),
                   a.Hq, a.Hkv, a.S, a.tps, heads, a.sm_scale,
                   a.read_only, static_cast<const int*>(a.tables), a.mb,
                   a.bs, a.trash, a.slice};
  const int smem = warp_smem_bytes<T, TC, D>(heads, a.splits,
                                             kPaged ? a.slice : 0);
  if (heads == 1)
    return launch_grid(flash_decode_kernel<T, TC, D, 1, kPaged>, a, chunks,
                       smem, prm);
  return launch_grid(flash_decode_kernel<T, TC, D, kChunk, kPaged>, a, chunks,
                     smem, prm);
}

template <typename T, typename TC, bool kPaged>
cudaError_t launch_d(int D, const Args& a) {
  switch (D) {
    case 32:
      return launch<T, TC, 32, kPaged>(a);
    case 64:
      return launch<T, TC, 64, kPaged>(a);
    case 96:
      return launch<T, TC, 96, kPaged>(a);
    case 128:
      return launch<T, TC, 128, kPaged>(a);
    case 256:
      return launch<T, TC, 256, kPaged>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// What a cache holds (the wrappers' cache kind codes): the activation
// type, int8 codes or e4m3 codes.
enum CacheKind : int { kCacheFloat = 0, kCacheInt8 = 1, kCacheE4M3 = 2 };

template <typename T, bool kPaged>
cudaError_t launch_kind(int kind, int D, const Args& a) {
  if (kind == kCacheFloat) return launch_d<T, T, kPaged>(D, a);
  if (kind == kCacheInt8) return launch_d<T, int8_t, kPaged>(D, a);
  if (kind == kCacheE4M3) return launch_d<T, __nv_fp8_e4m3, kPaged>(D, a);
  return cudaErrorInvalidValue;
}

// dtype: the activation code (kF32 / kBF16 / kF16); kind: the cache's
// (CacheKind; int8 and e4m3 take the layer's scale). The splits must cover
// the S rows in whole 64-row tiles with none empty, at most kMaxSplits of
// them; more than one needs the workspace. Paged: S = mb * bs, and a slice
// holds the table entries that tps tiles starting anywhere span.
template <bool kPaged>
cudaError_t dispatch(int dtype, int kind, int D, const Args& a) {
  const int tiles = (a.S + kTile - 1) / kTile;
  if (a.splits < 1 || a.splits > kMaxSplits || a.tps < 1 ||
      a.splits * a.tps < tiles || (a.splits - 1) * a.tps >= tiles ||
      a.Hkv < 1 || a.Hq % a.Hkv != 0 ||
      (a.splits > 1 && (a.part == nullptr || a.counters == nullptr)) ||
      (kind != kCacheFloat && a.kv_scale == nullptr))
    return cudaErrorInvalidValue;
  if (kPaged && (a.tables == nullptr || a.read_only || a.bs < 1 ||
                 a.mb < 1 || a.mb * a.bs != a.S || a.trash < 0 ||
                 a.slice < (a.tps * kTile + a.bs - 1) / a.bs + 1))
    return cudaErrorInvalidValue;
  if (dtype == kBF16) return launch_kind<__nv_bfloat16, kPaged>(kind, D, a);
  if (dtype == kF16) return launch_kind<__half, kPaged>(kind, D, a);
  if (dtype == kF32) return launch_kind<float, kPaged>(kind, D, a);
  return cudaErrorInvalidValue;
}

}  // namespace flash_decode
}  // namespace tllm
