// One-token decode attention over chunks of the cache, with partials in
// device memory and a combine launch: the body of kernel 14 alone
// (paged_decode_attention.cu, `paged_decode_attention`: a layer of the block
// pool [NB, Hkv, BS, D] with the in-place KV write, rows found through a
// block table). Kernel 3 and rows 8 and 9 run the one-launch split-cache
// kernel of flash_decode.cuh; kernel 14 is the next to follow. The
// addressing policy `Rows`:
//
//   Rows::cap                    rows a sequence can attend (MB * BS)
//   Rows::offset(b, hk, row)     element offset of a cache row, row < cap
//   Rows::write_offset(b, hk, pos)
//                                element offset of the row that receives the
//                                new token, or -1 where the write is dropped
//
// Computes, for each sequence b with write position pos = positions[b] and
// n_live = min(pos + 1, cap) attended rows:
//   row pos (at write_offset) = enc(k_new[b]); likewise v
//   out[b, h] = softmax_f32((q[b, h] . dec(K[j])) * sm_scale, j < n_live) @ dec(V)
// enc / dec are the cache codec of common.cuh (KVCodec: the dtype cast, or
// int8 codes with the layer's kv_scale read from device memory). Rows other
// than the write row are left unchanged.
//
// What bounds it on the H100: the K/V bytes of the live rows,
// 2 * B * Hkv * n_live * D * sizeof(cache element), at 3.35 TB/s (int8
// halves the bf16 bytes). Design (flash-decoding split-K over only the live
// chunks):
//   - launch 1: one block per (32-row chunk, kv head, b); blocks whose chunk
//     starts at or past n_live exit at once, so the work is O(pos), not
//     O(cap). The block looks up its 32 rows' offsets once, stages its chunk
//     of K/V in dynamic shared memory as f32 (K padded to D+1 columns; 66 KB
//     at D = 256), then one warp per query head of the GQA group computes
//     the chunk's scores (one key per lane), max, exp-sum and p @ V, and
//     writes (max, sum, acc[D]) as a partial.
//   - the write race: the row-pos write would race with blocks reading its
//     chunk. Only the block that owns pos's chunk touches row pos: it
//     encodes that row from k_new / v_new, stores it, and attends dec(stored)
//     -- the token exactly as the cache now holds it -- so it is the only
//     writer, and no other block reads row pos. A write past the attended
//     rows (pos >= cap, into the trash block) is made by the block of the
//     last live chunk, before it stages its rows.
//   - launch 2: one block per (b, h) rescales the live partials by
//     exp(m_c - max) and divides by the summed denominators.
#pragma once

#include "common.cuh"

namespace tllm {
namespace decode {

constexpr int kChunk = 32;   // cache rows per block (one per lane)
constexpr int kWarps = 4;

// The rows sequence b attends, from its write position v = positions[b].
struct Live {
  int n;    // rows attended, [0, n)
  int pos;  // the write row
};

template <typename Rows>
__device__ __forceinline__ Live live_rows(const Rows& rows, int v) {
  return {min(v + 1, rows.cap), v};
}

// The staged K (padded) and V of one chunk, f32: 66 KB at D = 256.
template <int D>
constexpr int partial_smem_bytes() {
  return kChunk * (2 * D + 1) * 4;
}

template <typename T, typename TC, int D, typename Rows>
__global__ void __launch_bounds__(kWarps * 32)
    decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                          const T* __restrict__ v_new, TC* __restrict__ kc,
                          TC* __restrict__ vc, const float* __restrict__ kv_scale,
                          const int* __restrict__ positions,
                          float* __restrict__ part_m, float* __restrict__ part_l,
                          float* __restrict__ part_acc, int Hq, int Hkv,
                          int n_chunks, float sm_scale, Rows rows) {
  using Codec = KVCodec<TC>;
  constexpr int DL = D / 32;
  extern __shared__ float decode_smem[];  // partial_smem_bytes<D>()
  auto ks = reinterpret_cast<float (*)[D + 1]>(decode_smem);
  auto vs = reinterpret_cast<float (*)[D]>(decode_smem + kChunk * (D + 1));
  __shared__ long long row_off[kChunk];

  const int c = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const Live live = live_rows(rows, positions[b]);
  const int pos = live.pos;
  const int n_live = live.n;
  const int row0 = c * kChunk;
  if (row0 >= n_live) return;  // chunk not live (whole block exits)

  const int group = Hq / Hkv;
  const size_t new_base = (static_cast<size_t>(b) * Hkv + hk) * D;
  const float kvs = kv_scale != nullptr ? *kv_scale : 1.f;
  const bool owner = (n_live - 1) / kChunk == c;  // last live chunk
  const long long w_off = owner ? rows.write_offset(b, hk, pos) : -1;

  if (pos >= rows.cap && w_off >= 0) {  // a write past the attended rows
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      kc[w_off + d] = Codec::enc(to_f(k_new[new_base + d]), kvs);
      vc[w_off + d] = Codec::enc(to_f(v_new[new_base + d]), kvs);
    }
  }
  if (threadIdx.x < kChunk) {
    const int row = row0 + threadIdx.x;
    row_off[threadIdx.x] = row < n_live ? rows.offset(b, hk, row) : -1;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kChunk * D; i += blockDim.x) {
    const int j = i / D, d = i - (i / D) * D, row = row0 + j;
    float kv = 0.f, vv = 0.f;
    if (row == pos) {  // only the owning block sees row == pos
      const TC kt = Codec::enc(to_f(k_new[new_base + d]), kvs);
      const TC vt = Codec::enc(to_f(v_new[new_base + d]), kvs);
      if (w_off >= 0) {
        kc[w_off + d] = kt;
        vc[w_off + d] = vt;
      }
      kv = Codec::dec(kt, kvs);
      vv = Codec::dec(vt, kvs);
    } else if (row < n_live) {
      const size_t off = static_cast<size_t>(row_off[j]) + d;
      kv = Codec::dec(kc[off], kvs);
      vv = Codec::dec(vc[off], kvs);
    }
    ks[j][d] = kv;
    vs[j][d] = vv;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int g = warp; g < group; g += kWarps) {
    const int h = hk * group + g;
    const T* qh = q + (static_cast<size_t>(b) * Hq + h) * D;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = fmaf(to_f(qh[d]), ks[lane][d], s);
    s = row0 + lane < n_live ? s * sm_scale : kNegInf;
    const float mx = warp_max(s);
    const float p = expf(s - mx);
    const float l = warp_sum(p);
    float acc[DL];
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] = fmaf(pj, vs[j][lane + 32 * i], acc[i]);
    }
    const size_t o = (static_cast<size_t>(b) * Hq + h) * n_chunks + c;
    if (lane == 0) {
      part_m[o] = mx;
      part_l[o] = l;
    }
#pragma unroll
    for (int i = 0; i < DL; ++i) part_acc[o * D + lane + 32 * i] = acc[i];
  }
}

// One block of D threads per (h, b).
template <typename T, int D, typename Rows>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      const int* __restrict__ positions,
                                      T* __restrict__ out, int Hq, int n_chunks,
                                      Rows rows) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int d = threadIdx.x;
  const int live = (live_rows(rows, positions[b]).n - 1) / kChunk + 1;
  const size_t base = (static_cast<size_t>(b) * Hq + h) * n_chunks;
  float mx = kLowest;
  for (int c = 0; c < live; ++c) mx = fmaxf(mx, part_m[base + c]);
  float l = 0.f, acc = 0.f;
  for (int c = 0; c < live; ++c) {
    const float w = expf(part_m[base + c] - mx);
    l = fmaf(w, part_l[base + c], l);
    acc = fmaf(w, part_acc[(base + c) * D + d], acc);
  }
  out[(static_cast<size_t>(b) * Hq + h) * D + d] = from_f<T>(acc / l);
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
  void* part_m;
  void* part_l;
  void* part_acc;
  int B, Hq, Hkv;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, typename TC, int D, typename Rows>
cudaError_t launch(const Args& a, const Rows& rows) {
  const int n_chunks = (rows.cap + kChunk - 1) / kChunk;
  constexpr int smem = partial_smem_bytes<D>();
  cudaError_t err = allow_smem(decode_partial_kernel<T, TC, D, Rows>, smem);
  if (err != cudaSuccess) return err;
  decode_partial_kernel<T, TC, D, Rows>
      <<<dim3(n_chunks, a.Hkv, a.B), kWarps * 32, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const T*>(a.k_new),
          static_cast<const T*>(a.v_new), static_cast<TC*>(a.kc),
          static_cast<TC*>(a.vc), static_cast<const float*>(a.kv_scale),
          static_cast<const int*>(a.positions), static_cast<float*>(a.part_m),
          static_cast<float*>(a.part_l), static_cast<float*>(a.part_acc), a.Hq,
          a.Hkv, n_chunks, a.sm_scale, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, D, Rows><<<dim3(a.Hq, a.B), D, 0, a.stream>>>(
      static_cast<const float*>(a.part_m), static_cast<const float*>(a.part_l),
      static_cast<const float*>(a.part_acc),
      static_cast<const int*>(a.positions), static_cast<T*>(a.out), a.Hq,
      n_chunks, rows);
  return cudaGetLastError();
}

template <typename T, typename TC, typename Rows>
cudaError_t launch_d(int D, const Args& a, const Rows& rows) {
  switch (D) {
    case 32:
      return launch<T, TC, 32>(a, rows);
    case 64:
      return launch<T, TC, 64>(a, rows);
    case 96:
      return launch<T, TC, 96>(a, rows);
    case 128:
      return launch<T, TC, 128>(a, rows);
    case 256:
      return launch<T, TC, 256>(a, rows);
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype: the activation code (kF32 / kBF16 / kF16); the cache holds that type or,
// with kv_int8, int8.
template <typename Rows>
cudaError_t dispatch(int dtype, bool kv_int8, int D, const Args& a,
                     const Rows& rows) {
  if (dtype == kBF16)
    return kv_int8 ? launch_d<__nv_bfloat16, int8_t>(D, a, rows)
                   : launch_d<__nv_bfloat16, __nv_bfloat16>(D, a, rows);
  if (dtype == kF16)
    return kv_int8 ? launch_d<__half, int8_t>(D, a, rows)
                   : launch_d<__half, __half>(D, a, rows);
  if (dtype == kF32)
    return kv_int8 ? launch_d<float, int8_t>(D, a, rows)
                   : launch_d<float, float>(D, a, rows);
  return cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace tllm
