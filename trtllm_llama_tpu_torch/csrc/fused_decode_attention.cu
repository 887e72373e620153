// Row 9: one-token decode attention fused with the in-place KV-cache write,
// in one launch with no split over the cache, over one layer of the stacked
// cache [B, Hkv, S, D].
//
// Replaces: trtllm_llama_tpu/ops/pallas/attention.py::fused_decode_attention
// (the 'fused' decode mode).
//
// Computes kernel 3's function (decode_attention.cuh): with pos =
// positions[b], row pos = enc(k_new[b]) (likewise v; dropped when pos >= S),
// then out[b, h] = softmax_f32((q[b, h] . dec(K[j])) * sm_scale, j <= pos) @
// dec(V) over the rows as stored, all S rows when pos >= S. An int8 cache
// stores clamp(rint(x / scale), +-127), a true division as the JAX package's
// _quant_kv (its Pallas kernel multiplies by 1/scale, which may move a code by
// one), and reads c * scale in f32.
//
// What bounds it on the H100: the live K/V bytes, 2 * B * Hkv * (pos + 1) *
// D * sizeof(cache element). Design: blocks of 16 warps per (kv head, b),
// each covering up to kHeadsPerBlock query heads of the GQA group (one
// block for LLaMA-7B's group of 1; Falcon-7B's 71 heads in 9 blocks of 8,
// a group of 32 in 4); no partials in device memory and no combine launch.
//   1. Block 0 of each (b, kv head) stores row pos. No block reads row pos
//      from the cache: each decodes its own copy of the stored row,
//      dec(enc(k_new)), into shared memory, so the one write races no
//      reader and the blocks need no barrier between them.
//   2. Warp w walks the 32-row tiles w, w + 16, ... of the rows before pos
//      (all S rows when pos >= S); the warp after the last tile's then
//      adds row pos from shared memory to its states. For each tile and
//      each query head of the block, a lane holds D/32 adjacent head dims:
//      it forms its partial dot product with every row of the tile (one
//      vector load per row, a warp reads a whole row), and a transposing
//      butterfly (31 shuffles) leaves row j's score in lane j. The head's
//      running max, sum and D accumulators of this warp live in shared
//      memory.
//   3. The block merges its warps' states and divides.
// At LLaMA-7B's 32 kv heads and batch 1 a launch has 32 blocks for 132 SMs:
// one launch instead of kernel 3's two, at the price of a fill of the card
// that does not grow with the cache (the JAX 'fused' mode's own trade).
#include "decode_attention.cuh"

using namespace tllm;

namespace {

constexpr int kWarps = 16;
constexpr int kHeadsPerBlock = 8;  // query heads of the group a block covers
constexpr int kTile = 32;  // cache rows a warp scores at a time (one per lane)

// The alignment of n bytes read as one vector: their lowest set bit (a power
// of two; 12 bytes at D = 96, f32, read as three words), at most 16 (the
// widest load; 32 bytes at D = 256, f32, read as two).
constexpr size_t pack_align(size_t n) {
  return (n & (~n + 1)) < 16 ? (n & (~n + 1)) : 16;
}

template <typename E, int N>
struct alignas(pack_align(sizeof(E) * N)) Pack {
  E v[N];
};

// x[i] = dec(p[i]) for the N elements at p, read as one vector.
template <typename E, int N>
__device__ __forceinline__ void load_dec(const E* p, float scale,
                                         float (&x)[N]) {
  const Pack<E, N> pk = *reinterpret_cast<const Pack<E, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = decode::KVCodec<E>::dec(pk.v[i], scale);
}

// One level of transpose_sum: lanes W apart swap the halves of v[0, 2W) they
// do not keep (the upper half stays with the lane whose bit W is set).
template <int W>
__device__ __forceinline__ void transpose_level(float (&v)[32], int lane) {
  const bool upper = lane & W;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float send = upper ? v[j] : v[j + W];
    const float keep = upper ? v[j + W] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// v[j] of every lane summed over the warp, returned in lane j (31 shuffles;
// every index is a compile-time constant, so v stays in registers).
__device__ __forceinline__ float transpose_sum(float (&v)[32], int lane) {
  transpose_level<16>(v, lane);
  transpose_level<8>(v, lane);
  transpose_level<4>(v, lane);
  transpose_level<2>(v, lane);
  transpose_level<1>(v, lane);
  return v[0];
}

template <typename T, typename TC, int D>
__global__ void __launch_bounds__(kWarps * 32)
    fused_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, TC* kc, TC* vc,
                        const float* __restrict__ kv_scale,
                        const int* __restrict__ positions, T* __restrict__ out,
                        int Hq, int Hkv, int S, float sm_scale, int heads) {
  using Codec = decode::KVCodec<TC>;
  constexpr int DL = D / 32;  // head dims per lane
  constexpr int ST = D + 2;   // a (warp, head) state: max, sum, acc[D]
  extern __shared__ float smem[];
  const int group = Hq / Hkv;
  const int g0 = blockIdx.z * heads;          // this block's first head
  const int gn = min(heads, group - g0);      // and its number of heads
  float* kpos = smem;                 // [D] row pos as stored, decoded
  float* vpos = kpos + D;             // [D]
  float* qs = vpos + D;               // [gn][D]
  float* state = qs + gn * D;         // [kWarps][gn][ST]

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pos = positions[b];
  const float kvs = kv_scale != nullptr ? *kv_scale : 1.f;
  const size_t panel = (static_cast<size_t>(b) * Hkv + hk) * S * D;
  const size_t head0 = (static_cast<size_t>(b) * Hq + hk * group + g0) * D;

  if (pos < S) {
    const size_t new_base = (static_cast<size_t>(b) * Hkv + hk) * D;
    const size_t row = panel + static_cast<size_t>(pos) * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      const TC kt = Codec::enc(to_f(k_new[new_base + d]), kvs);
      const TC vt = Codec::enc(to_f(v_new[new_base + d]), kvs);
      if (blockIdx.z == 0) {
        kc[row + d] = kt;
        vc[row + d] = vt;
      }
      kpos[d] = Codec::dec(kt, kvs);
      vpos[d] = Codec::dec(vt, kvs);
    }
  }
  for (int i = threadIdx.x; i < gn * D; i += blockDim.x)
    qs[i] = to_f(q[head0 + i]);
  for (int i = threadIdx.x; i < kWarps * gn * ST; i += blockDim.x)
    state[i] = i % ST == 0 ? kLowest : 0.f;
  __syncthreads();

  const int n_cache = pos < S ? pos : S;  // rows read from the cache
  const int n_tiles = (n_cache + kTile - 1) / kTile;
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int row0 = t * kTile;
    const int rows = min(kTile, n_cache - row0);
    const TC* kt = kc + panel + static_cast<size_t>(row0) * D + lane * DL;
    const TC* vt = vc + panel + static_cast<size_t>(row0) * D + lane * DL;
    for (int g = 0; g < gn; ++g) {
      float qv[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) qv[i] = qs[g * D + lane * DL + i];
      float part[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        part[j] = 0.f;
        if (j < rows) {
          float kx[DL];
          load_dec<TC, DL>(kt + j * D, kvs, kx);
#pragma unroll
          for (int i = 0; i < DL; ++i) part[j] = fmaf(qv[i], kx[i], part[j]);
        }
      }
      float s = transpose_sum(part, lane);
      s = lane < rows ? s * sm_scale : kNegInf;

      float* st = state + (warp * gn + g) * ST;
      const float m_old = st[0];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m_old - m_new);
      const float p_sum = warp_sum(p);
      float acc[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] = st[2 + lane * DL + i] * alpha;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        if (j < rows) {
          float vx[DL];
          load_dec<TC, DL>(vt + j * D, kvs, vx);
#pragma unroll
          for (int i = 0; i < DL; ++i) acc[i] = fmaf(pj, vx[i], acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < DL; ++i) st[2 + lane * DL + i] = acc[i];
      __syncwarp();  // every lane has read st[0] and st[1]
      if (lane == 0) {
        st[0] = m_new;
        st[1] = st[1] * alpha + p_sum;
      }
      __syncwarp();
    }
  }
  if (pos < S && warp == n_tiles % kWarps) {  // row pos, one row per head
    for (int g = 0; g < gn; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i)
        dot = fmaf(qs[g * D + lane * DL + i], kpos[lane * DL + i], dot);
      const float s = warp_sum(dot) * sm_scale;
      float* st = state + (warp * gn + g) * ST;
      const float m_old = st[0];
      const float m_new = fmaxf(m_old, s);
      const float p = expf(s - m_new);
      const float alpha = expf(m_old - m_new);
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        float& a = st[2 + lane * DL + i];
        a = fmaf(p, vpos[lane * DL + i], a * alpha);
      }
      __syncwarp();  // every lane has read st[0]
      if (lane == 0) {
        st[0] = m_new;
        st[1] = st[1] * alpha + p;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < gn * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    float mx = kLowest;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, state[(w * gn + g) * ST]);
    float l = 0.f, acc = 0.f;
    for (int w = 0; w < kWarps; ++w) {  // warps with no tile weigh exp(-huge)
      const float* st = state + (w * gn + g) * ST;
      const float e = expf(st[0] - mx);
      l = fmaf(e, st[1], l);
      acc = fmaf(e, st[2 + d], acc);
    }
    out[head0 + i] = from_f<T>(acc / l);
  }
}

template <typename T, typename TC, int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* kc, void* vc, const void* kv_scale,
                   const void* positions, void* out, int B, int Hq, int Hkv,
                   int S, float sm_scale, int heads, int smem,
                   cudaStream_t stream) {
  auto kernel = fused_decode_kernel<T, TC, D>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int splits = (Hq / Hkv + heads - 1) / heads;
  kernel<<<dim3(Hkv, B, splits), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<TC*>(kc), static_cast<TC*>(vc),
      static_cast<const float*>(kv_scale), static_cast<const int*>(positions),
      static_cast<T*>(out), Hq, Hkv, S, sm_scale, heads);
  return cudaGetLastError();
}

template <typename T, typename TC>
cudaError_t launch_d(int D, const void* q, const void* k_new, const void* v_new,
                     void* kc, void* vc, const void* kv_scale,
                     const void* positions, void* out, int B, int Hq, int Hkv,
                     int S, float sm_scale, int heads, int smem,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, TC, 32>(q, k_new, v_new, kc, vc, kv_scale, positions,
                               out, B, Hq, Hkv, S, sm_scale, heads, smem,
                               stream);
    case 64:
      return launch<T, TC, 64>(q, k_new, v_new, kc, vc, kv_scale, positions,
                               out, B, Hq, Hkv, S, sm_scale, heads, smem,
                               stream);
    case 96:
      return launch<T, TC, 96>(q, k_new, v_new, kc, vc, kv_scale, positions,
                               out, B, Hq, Hkv, S, sm_scale, heads, smem,
                               stream);
    case 128:
      return launch<T, TC, 128>(q, k_new, v_new, kc, vc, kv_scale, positions,
                                out, B, Hq, Hkv, S, sm_scale, heads, smem,
                                stream);
    case 256:
      return launch<T, TC, 256>(q, k_new, v_new, kc, vc, kv_scale, positions,
                                out, B, Hq, Hkv, S, sm_scale, heads, smem,
                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Hq, D], k_new/v_new [B, Hkv, D] (dtype), kc/vc: layer `layer` of the
// stacked cache, i.e. [B, Hkv, S, D] in dtype or, with kv_int8, int8 (the
// wrapper offsets the pointers; 16-byte aligned), kv_scale: that layer's f32
// dequant scale (int8 only, else null), positions [B] int32, out [B, Hq, D].
// D in {32, 64, 96, 128, 256}; any GQA group (kHeadsPerBlock heads per
// block, with (2 * D + heads * (D + 16 * (D + 2))) * 4 bytes of dynamic
// shared memory).
extern "C" int tllm_fused_decode_attention(
    const void* q, const void* k_new, const void* v_new, void* kc, void* vc,
    const void* kv_scale, const void* positions, void* out, int dtype,
    int kv_int8, int B, int Hq, int Hkv, int S, int D, float sm_scale,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int group = Hq / Hkv;
  const int splits = (group + kHeadsPerBlock - 1) / kHeadsPerBlock;
  const int heads = (group + splits - 1) / splits;  // balanced blocks
  const int smem = (2 * D + heads * (D + kWarps * (D + 2))) * 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TLLM_FUSED_ARGS                                                    \
  D, q, k_new, v_new, kc, vc, kv_scale, positions, out, B, Hq, Hkv, S,   \
      sm_scale, heads, smem, s
  if (dtype == kBF16)
    return kv_int8 ? launch_d<__nv_bfloat16, int8_t>(TLLM_FUSED_ARGS)
                   : launch_d<__nv_bfloat16, __nv_bfloat16>(TLLM_FUSED_ARGS);
  if (dtype == kF16)
    return kv_int8 ? launch_d<__half, int8_t>(TLLM_FUSED_ARGS)
                   : launch_d<__half, __half>(TLLM_FUSED_ARGS);
  if (dtype == kF32)
    return kv_int8 ? launch_d<float, int8_t>(TLLM_FUSED_ARGS)
                   : launch_d<float, float>(TLLM_FUSED_ARGS);
#undef TLLM_FUSED_ARGS
  return cudaErrorInvalidValue;
}
