// Decode probes: one tiny kernel per layout fact that the weight decodes
// rely on, each compared exactly with its plain PyTorch version
// (ops/kernels/probes.py).
//
// Replaces the JAX package's TPU probes:
//   scripts/probe_int4_kernel.py::probe_bitcast_u32_bf16 (row 15),
//   ::probe_u16_ops (row 16), ::probe_u32_bf16_construct (row 17), and the
//   kernels of tests/test_tpu_kernels.py::test_fp8_decode_exact_on_chip
//   (row 18, _decode_fp8_block over all 256 e4m3 codes) and
//   ::test_fp8_planes_decode_exact_on_chip (row 19, _decode_fp8_planes of
//   the interleaved layout).
// On the TPU they pinned Mosaic's bitcast and lane semantics; here they pin
// the same facts for Hopper's registers and, for rows 18-19, run every code
// through the very __device__ functions the GEMV decodes with
// (woq_gemv.cuh: fp8x2, int8_code, int4_word, int4_codes, slot_of;
// woq_gemv_tc.cuh: the pair decoders), so a change there shows up in the
// probe.
//
//   15  each uint32 read as __nv_bfloat162: .x is the low half (little
//       endian), written to row 2r, .y (high half) to row 2r + 1;
//   16  ((w >> 2) & 0x00780078) | 0x43004300 on packed 16-bit pairs equals
//       the 16-bit lane formula ((v >> 2) & 0x78) | 0x4300 on each half:
//       the two bits that cross between the halves are masked off;
//   17  ((w << 3) & 0x00780078) | 0x43004300 plants the nibbles at bits
//       0-3 and 16-19 as the two bf16 128 + 8 n;
//   18  all 256 e4m3 codes (fp8x2), all 256 int8 codes (int8_code) and all
//       256 int4 nibble pairs (int4_word, the one-row GEMV's; int4_codes,
//       the GEMM's, must agree) decoded exactly; and the same
//       codes through the tensor-core body's pair decoders
//       (woq_gemv_tc.cuh: int8_pair, int4_pair, fp8_pair) into bf16 and
//       fp16 pairs, every code in the low and in the high half;
//   19  an e4m3 block stored interleaved (interleave_fp8_rows) read back in
//       logical row order through slot_of<kFp8>.
// And the fp8 KV cache's codec, which no TPU kernel had (the JAX package
// runs fp8 caches on XLA): values through the split-cache decode's
// KVCodec<__nv_fp8_e4m3>::enc (common.cuh) at a given scale, and all 256
// codes through its dec and through flash_decode.cuh's load_raw (four
// codes a word, and one at a time), against ops/fp8.py's fp8_encode /
// fp8_decode.
// Each is a few bytes; what bounds them is the launch.
#include "flash_decode.cuh"
#include "woq_gemv_tc.cuh"

using namespace tllm;

namespace {

constexpr int kThreads = 256;

enum SwarOp : int { kBitcast = 0, kU16Ops = 1, kConstruct = 2 };

// words [rows, cols] -> out bf16 [2 rows, cols] (low halves on even rows).
template <int OP>
__global__ void swar_bf16_kernel(const uint32_t* __restrict__ words,
                                 __nv_bfloat16* __restrict__ out, int rows,
                                 int cols) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * cols) return;
  const int r = i / cols;
  const int c = i - r * cols;
  uint32_t v = words[i];
  if constexpr (OP == kU16Ops) v = ((v >> 2) & 0x00780078u) | 0x43004300u;
  if constexpr (OP == kConstruct) v = ((v << 3) & 0x00780078u) | 0x43004300u;
  const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&v);
  out[static_cast<size_t>(2 * r) * cols + c] = pair.x;
  out[static_cast<size_t>(2 * r + 1) * cols + c] = pair.y;
}

// 4 code bytes per word -> fp8 [4 n], int8 [4 n], int4 [4 n, 2] (lo, hi).
__global__ void gemv_decodes_kernel(const uint32_t* __restrict__ words,
                                    float* __restrict__ fp8,
                                    float* __restrict__ int8,
                                    float* __restrict__ int4, int n_words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_words) return;
  const uint32_t w = words[i];
  float f[4], lo4[4], hi4[4];
  gemv::fp8x2(w, f[0], f[1]);
  gemv::fp8x2(w >> 16, f[2], f[3]);
  gemv::int4_word(w, lo4, hi4);          // the one-row GEMV's int4 decode
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    fp8[4 * i + j] = f[j];
    int8[4 * i + j] = gemv::int8_code(w, j);
    // the GEMM's int4 decode must agree with it: a difference leaves NaN
    float lo, hi;
    gemv::int4_codes(w, j, lo, hi);
    int4[2 * (4 * i + j)] = lo == lo4[j] ? lo4[j] : nanf("");
    int4[2 * (4 * i + j) + 1] = hi == hi4[j] ? hi4[j] : nanf("");
  }
}

// The pair decoders of one dtype: word i's byte j (low half) beside byte
// j of word (i + n / 2) % n (high half) as int8 and e4m3 codes, and its two
// nibbles as an int4 pair -> out [3][4 n] 32-bit pairs (int8, int4, fp8).
template <typename T>
__device__ __forceinline__ void tc_pairs(const uint32_t* words, uint32_t* out,
                                         int i, int n_words) {
  const uint32_t w = words[i];
  const uint32_t v = words[(i + n_words / 2) % n_words];
  const size_t n4 = 4 * static_cast<size_t>(n_words);
  const gemv_tc::Plants c = gemv_tc::kPlants;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[4 * i + j] = gemv_tc::int8_pair<T>(w, v, j, c);
    out[n4 + 4 * i + j] = gemv_tc::int4_pair<T>(w, j, c);
    out[2 * n4 + 4 * i + j] = gemv_tc::fp8_pair<T>(w, v, j);
  }
}

// words [n_words] -> out [2 (bf16, fp16)][3][4 n_words] 32-bit pairs.
__global__ void tc_pairs_kernel(const uint32_t* __restrict__ words,
                                uint32_t* __restrict__ out, int n_words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_words) return;
  tc_pairs<__nv_bfloat16>(words, out, i, n_words);
  tc_pairs<__half>(words, out + 12 * static_cast<size_t>(n_words), i, n_words);
}

// q: e4m3 codes [K, N] stored interleaved by blk -> out f32 [K, N] in
// logical row order; one thread per logical row and 4 columns.
__global__ void fp8_planes_kernel(const uint8_t* __restrict__ q,
                                  float* __restrict__ out, int K, int N,
                                  int blk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n4 = N / 4;
  if (i >= K * n4) return;
  const int kk = i / n4;
  const int c = (i - kk * n4) * 4;
  const int stored = gemv::slot_of<gemv::kFp8>(kk, blk);
  const uint32_t w = *reinterpret_cast<const uint32_t*>(
      q + static_cast<size_t>(stored) * N + c);
  float f[4];
  gemv::fp8x2(w, f[0], f[1]);
  gemv::fp8x2(w >> 16, f[2], f[3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[static_cast<size_t>(kk) * N + c + j] = f[j];
}

// codes[i] = enc(values[i], scale) for i < n; for the 256 codes c:
// dec[c] = dec(c, scale), raw[c] = load_raw's value of c read four codes a
// word, raw[256 + c] read alone.
__global__ void kv_codec_kernel(const float* __restrict__ values,
                                const float* __restrict__ scale,
                                uint8_t* __restrict__ codes,
                                float* __restrict__ dec,
                                float* __restrict__ raw, int n) {
  using E = __nv_fp8_e4m3;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float s = *scale;
  if (i < n) codes[i] = KVCodec<E>::enc(values[i], s).__x;
  if (i < 256 / 4) {  // word i holds codes 4 i .. 4 i + 3, low byte first
    const uint32_t w = 0x03020100u + 0x04040404u * static_cast<uint32_t>(i);
    float x4[4];
    flash_decode::load_raw<E, 4>(reinterpret_cast<const E*>(&w), x4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      E c;
      c.__x = static_cast<__nv_fp8_storage_t>(4 * i + j);
      float x1[1];
      flash_decode::load_raw<E, 1>(&c, x1);
      dec[4 * i + j] = KVCodec<E>::dec(c, s);
      raw[4 * i + j] = x4[j];
      raw[256 + 4 * i + j] = x1[0];
    }
  }
}

unsigned blocks_for(int n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

template <int OP>
int launch_swar(const void* words, void* out, int rows, int cols, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  swar_bf16_kernel<OP><<<blocks_for(rows * cols), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<__nv_bfloat16*>(out),
      rows, cols);
  return cudaGetLastError();
}

}  // namespace

// words uint32 [rows, cols] -> out bf16 [2 rows, cols].
extern "C" int tllm_probe_bitcast_u32_bf16(const void* words, void* out,
                                           int rows, int cols, int device,
                                           void* stream) {
  return launch_swar<kBitcast>(words, out, rows, cols, device, stream);
}

extern "C" int tllm_probe_u16_ops(const void* words, void* out, int rows,
                                  int cols, int device, void* stream) {
  return launch_swar<kU16Ops>(words, out, rows, cols, device, stream);
}

extern "C" int tllm_probe_u32_bf16_construct(const void* words, void* out,
                                             int rows, int cols, int device,
                                             void* stream) {
  return launch_swar<kConstruct>(words, out, rows, cols, device, stream);
}

// words uint32 [n_words] (4 code bytes each) -> fp8 f32 [4 n], int8 f32
// [4 n], int4 f32 [4 n, 2].
extern "C" int tllm_probe_gemv_decodes(const void* words, void* fp8,
                                       void* int8, void* int4, int n_words,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  gemv_decodes_kernel<<<blocks_for(n_words), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<float*>(fp8),
      static_cast<float*>(int8), static_cast<float*>(int4), n_words);
  return cudaGetLastError();
}

// words uint32 [n_words] -> out uint32 [2][3][4 n_words] (bf16 then fp16
// pairs of int8, int4 and e4m3 codes).
extern "C" int tllm_probe_tc_pairs(const void* words, void* out, int n_words,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  tc_pairs_kernel<<<blocks_for(n_words), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out),
      n_words);
  return cudaGetLastError();
}

// q uint8 [K, N] (rows interleaved by blk, N % 4 == 0) -> out f32 [K, N].
extern "C" int tllm_probe_fp8_planes(const void* q, void* out, int K, int N,
                                     int blk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  fp8_planes_kernel<<<blocks_for(K * (N / 4)), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<float*>(out), K, N, blk);
  return cudaGetLastError();
}

// values f32 [n], scale f32 [1] -> codes uint8 [n], dec f32 [256], raw f32
// [2, 256].
extern "C" int tllm_probe_kv_codec(const void* values, const void* scale,
                                   void* codes, void* dec, void* raw, int n,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  kv_codec_kernel<<<blocks_for(n > 64 ? n : 64), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(values), static_cast<const float*>(scale),
      static_cast<uint8_t*>(codes), static_cast<float*>(dec),
      static_cast<float*>(raw), n);
  return cudaGetLastError();
}
