// K3b: int16-pair transfer packing and its inverse, on Hopper.
//
// Replaces claxon_tpu/ops/epilogue.py::pack_int16_pairs and
// unpack_int16_pairs (parts of the XLA bucket programs on the TPU).
//
//   pack:   (L, T) int32, T even -> (L, T/2) int32 words,
//           word[l, w] = (x[l, 2w+1] << 16) | (x[l, 2w] & 0xFFFF)
//           (the shift wraps), plus an overflow flag: 1 when any element
//           of the bucket (scalar flag) or of the lane (per-lane flags)
//           lies outside [-32768, 32767], padding included, else 0.
//   unpack: (L, W) int32 words -> (L, 2W) int32, sign-extended halves,
//           low half first.
//
// What bounds them on this card: device-memory bandwidth. Pack reads
// every sample once and writes half as many bytes; unpack the reverse.
// Rows are contiguous, so a thread moves one 16-byte and one 8-byte
// vector (four samples, two words) where the row width allows it, and one
// 8-byte and one 4-byte access otherwise; neighbouring threads touch
// neighbouring addresses. Pack's blocks each stay inside one lane, so the
// flag costs one block-wide OR (__syncthreads_or) and at most one
// atomicOr per block, made only when a sample overflowed. The flags are
// zeroed on the launch stream before the kernel.
//
// Both data pointers must be 16-byte aligned (the wrapper checks).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int pack_word(int v0, int v1) {
  return (int)(((unsigned)v1 << 16) | ((unsigned)v0 & 0xFFFFu));
}

__device__ __forceinline__ bool leaves_int16(int v) {
  return v > 32767 || v < -32768;
}

// One block covers `kThreads` items of one lane; an item is VEC words
// (2 * VEC samples). items = T / (2 * VEC) per lane.
template <int VEC>
__global__ void pack_kernel(const int* __restrict__ x, int64_t items,
                            int64_t blocks_per_lane, int per_lane,
                            int* __restrict__ words, int* __restrict__ flag) {
  const int64_t lane = blockIdx.x / blocks_per_lane;
  const int64_t i = (blockIdx.x - lane * blocks_per_lane) * kThreads
      + threadIdx.x;
  int oob = 0;
  if (i < items) {
    const int64_t at = lane * items + i;
    if (VEC == 2) {
      const int4 v = reinterpret_cast<const int4*>(x)[at];
      oob = leaves_int16(v.x) | leaves_int16(v.y) | leaves_int16(v.z)
          | leaves_int16(v.w);
      reinterpret_cast<int2*>(words)[at] =
          make_int2(pack_word(v.x, v.y), pack_word(v.z, v.w));
    } else {
      const int2 v = reinterpret_cast<const int2*>(x)[at];
      oob = leaves_int16(v.x) | leaves_int16(v.y);
      words[at] = pack_word(v.x, v.y);
    }
  }
  const int any = __syncthreads_or(oob);
  if (any && threadIdx.x == 0) atomicOr(flag + (per_lane ? lane : 0), 1);
}

// Flat over all words: n items of VEC words each.
template <int VEC>
__global__ void unpack_kernel(const int* __restrict__ words, int64_t n,
                              int* __restrict__ out) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    if (VEC == 2) {
      const int2 w = reinterpret_cast<const int2*>(words)[i];
      reinterpret_cast<int4*>(out)[i] = make_int4(
          (int)(short)w.x, w.x >> 16, (int)(short)w.y, w.y >> 16);
    } else {
      const int w = words[i];
      reinterpret_cast<int2*>(out)[i] = make_int2((int)(short)w, w >> 16);
    }
  }
}

}  // namespace

// x (L, T) int32 -> words (L, T/2) int32; flag: 1 int32, or L with
// per_lane. T must be even.
extern "C" int cxk_pack_int16_pairs(const int* x, int64_t L, int64_t T,
                                    int64_t per_lane, int* words, int* flag,
                                    void* cuda_stream) {
  cudaStream_t stream = (cudaStream_t)cuda_stream;
  if (T % 2) return (int)cudaErrorInvalidValue;
  const int64_t n_flags = per_lane ? L : 1;
  if (n_flags > 0) {
    cudaError_t err = cudaMemsetAsync(flag, 0, n_flags * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (L > 0 && T > 0) {
    const int vec = T % 4 == 0 ? 2 : 1;
    const int64_t items = T / (2 * vec);
    const int64_t bpl = (items + kThreads - 1) / kThreads;
    if (L * bpl > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)(L * bpl);
    if (vec == 2)
      pack_kernel<2><<<grid, kThreads, 0, stream>>>(
          x, items, bpl, per_lane != 0, words, flag);
    else
      pack_kernel<1><<<grid, kThreads, 0, stream>>>(
          x, items, bpl, per_lane != 0, words, flag);
  }
  return (int)cudaGetLastError();
}

// words (n_words,) int32, flat -> out (2 * n_words,) int32.
extern "C" int cxk_unpack_int16_pairs(const int* words, int64_t n_words,
                                      int* out, void* cuda_stream) {
  if (n_words > 0) {
    const int vec = n_words % 2 == 0 ? 2 : 1;
    const int64_t n = n_words / vec;
    const int64_t want = (n + kThreads - 1) / kThreads;
    const unsigned grid = (unsigned)(want < 65536 ? want : 65536);
    cudaStream_t stream = (cudaStream_t)cuda_stream;
    if (vec == 2)
      unpack_kernel<2><<<grid, kThreads, 0, stream>>>(words, n, out);
    else
      unpack_kernel<1><<<grid, kThreads, 0, stream>>>(words, n, out);
  }
  return (int)cudaGetLastError();
}
