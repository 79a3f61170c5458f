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
//
// interleave_runs: one bucket's lanes laid out as per-stream interleaved
// PCM in an arena on the card.
//
// Replaces no TPU kernel: the JAX package scatters each bucket's lanes
// into per-stream PCM on the host (claxon_tpu/pipeline.py,
// DeviceDecoded.to_host). It was added to take that host pass out of
// the port's to_host(): the card writes every stream's (samples,
// channels) int32 PCM in its final layout, and one device-to-host copy
// lands the arena in pinned memory that backs the results.
//
//   runs (R, 6) int64, one row a lane-plan run: (dst, nf, bs, nch, lane0,
//   frame0); for f < nf, s < bs, c < nch
//     arena[dst + (f * bs + s) * nch + c] = bucket[lane0 + f * nch + c, s],
//   frame0 being the run's first frame in the launch's frame order (the
//   running sum of nf). After the rows, each frame's run (n_frames
//   int64), so a block finds its run with one load.
//
// What bounds it: device-memory bandwidth. It reads each landed sample
// once and writes it once (a CD track, 85 MB each way: about 0.05 ms at
// 3.35 TB/s). A binary search over the runs, a chain of dependent loads
// in every block, held a mono batch of 512 runs to half the bound; the
// per-frame run index replaces it. Block (g, y) takes samples [1024 y, 1024 y + 1024) of frame
// g. Each thread reads 4 consecutive samples of each channel's lane (one
// 16-byte load a channel, neighbouring threads on neighbouring addresses)
// and writes them interleaved as nch 16-byte stores (two for stereo, one
// for mono). Where T, the frame's first word or bs * nch is not a multiple
// of 4, and for a frame's last bs % 4 samples, a scalar path writes one
// word a thread, consecutive threads on consecutive words. The bucket and
// the arena must be 16-byte aligned (the wrapper checks); the wrapper
// checks every run against both shapes.

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

constexpr int kRunCols = 6;
constexpr int kChunk = kThreads * 4;  // samples of one frame a block

// Samples s .. s + 3 of NCH lanes (row stride T) -> 4 * NCH words at
// dst + s * NCH, as NCH 16-byte stores.
template <int NCH>
__device__ __forceinline__ void interleave4(const int* __restrict__ src,
                                            int64_t T, int* __restrict__ dst,
                                            int64_t s) {
  int4 v[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
    v[c] = *reinterpret_cast<const int4*>(src + c * T + s);
  int w[4 * NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    w[c] = v[c].x;
    w[NCH + c] = v[c].y;
    w[2 * NCH + c] = v[c].z;
    w[3 * NCH + c] = v[c].w;
  }
  int4* out = reinterpret_cast<int4*>(dst + s * NCH);
#pragma unroll
  for (int j = 0; j < NCH; ++j)
    out[j] = make_int4(w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]);
}

__global__ void interleave_kernel(const int* __restrict__ bucket, int64_t T,
                                  const int64_t* __restrict__ runs, int64_t R,
                                  int* __restrict__ arena) {
  const int64_t g = blockIdx.x;
  const int64_t* row = runs + runs[R * kRunCols + g] * kRunCols;
  const int64_t bs = row[2], nch = row[3];
  const int64_t s0 = (int64_t)blockIdx.y * kChunk;
  if (s0 >= bs) return;
  const int64_t f = g - row[5];
  const int64_t s1 = bs < s0 + kChunk ? bs : s0 + kChunk;
  const int* src = bucket + (row[4] + f * nch) * T;
  const int64_t d0 = row[0] + f * bs * nch;
  int* dst = arena + d0;
  int64_t tail = s0;  // first sample the scalar path writes
  if (T % 4 == 0 && d0 % 4 == 0 && nch <= 8) {
    tail = s0 + (s1 - s0) / 4 * 4;
    const int64_t s = s0 + 4 * (int64_t)threadIdx.x;
    if (s < tail) {
      switch (nch) {
        case 1: interleave4<1>(src, T, dst, s); break;
        case 2: interleave4<2>(src, T, dst, s); break;
        case 3: interleave4<3>(src, T, dst, s); break;
        case 4: interleave4<4>(src, T, dst, s); break;
        case 5: interleave4<5>(src, T, dst, s); break;
        case 6: interleave4<6>(src, T, dst, s); break;
        case 7: interleave4<7>(src, T, dst, s); break;
        default: interleave4<8>(src, T, dst, s); break;
      }
    }
  }
  for (int64_t o = tail * nch + threadIdx.x; o < s1 * nch; o += kThreads) {
    const int64_t s = o / nch;
    dst[o] = src[(o - s * nch) * T + s];
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

// bucket (L, T) int32; runs (R, 6) int64 rows (dst, nf, bs, nch, lane0,
// frame0), frame0 the running sum of nf, then n_frames int64, each
// frame's row; n_frames = the sum of nf; max_bs = the largest bs; arena
// int32, written in place.
extern "C" int cxk_interleave_runs(const int* bucket, int64_t T,
                                   const int64_t* runs, int64_t R,
                                   int64_t n_frames, int64_t max_bs,
                                   int* arena, void* cuda_stream) {
  if (R > 0 && n_frames > 0 && max_bs > 0) {
    const int64_t chunks = (max_bs + kChunk - 1) / kChunk;
    if (n_frames > 0x7FFFFFFF || chunks > 65535)
      return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)n_frames, (unsigned)chunks);
    interleave_kernel<<<grid, kThreads, 0, (cudaStream_t)cuda_stream>>>(
        bucket, T, runs, R, arena);
  }
  return (int)cudaGetLastError();
}
