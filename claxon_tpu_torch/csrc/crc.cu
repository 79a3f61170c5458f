// K4: frame CRC-16 over byte ranges of the stream upload, on Hopper.
//
// Replaces claxon_tpu/ops/crc.py:193 crc16_ranges_device (an XLA program
// on the TPU). For each range f: the CRC-16 (polynomial 0x8005, init 0,
// MSB-first; claxon src/crc.rs) of bytes [starts[f], ends[f]) of the
// stream, whose int32 words hold their bytes big-endian. A frame checked
// together with its stored CRC gives 0 iff the CRC matches. Ranges are
// clamped to the upload: start to [0, 4W], end to [start, 4W]; no read
// leaves [0, W) words.
//
// What bounds it on this card: the bytes of the ranges, read once (at
// the headline x4 batch the frames tile the 35.6 MB upload: 0.0107 ms at
// 3.35 TB/s). The first design (one thread per frame, a byte-serial table
// CRC) took 1.1 ms there: its time was the longest frame's chain of
// dependent lookups, on 32 blocks for 132 SMs.
//
// This design spreads fixed-size pieces of work over the card, whatever
// the frame sizes are, and joins them by linearity. With init 0 and no
// final xor, crc(a ++ b) = shift(crc(a), |b|) ^ crc(b), where shift(c, n)
// carries a state across n zero bytes: a GF(2) 16 x 16 matrix, applied
// as two 256-entry lookups (low and high byte of the state). The tables
// (ops/crc.py::kernel_tables) hold the slice-by-4 tables T0..T3 and the
// matrices M_k of shift by 2^k bytes, k < 31 (claxon_tpu_torch/crc.py::
// crc16_combine_matrices).
//
// Of the two ways to split the work (a list of chunks of each range, or
// a prefix CRC over the whole upload with two lookups per range end), it
// takes the chunk list: a prefix needs each range end's partial piece
// finished by one thread, the same serial work in miniature, while a
// chunk list aligned to each range's end has exact edges for free
// (leading bytes masked to zero do not change an init-0 CRC).
//
// 1. plan_kernel (one block): each range's item count, ceil(len / 4096),
//    an exclusive scan of them (item_off, F + 1 int64), and out = 0.
// 2. items_kernel (a few blocks per SM; every warp loops over items):
//    item j of range f is the 4096 bytes ending 4096 j bytes before its
//    end, cut at the range start. The warp reads it in 512-byte steps
//    aligned to the item's end (16 bytes a lane, 4 coalesced word loads
//    and a funnel shift for an unaligned end), each lane runs slice-by-4
//    on its 16 bytes and carries its state across steps with M_9 (512
//    bytes); a 5-level warp tree (M_4..M_8) joins the lanes. Lane 0
//    shifts the item's CRC across the 4096 j bytes after it (M_12 and
//    up, one per set bit of j) and xors it into out[f] with an atomic
//    (xor commutes: the result does not depend on the order).
//
// The work is the ranges' bytes plus the item count, spread evenly: a
// range over the whole upload and 100,000 ranges of a few bytes both
// split into items. Offsets are int32, so a range is shorter than 2^31
// bytes, j < 2^19 and the shifts need M_12..M_30.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kItemBytes = 4096;  // bytes of one work item (one warp)
constexpr int kStepBytes = 512;   // bytes of one warp-wide step
constexpr int kLaneBytes = kStepBytes / 32;
constexpr int kSlice = 4 * 256;   // T0..T3
constexpr int kLevels = 31;       // M_0..M_30
constexpr int kMatWords = 512;    // low-byte table, then high-byte table
// Shared copies: M_4..M_9 (the warp tree and the 512-byte step).
constexpr int kShLo = 4, kShHi = 9;
constexpr int kPlanThreads = 1024;
constexpr int kItemWarps = 8;  // warps per block of items_kernel
constexpr int kItemBlocksPerSM = 4;

__device__ __forceinline__ void clamp_range(int a, int b, int64_t nbytes,
                                            int64_t& s, int64_t& e) {
  s = a < 0 ? 0 : (a > nbytes ? nbytes : (int64_t)a);
  e = b < s ? s : (b > nbytes ? nbytes : (int64_t)b);
}

__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const int* __restrict__ starts, const int* __restrict__ ends,
            int64_t F, int64_t nbytes, long long* __restrict__ item_off,
            int* __restrict__ out) {
  __shared__ long long warp_sum[kPlanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long carry = 0;
  for (int64_t base = 0; base < F; base += kPlanThreads) {
    const int64_t f = base + tid;
    long long n = 0;
    if (f < F) {
      int64_t s, e;
      clamp_range(starts[f], ends[f], nbytes, s, e);
      n = (e - s + kItemBytes - 1) / kItemBytes;
      out[f] = 0;
    }
    long long v = n;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      long long w = warp_sum[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long u = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += u;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    if (f < F)
      item_off[f] = carry + (warp ? warp_sum[warp - 1] : 0) + v - n;
    carry += warp_sum[31];
    __syncthreads();  // warp_sum is written again in the next tile
  }
  if (tid == 0) item_off[F] = carry;
}

// shift(c, 2^k bytes) from a table pair (low byte, then high byte).
__device__ __forceinline__ unsigned shift_sh(const unsigned short* m,
                                             unsigned c) {
  return m[c & 0xFFu] ^ m[256 + (c >> 8)];
}

__device__ __forceinline__ unsigned shift_gl(const int* __restrict__ m,
                                             unsigned c) {
  return (unsigned)(__ldg(m + (c & 0xFFu)) ^ __ldg(m + 256 + (c >> 8)));
}

__device__ __forceinline__ unsigned load_word(
    const unsigned* __restrict__ stream, int64_t W, int64_t w) {
  return (w >= 0 && w < W) ? __ldg(stream + w) : 0u;
}

__global__ void __launch_bounds__(kItemWarps * 32)
items_kernel(const unsigned* __restrict__ stream, int64_t W,
             const int* __restrict__ starts, const int* __restrict__ ends,
             int64_t F, const long long* __restrict__ item_off,
             const int* __restrict__ tables, int* __restrict__ out) {
  __shared__ unsigned short slice[4][256];
  __shared__ unsigned short mat[kShHi - kShLo + 1][kMatWords];
  const long long total = item_off[F];
  const long long warp0 = (long long)blockIdx.x * kItemWarps;
  if (warp0 >= total) return;  // the whole block: before the barrier
  for (int i = threadIdx.x; i < kSlice; i += blockDim.x)
    slice[i >> 8][i & 255] = (unsigned short)tables[i];
  for (int i = threadIdx.x; i < (kShHi - kShLo + 1) * kMatWords;
       i += blockDim.x)
    mat[i / kMatWords][i % kMatWords] =
        (unsigned short)tables[kSlice + kShLo * kMatWords + i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long n_warps = (long long)gridDim.x * kItemWarps;
  const int64_t nbytes = 4 * W;
  for (long long it = warp0 + (threadIdx.x >> 5); it < total;
       it += n_warps) {
    // The range of this item: item_off[lo] <= it < item_off[lo + 1].
    int64_t lo = 0, hi = F;
    while (hi - lo > 1) {
      const int64_t mid = (lo + hi) >> 1;
      if (item_off[mid] <= it) lo = mid; else hi = mid;
    }
    int64_t s, e;
    clamp_range(starts[lo], ends[lo], nbytes, s, e);
    const long long j = it - item_off[lo];  // items after this one
    const int64_t item_end = e - j * kItemBytes;
    const int64_t item_start = item_end - kItemBytes > s
                                   ? item_end - kItemBytes : s;
    const int n_steps =
        (int)((item_end - item_start + kStepBytes - 1) / kStepBytes);
    const int r = 8 * (int)(item_end & 3);  // bit offset of the step start
    unsigned acc = 0;  // this lane's bytes of the steps so far
    for (int m = n_steps - 1; m >= 0; --m) {
      const int64_t p = item_end - (int64_t)kStepBytes * (m + 1) +
                        kLaneBytes * lane;  // this lane's first byte
      const int64_t w0 = p >> 2;  // floor, also below 0
      unsigned wd[5];
#pragma unroll
      for (int k = 0; k < 4; ++k) wd[k] = load_word(stream, W, w0 + k);
      wd[4] = __shfl_down_sync(0xffffffffu, wd[0], 1);
      if (lane == 31) wd[4] = load_word(stream, W, w0 + 4);
      unsigned st = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        unsigned v = __funnelshift_l(wd[k + 1], wd[k], r);
        const int64_t z = s - (p + 4 * k);  // bytes of v before the range
        if (z >= 4) v = 0;
        else if (z > 0) v &= 0xFFFFFFFFu >> (8 * z);
        const unsigned x = v ^ (st << 16);
        st = slice[3][x >> 24] ^ slice[2][(x >> 16) & 255] ^
             slice[1][(x >> 8) & 255] ^ slice[0][x & 255];
      }
      acc = shift_sh(mat[9 - kShLo], acc) ^ st;
    }
    // Join the lanes: lane t's bytes are followed by 16 (31 - t) bytes
    // of each step.
#pragma unroll
    for (int d = 0; d < 5; ++d) {
      const unsigned other = __shfl_down_sync(0xffffffffu, acc, 1 << d);
      acc = shift_sh(mat[4 + d - kShLo], acc) ^ other;
    }
    if (lane == 0) {
      // Across the 4096 j bytes after the item: M_12 and up.
      for (int b = 0; (j >> b) != 0; ++b)
        if ((j >> b) & 1)
          acc = shift_gl(tables + kSlice + (12 + b) * kMatWords, acc);
      if (acc) atomicXor(out + lo, (int)acc);
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    n = 132;
  return n;
}

}  // namespace

// tables: ops/crc.py::kernel_tables (kSlice + kLevels * kMatWords int32);
// item_off: (F + 1) int64 scratch.
extern "C" int cxk_crc16_ranges(const int* stream, int64_t W,
                                const int* starts, const int* ends, int* out,
                                int64_t F, const int* tables,
                                long long* item_off, void* cuda_stream) {
  static_assert(kSlice + kLevels * kMatWords == 16896, "table layout");
  if (F > 0) {
    cudaStream_t st = (cudaStream_t)cuda_stream;
    plan_kernel<<<1, kPlanThreads, 0, st>>>(starts, ends, F, 4 * W,
                                            item_off, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    items_kernel<<<kItemBlocksPerSM * sm_count(), kItemWarps * 32, 0, st>>>(
        (const unsigned*)stream, W, starts, ends, F, item_off, tables, out);
  }
  return (int)cudaGetLastError();
}
