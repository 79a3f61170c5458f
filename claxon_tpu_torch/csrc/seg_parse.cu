// K6: the fused demux's own body, on Hopper.
//
// Replaces the body of claxon_tpu/ops/seg_parse.py::_program.prog (one XLA
// program on the TPU that also runs the sync scan, K5, and the subframe
// walk, K7). Here the pieces around K5 and K7 are four small kernels:
//
//   bswap    the little-endian word upload -> the big-endian stream that
//            K5, K7 and K4 index;
//   fields   one thread per sync candidate: decode the frame-header fields
//            from K5's 16-byte window (block size, header length, channel
//            count and assignment, blocking flag, the UTF-8 frame or sample
//            number split into 32-bit lo and 4-bit hi), find the stream the
//            candidate lies in (a binary search of the stream ends, side
//            right, clamped to S - 1), resolve its bits per sample, and set
//            the walkable predicate (CRC-8 valid, block size code 7 not
//            0xFFFF, the group's channel count, bps > 0, 1 <= block size
//            <= T);
//   compact  one block: ranks the walkable candidates in stream order and
//            writes the first wcap of them as K7's lanes (start bit, block
//            size, mode, bps); spare lanes get block size 0, which K7
//            rejects. It also writes the counts (all sync hits, walkable);
//   summary  one thread per candidate: gather its walk lane's verdict, end
//            bit, largest partition count and gather width, and pack the
//            5-word summary row with the JAX program's bit widths.
//
// What bounds it on this card: nothing much. The bswap reads and writes
// the upload once (bandwidth); the rest touches C candidates of a few
// dozen bytes each. The one-block compaction is a serial loop of
// ceil(C / 1024) block scans, a few microseconds for the main path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int kWin = 16;
// Per-candidate field row written by fields_kernel.
enum Field {
  kBlockSize, kHlen, kNchHdr, kMode, kVariable, kLo, kHi, kBps, kWalkable,
  kFields
};
constexpr int kCompactThreads = 1024;

__constant__ int kBpsTable[8] = {0, 8, 12, -1, 16, 20, 24, -1};
__constant__ unsigned kUtf8Mask0[8] = {0x7F, 0, 0x1F, 0x0F, 0x07, 0x03, 0x01,
                                       0};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void bswap_kernel(const unsigned* __restrict__ in,
                             unsigned* __restrict__ out, int64_t W) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < W;
       i += (int64_t)gridDim.x * blockDim.x)
    out[i] = __byte_perm(in[i], 0, 0x0123);
}

__global__ void fields_kernel(const int* __restrict__ positions,
                              const unsigned char* __restrict__ valid,
                              const int* __restrict__ win, int64_t C,
                              const int* __restrict__ ends,
                              const int* __restrict__ si_bps, int S, int T,
                              int nch, int* __restrict__ fields) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int* w = win + c * kWin;
  const int p = positions[c] < 0 ? 0 : positions[c];
  const int variable = w[1] & 1;
  const int bs_code = w[2] >> 4, sr_code = w[2] & 15;
  const int ca = w[3] >> 4, bps_code = (w[3] >> 1) & 7;
  const int nch_hdr = ca < 8 ? ca + 1 : 2;
  const int mode = ca < 8 ? 0 : ca - 7;

  // UTF-8 frame/sample number: up to 36 bits, split lo (32) / hi.
  const int lead = __clz(~((unsigned)w[4] << 24));  // leading ones, 0..8
  const int ulen = lead == 0 ? 1 : lead;
  unsigned lo = (unsigned)w[4] & kUtf8Mask0[lead < 7 ? lead : 7], hi = 0;
#pragma unroll
  for (int j = 1; j < 7; ++j) {
    if (j < ulen) {
      hi = (hi << 6) | ((lo >> 26) & 0x3Fu);
      lo = (lo << 6) | ((unsigned)w[4 + j] & 0x3Fu);
    }
  }

  const int bs_extra = (bs_code == 6 ? 1 : 0) + (bs_code == 7 ? 2 : 0);
  const int sr_extra =
      (sr_code == 12 ? 1 : 0) + (sr_code == 13 || sr_code == 14 ? 2 : 0);
  const int o = 4 + ulen;
  const int b8 = w[o < 15 ? o : 15];
  const int b16 = (b8 << 8) | w[o + 1 < 15 ? o + 1 : 15];
  int block_size;
  if (bs_code == 1)
    block_size = 192;
  else if (bs_code <= 5)
    block_size = 576 << (bs_code - 2 > 0 ? bs_code - 2 : 0);
  else if (bs_code == 6)
    block_size = b8 + 1;
  else if (bs_code == 7)
    block_size = b16 + 1;
  else
    block_size = 256 << (bs_code - 8);
  const bool ok = valid[c] != 0 && !(bs_code == 7 && b16 == 0xFFFF);
  const int hlen = o + bs_extra + sr_extra + 1;  // + the CRC-8 byte

  // searchsorted(ends, p, side="right"), clamped to S - 1.
  int a = 0, b = S;
  while (a < b) {
    const int m = (a + b) >> 1;
    if (ends[m] <= p)
      a = m + 1;
    else
      b = m;
  }
  const int si = a < S - 1 ? a : S - 1;
  const int bps = bps_code == 0 ? si_bps[si] : kBpsTable[bps_code];
  const bool walkable = ok && nch_hdr == nch && bps > 0 && block_size >= 1 &&
                        block_size <= T;

  int* f = fields + c * kFields;
  f[kBlockSize] = block_size;
  f[kHlen] = hlen;
  f[kNchHdr] = nch_hdr;
  f[kMode] = mode;
  f[kVariable] = variable;
  f[kLo] = (int)lo;
  f[kHi] = (int)hi;
  f[kBps] = bps;
  f[kWalkable] = walkable ? 1 : 0;
}

__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(const int* __restrict__ positions,
               const int* __restrict__ fields, int64_t C,
               const int* __restrict__ count, int64_t wcap,
               int* __restrict__ lane_of, int* __restrict__ start_bits,
               int* __restrict__ w_bs, int* __restrict__ w_mode,
               int* __restrict__ w_bps, int* __restrict__ counts) {
  __shared__ int64_t base;
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  for (int64_t c0 = 0; c0 < C; c0 += kCompactThreads) {
    const int64_t c = c0 + threadIdx.x;
    const int* f = fields + c * kFields;
    const int wk = c < C ? f[kWalkable] : 0;
    int total;
    const int64_t rank =
        base + block_excl_scan<kCompactThreads>(wk, &total);
    if (c < C) {
      if (wk && rank < wcap) {
        const int p = positions[c] < 0 ? 0 : positions[c];
        lane_of[c] = (int)rank;
        start_bits[rank] = (p + f[kHlen]) * 8;
        w_bs[rank] = f[kBlockSize];
        w_mode[rank] = f[kMode];
        w_bps[rank] = f[kBps];
      } else {
        lane_of[c] = -1;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) base += total;
    __syncthreads();
  }
  for (int64_t l = (base < wcap ? base : wcap) + threadIdx.x; l < wcap;
       l += kCompactThreads) {
    start_bits[l] = 0;
    w_bs[l] = 0;
    w_mode[l] = 0;
    w_bps[l] = 1;
  }
  if (threadIdx.x == 0) {
    counts[0] = *count;
    counts[1] = (int)base;
  }
}

__global__ void summary_kernel(const int* __restrict__ positions,
                               const int* __restrict__ fields,
                               const int* __restrict__ lane_of, int64_t C,
                               const int* __restrict__ end_bits,
                               const unsigned char* __restrict__ walk_ok,
                               const int* __restrict__ n_parts,
                               const int* __restrict__ sa_words, int nch,
                               int* __restrict__ summary) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int* f = fields + c * kFields;
  const int lane = lane_of[c];
  int ok = 0, eb = 0, np_max = 0, sa_max = 0;
  if (lane >= 0) {
    ok = walk_ok[lane] ? 1 : 0;
    eb = end_bits[lane];
    for (int ch = 0; ch < nch; ++ch) {
      const int64_t r = (int64_t)lane * nch + ch;
      np_max = ch == 0 || n_parts[r] > np_max ? n_parts[r] : np_max;
      sa_max = ch == 0 || sa_words[r] > sa_max ? sa_words[r] : sa_max;
    }
  }
  const unsigned w3 = (unsigned)clampi(f[kBlockSize], 0, 0x1FFFF) |
                      ((unsigned)clampi(f[kHlen], 0, 31) << 17) |
                      ((unsigned)clampi(f[kNchHdr], 0, 15) << 22) |
                      ((unsigned)clampi(f[kMode], 0, 3) << 26) |
                      ((unsigned)(f[kVariable] & 1) << 28) |
                      ((unsigned)f[kWalkable] << 29) | ((unsigned)ok << 30);
  const unsigned w4 = ((unsigned)f[kHi] & 0xFu) |
                      ((unsigned)clampi(np_max, 0, 127) << 4) |
                      ((unsigned)clampi(sa_max, 0, 511) << 11) |
                      ((unsigned)clampi(f[kBps], 0, 63) << 20);
  int* s = summary + c * 5;
  s[0] = positions[c];
  s[1] = eb >> 3;
  s[2] = f[kLo];
  s[3] = (int)w3;
  s[4] = (int)w4;
}

unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" int cxk_seg_bswap(const int* in, int* out, int64_t W,
                             void* cuda_stream) {
  if (W > 0) {
    const int threads = 256;
    const int64_t want = (W + threads - 1) / threads;
    bswap_kernel<<<(unsigned)(want < 8192 ? want : 8192), threads, 0,
                   (cudaStream_t)cuda_stream>>>((const unsigned*)in,
                                                (unsigned*)out, W);
  }
  return (int)cudaGetLastError();
}

extern "C" int cxk_seg_fields(const int* positions, const unsigned char* valid,
                              const int* win, int64_t C, const int* ends,
                              const int* si_bps, int64_t S, int64_t T,
                              int64_t nch, int* fields, void* cuda_stream) {
  if (C > 0)
    fields_kernel<<<blocks_for(C, 128), 128, 0, (cudaStream_t)cuda_stream>>>(
        positions, valid, win, C, ends, si_bps, (int)S, (int)T, (int)nch,
        fields);
  return (int)cudaGetLastError();
}

extern "C" int cxk_seg_compact(const int* positions, const int* fields,
                               int64_t C, const int* count, int64_t wcap,
                               int* lane_of, int* start_bits, int* w_bs,
                               int* w_mode, int* w_bps, int* counts,
                               void* cuda_stream) {
  compact_kernel<<<1, kCompactThreads, 0, (cudaStream_t)cuda_stream>>>(
      positions, fields, C, count, wcap, lane_of, start_bits, w_bs, w_mode,
      w_bps, counts);
  return (int)cudaGetLastError();
}

extern "C" int cxk_seg_summary(const int* positions, const int* fields,
                               const int* lane_of, int64_t C,
                               const int* end_bits,
                               const unsigned char* walk_ok,
                               const int* n_parts, const int* sa_words,
                               int64_t nch, int* summary,
                               void* cuda_stream) {
  if (C > 0)
    summary_kernel<<<blocks_for(C, 128), 128, 0,
                     (cudaStream_t)cuda_stream>>>(
        positions, fields, lane_of, C, end_bits, walk_ok, n_parts, sa_words,
        (int)nch, summary);
  return (int)cudaGetLastError();
}
