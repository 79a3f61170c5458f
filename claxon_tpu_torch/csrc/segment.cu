// K5: frame-header search over the stream upload, on Hopper.
//
// Replaces claxon_tpu/ops/segment.py::find_frame_headers (an XLA program
// on the TPU). A byte position i is a sync hit iff byte i is 0xFF, byte
// i + 1 masked with 0xFE is 0xF8, and i < n_bytes - 2. The first C hits in
// stream order become the candidates; count is the number of all hits.
// Each candidate's 16-byte window is then checked like a frame header:
// fixed fields, UTF-8 number, and the CRC-8 (polynomial 0x07) over its
// hlen header bytes against byte hlen.
//
// What bounds it on this card: the scan reads the whole upload once (35 MB
// for the main-path batch), so it is bound by device-memory bandwidth;
// the header checks are C short independent threads.
//
// Design: three launches. (1) sync_count: each block scans a tile of
// kTile words, four words a thread, and writes its hit total. The wrapper
// takes an inclusive cumsum of the block totals (a few thousand values).
// (2) sync_write: each block rescans its tile, ranks its hits with a block
// scan and writes those whose global rank is below C, so positions come
// out in stream order with no sort. (3) header_check: one thread per
// candidate builds the window, -1 fills positions past the count, and the
// CRC-8 table sits in shared memory. The TPU form's top_k compaction and
// gather-free GF(2) CRC steps are not carried over.
//
// The decode path runs none of this: the fused front in seg_parse.cu does
// the scan and the check in its one pass over the upload. These launches
// are the CUDA form of the K5 wrapper, ops/segment.find_frame_headers, the
// counterpart of the JAX package's public find_frame_headers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "header.cuh"
#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;
constexpr int64_t kTile = (int64_t)kThreads * kWordsPerThread;

__device__ __forceinline__ unsigned word_at(const unsigned* s, int64_t W,
                                            int64_t i) {
  return (i >= 0 && i < W) ? s[i] : 0u;
}

// Hit mask of one thread's four words: bit 4 * k + lane for byte lane
// `lane` (0 = most significant) of word k.
__device__ unsigned hit_mask(const unsigned* s, int64_t W, int64_t n_bytes,
                             int64_t w0) {
  unsigned mask = 0;
  unsigned cur = word_at(s, W, w0);
#pragma unroll
  for (int k = 0; k < kWordsPerThread; ++k) {
    const int64_t wi = w0 + k;
    if (wi >= W) break;
    const unsigned nxt = word_at(s, W, wi + 1);
    // The five bytes cur[0..3], nxt[0]: byte lane l pairs with lane l + 1.
    const unsigned long long pair =
        ((unsigned long long)cur << 8) | (nxt >> 24);
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const unsigned b = (unsigned)(pair >> (32 - 8 * l)) & 0xFFu;
      const unsigned n = (unsigned)(pair >> (24 - 8 * l)) & 0xFFu;
      const int64_t pos = 4 * wi + l;
      if (b == 0xFFu && (n & 0xFEu) == 0xF8u && pos < n_bytes - 2)
        mask |= 1u << (4 * k + l);
    }
    cur = nxt;
  }
  return mask;
}

__global__ void sync_count_kernel(const unsigned* __restrict__ s, int64_t W,
                                  int64_t n_bytes, int* __restrict__ blk) {
  const int64_t w0 = blockIdx.x * kTile + threadIdx.x * kWordsPerThread;
  const int n = __popc(hit_mask(s, W, n_bytes, w0));
  int total;
  block_excl_scan<kThreads>(n, &total);
  if (threadIdx.x == 0) blk[blockIdx.x] = total;
}

__global__ void sync_write_kernel(const unsigned* __restrict__ s, int64_t W,
                                  int64_t n_bytes,
                                  const int* __restrict__ incl,
                                  int* __restrict__ positions, int64_t C) {
  const int64_t w0 = blockIdx.x * kTile + threadIdx.x * kWordsPerThread;
  unsigned mask = hit_mask(s, W, n_bytes, w0);
  int total;
  const int pre = block_excl_scan<kThreads>(__popc(mask), &total);
  int64_t rank = (int64_t)(blockIdx.x > 0 ? incl[blockIdx.x - 1] : 0) + pre;
  while (mask && rank < C) {
    const int bit = __ffs(mask) - 1;
    mask &= mask - 1;
    positions[rank++] = (int)(4 * w0 + bit);
  }
}

__global__ void header_check_kernel(const unsigned* __restrict__ s,
                                    int64_t W, int64_t n_bytes,
                                    const int* __restrict__ count,
                                    int* __restrict__ positions,
                                    unsigned char* __restrict__ valid,
                                    int* __restrict__ win, int64_t C) {
  __shared__ unsigned char table[256];
  fill_crc8_table(table);
  __syncthreads();
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  int pos = -1;
  if (c < (int64_t)*count) pos = positions[c];
  else positions[c] = -1;
  const int64_t p = pos < 0 ? 0 : pos;
  unsigned w[kWin];
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
    const int64_t q = p + j;
    const int64_t wi = (q >> 2) < W - 1 ? (q >> 2) : W - 1;
    w[j] = (s[wi] >> (24 - 8 * (int)(q & 3))) & 0xFFu;
    win[c * kWin + j] = (int)w[j];
  }
  valid[c] = header_valid(w, pos, n_bytes, table) ? 1 : 0;
}

}  // namespace

extern "C" int64_t cxk_sync_blocks(int64_t W) {
  return (W + kTile - 1) / kTile;
}

extern "C" int cxk_sync_count(const int* stream, int64_t W, int64_t n_bytes,
                              int* blk, void* cuda_stream) {
  const int64_t blocks = cxk_sync_blocks(W);
  if (blocks > 0)
    sync_count_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)cuda_stream>>>(
        (const unsigned*)stream, W, n_bytes, blk);
  return (int)cudaGetLastError();
}

extern "C" int cxk_sync_write(const int* stream, int64_t W, int64_t n_bytes,
                              const int* incl, int* positions, int64_t C,
                              void* cuda_stream) {
  const int64_t blocks = cxk_sync_blocks(W);
  if (blocks > 0)
    sync_write_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)cuda_stream>>>(
        (const unsigned*)stream, W, n_bytes, incl, positions, C);
  return (int)cudaGetLastError();
}

extern "C" int cxk_header_check(const int* stream, int64_t W,
                                int64_t n_bytes, const int* count,
                                int* positions, unsigned char* valid,
                                int* win, int64_t C, void* cuda_stream) {
  if (C > 0) {
    const int threads = 128;
    const int64_t blocks = (C + threads - 1) / threads;
    header_check_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)cuda_stream>>>(
        (const unsigned*)stream, W, n_bytes, count, positions, valid, win,
        C);
  }
  return (int)cudaGetLastError();
}
