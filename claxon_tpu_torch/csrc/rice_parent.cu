// rice_decode, the parent design: kept for timing only.
//
// The first hand-written form of rice_decode (claxon_tpu/ops/rice.py:126),
// unchanged but for its entry name (cxk_rice_decode_parent). No decode
// route and no wrapper calls it: chip_smoke.py times it beside
// csrc/rice.cu on the same inputs, and tests/test_torch_cuda.py holds the
// two equal. What the kernel computes, and every exactness rule, is
// written in rice.cu.
//
// Design: a thread a lane, and the output staged through a shared tile
// of 32 lanes by 32 steps (row stride 33), stored as 128-byte rows. Each
// code is a chain of dependent global loads: the search reads the word
// at the cursor (more over a run of zero words), then the remainder
// reads two more at the position the search found. One warp alone took
// about 880 cycles a step (NVIDIA H100 80GB HBM3, 700 W power limit;
// PERF.md), and the 27,648 lanes of the headline shapes give the card 6.5
// warps an SM to hide it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shifts.cuh"

namespace {

constexpr int kWarps = 2;          // warps per block of rice_kernel
constexpr int kTileStride = 33;    // output tile row stride (ints)
constexpr int kExactThreads = 1024;

__device__ __forceinline__ unsigned word_at(
    const unsigned* __restrict__ words, int W, int i) {
  return __ldg(words + (i < 0 ? 0 : (i > W - 1 ? W - 1 : i)));
}

// The JAX find_next_one for one lane at cursor pos. found: the set bit
// lies in word wi (masked, the word with the bits before pos cleared).
// Not found: the lane ran off the buffer with masked 0, and its word
// index is (pos >> 5) + N, N the iterations of the global loop. c: the
// iterations in which this lane kept that loop going.
struct Search {
  int wi;
  unsigned masked;
  int c;
  bool found;
};

__device__ Search search(const unsigned* __restrict__ words, int W,
                         int pos) {
  Search r;
  const int wi0 = pos >> 5;  // arithmetic, as in JAX
  r.wi = wi0;
  r.masked = word_at(words, W, wi0) & (0xFFFFFFFFu >> (pos & 31));
  r.c = 0;
  r.found = r.masked != 0u;
  if (r.found || wi0 >= W) return r;
  int k = wi0 + 1;
  if (k <= 0) {  // a negative word index reads word 0
    const unsigned w = __ldg(words);
    if (w) {
      r.wi = k; r.masked = w; r.c = 1; r.found = true;
      return r;
    }
    k = 1;
  }
  for (; k < W; ++k) {
    const unsigned w = __ldg(words + k);
    if (w) {
      r.wi = k; r.masked = w; r.c = k - wi0; r.found = true;
      return r;
    }
  }
  r.c = W - wi0;
  return r;
}

// One code from cursor pos whose quotient ends at word wi (masked word
// m): returns the sample and sets pos to the cursor after the code.
__device__ __forceinline__ int decode_code(
    const unsigned* __restrict__ words, int W, int& pos, int wi,
    unsigned m, int k) {
  const unsigned one = ((unsigned)wi << 5) + (unsigned)__clz((int)m);
  const unsigned q = one - (unsigned)pos;
  const int p = (int)(one + 1u);
  const int pw = p >> 5, off = p & 31;
  const unsigned w0 = word_at(words, W, pw), w1 = word_at(words, W, pw + 1);
  const unsigned window = (w0 << off) | (off ? w1 >> (32 - off) : 0u);
  const unsigned r = k == 0 ? 0u : shr(window, (int)(32u - (unsigned)k));
  const unsigned v = shl(q, k) | r;
  pos = (int)(one + 1u + (unsigned)k);
  return (int)((v & 1u) ? ~(v >> 1) : (v >> 1));
}

__global__ void __launch_bounds__(kWarps * 32)
rice_kernel(const unsigned* __restrict__ words, int W,
            const int* __restrict__ start_bits,
            const int* __restrict__ params, const int* __restrict__ counts,
            int64_t L, int T, int* __restrict__ out,
            int* __restrict__ end_bits, int* __restrict__ flag) {
  __shared__ int tile[kWarps][32 * kTileStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t l0 = ((int64_t)blockIdx.x * kWarps + warp) * 32;
  if (l0 >= L) return;  // warp-uniform; no block barrier below
  const int64_t l = l0 + lane;
  const bool live = l < L;
  const int rows = (int)(L - l0 < 32 ? L - l0 : 32);
  int pos = live ? start_bits[l] : 0;
  const int k = live ? params[l] : 0;
  int n = live ? counts[l] : 0;
  n = n < 0 ? 0 : (n > T ? T : n);
  bool ok = true;
  int* t = tile[warp];
  for (int j0 = 0; j0 < T; j0 += 32) {
    for (int s = 0; s < 32; ++s) {
      int v = 0;
      if (ok && j0 + s < n) {
        const Search f = search(words, W, pos);
        if (f.found)
          v = decode_code(words, W, pos, f.wi, f.masked, k);
        else
          ok = false;  // rice_exact_kernel decodes the input again
      }
      t[lane * kTileStride + s] = v;
    }
    __syncwarp();
    const int cols = T - j0 < 32 ? T - j0 : 32;
    if (lane < cols)
      for (int r = 0; r < rows; ++r)
        out[(l0 + r) * (int64_t)T + j0 + lane] = t[r * kTileStride + lane];
    __syncwarp();
  }
  if (live) end_bits[l] = pos;
  if (!ok) *flag = 1;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int o = __shfl_xor_sync(0xffffffffu, v, d);
    v = o > v ? o : v;
  }
  return v;
}

// All lanes in step, as the JAX scan runs them; end_bits holds the
// cursors. Each thread owns lanes tid, tid + 1024, ...
__global__ void __launch_bounds__(kExactThreads)
rice_exact_kernel(const unsigned* __restrict__ words, int W,
                  const int* __restrict__ start_bits,
                  const int* __restrict__ params,
                  const int* __restrict__ counts, int64_t L, int T,
                  int* __restrict__ out, int* __restrict__ end_bits,
                  const int* __restrict__ flag) {
  __shared__ int red[kExactThreads / 32];
  if (*flag == 0) return;  // the whole block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int64_t l = tid; l < L; l += kExactThreads)
    end_bits[l] = start_bits[l];
  for (int j = 0; j < T; ++j) {
    int c = 0;
    for (int64_t l = tid; l < L; l += kExactThreads) {
      const int cl = search(words, W, end_bits[l]).c;
      c = cl > c ? cl : c;
    }
    c = warp_max(c);
    if (lane == 0) red[warp] = c;
    __syncthreads();
    int N = 0;
    for (int i = 0; i < kExactThreads / 32; ++i)
      N = red[i] > N ? red[i] : N;
    __syncthreads();  // red is written again in the next step
    for (int64_t l = tid; l < L; l += kExactThreads) {
      int v = 0;
      if (j < counts[l]) {
        int pos = end_bits[l];
        const Search f = search(words, W, pos);
        const int wi = f.found ? f.wi
                               : (int)((unsigned)(pos >> 5) + (unsigned)N);
        v = decode_code(words, W, pos, wi, f.found ? f.masked : 0u,
                        params[l]);
        end_bits[l] = pos;
      }
      out[l * T + j] = v;
    }
  }
}

}  // namespace

// words (W,) with 1 <= W <= 2^26; start_bits, params, counts (L,);
// out (L, T); end_bits (L,); flag (1,) int32, zeroed by the caller.
extern "C" int cxk_rice_decode_parent(const int* words, int64_t W,
                                      const int* start_bits,
                                      const int* params, const int* counts,
                                      int64_t L, int64_t T, int* out,
                                      int* end_bits, int* flag,
                                      void* cuda_stream) {
  if (L > 0) {
    cudaStream_t st = (cudaStream_t)cuda_stream;
    const int64_t per_block = 32 * kWarps;
    rice_kernel<<<(unsigned)((L + per_block - 1) / per_block), kWarps * 32,
                  0, st>>>((const unsigned*)words, (int)W, start_bits,
                           params, counts, L, (int)T, out, end_bits, flag);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rice_exact_kernel<<<1, kExactThreads, 0, st>>>(
        (const unsigned*)words, (int)W, start_bits, params, counts, L,
        (int)T, out, end_bits, flag);
  }
  return (int)cudaGetLastError();
}
