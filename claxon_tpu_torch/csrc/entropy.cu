// K2: stream-gather Rice decoding on Hopper.
//
// Replaces claxon_tpu/ops/entropy.py::decode_residual_bits_stream (an XLA
// program on the TPU). For each (lane, 32-sample chunk) the chunk's
// codes start at bit bases[l, c] of the uploaded stream (big-endian int32
// words). The 32 codes of the chunk are decoded in order: a partition's
// first code first skips the pbits-wide Rice parameter; the quotient is
// the count of leading zeros of the 64-bit window at the cursor, the
// remainder the k bits after the terminating one, and the value the
// u32-wrapping zig-zag of (q << k) | r. Verbatim lanes (flags bit 0) read
// k-bit sign-extended fields; lanes with flags bit 1 carry no codes.
// Warm-up samples fill t < order.
//
// Every index is clamped exactly where the JAX program clamps -- the
// stream word index to [0, W-1] and the in-chunk word to [0, SA-1], with
// the words past SA-1 read as zero -- so a fuzzed stream reads only inside
// the upload and the result equals the plain form's. Every shift by a
// variable amount goes through shl/shr, which give 0 for amounts >= 32
// like XLA's shifts.
//
// What bounds it on this card: the decode is bit-serial inside a chunk
// (each code's start depends on the previous code's length), so a chunk
// is a chain of 32 dependent steps; chunks are independent, L * NC of
// them (885K at the main-path bucket), plenty to fill the card. Its bytes
// (the chunk's slot words, its bases and the (L, T) output) take 0.046 ms
// at 3.35 TB/s there. The first design, one thread per chunk with its
// loads and stores in global memory, took 0.63 ms on an H100 (700 W):
// each step's store o[j] = val wrote 32 values 128 bytes apart, 32
// partial lines for one instruction. Measured there on the main-path
// bucket, the first design with only the output tile below took 0.21
// ms, with only the staged words 0.59: the stores held it. This design
// takes 0.15 ms there. Its step loop compiles to about 320 instructions,
// most of them the recount for wrapping partition sizes, which the usual
// path skips; whether the rest of the instruction stream or the chain's
// latency holds it now is not measured.
//
// Design: a warp owns 32 consecutive chunk indices, one chunk a thread.
// Since T = NC * 32, chunk i's output starts at i * 32, so the warp's
// output is 1,024 contiguous int32 (4 KB) whatever NC is; a warp may
// straddle two lanes, and each thread reads its own chunk's lane fields.
// - Staged words: the warp first copies each chunk's SA slot words,
//   clip(wi0 + jj, 0, W-1), into shared memory (row stride SA | 1, odd,
//   so the rows start in different banks), with cp.async 4-byte copies
//   spread over all 32 threads (consecutive threads, consecutive words
//   of one chunk). The 32 steps then read their words from shared memory,
//   and the cursor chain never waits on global memory. Staging is per
//   chunk, not per lane range, so garbage bases cost nothing but reads.
// - Staged output: step j writes its value to a shared tile (row stride
//   33: the 32 threads of a step hit 32 banks). After __syncwarp the warp
//   stores its 4 KB as 16-byte stores, 512 contiguous bytes an
//   instruction.
// - The partition index is counted incrementally (one compare a step)
//   where the thresholds m * ps cannot wrap; fuzzed ps recount over P at
//   each step, as the JAX program does.
// - Shared memory is sized from SA at launch: (32 * 33 + 32 * (SA | 1))
//   words a warp, 12.5 KB at the walk's largest class (SA 65). Above
//   kMaxStagedSA the same kernel (kStaged false) reads its words from
//   global memory, through L1, as the first design did; the output tile
//   stays.
// Launch shape: kWarps = 4 warps a block; 1, 2 and 8 were within 2% of
// it at the main-path bucket (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "shifts.cuh"

namespace {

constexpr int kWarps = 4;          // warps per block
constexpr int kTileStride = 33;    // output tile row stride (words)
constexpr int kMaxStagedSA = 65;   // the walk's largest SA class
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(unsigned* dst, const unsigned* src) {
  const uint32_t sdst = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sdst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int64_t clamp_word(int64_t idx, int64_t W) {
  return idx < 0 ? 0 : (idx > W - 1 ? W - 1 : idx);
}

template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32) entropy_kernel(
    const unsigned* __restrict__ stream, int64_t W,
    const int* __restrict__ bases, const int* __restrict__ ks, int64_t KP,
    int64_t P, const int* __restrict__ ps, const int* __restrict__ orders,
    const int* __restrict__ pbits, const int* __restrict__ flags,
    const int* __restrict__ warm, int64_t WM,
    const int* __restrict__ lengths, int* __restrict__ out, int64_t L,
    int64_t NC, int sa) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n_chunks = L * NC;
  const int64_t i0 = ((int64_t)blockIdx.x * kWarps + warp) * 32;
  if (i0 >= n_chunks) return;  // warp-uniform
  const int n_valid = (int)(n_chunks - i0 < 32 ? n_chunks - i0 : 32);
  const bool live = lane < n_valid;
  const int sap = sa | 1;
  unsigned* tile =
      smem + warp * (32 * kTileStride + (kStaged ? 32 * sap : 0));
  const unsigned* words = tile + 32 * kTileStride + lane * sap;

  const int64_t i = i0 + lane;
  const int base = live ? bases[i] : 0;
  const int wi0 = base >> 5;  // arithmetic, as in JAX

  if constexpr (kStaged) {
    // Slot words of the warp's chunks, item e = (chunk e / sa, word e %
    // sa); every thread runs the same trip count for the shuffle.
    unsigned* wbase = tile + 32 * kTileStride;
    const int total = n_valid * sa;
    for (int e = lane; e < ((total + 31) & ~31); e += 32) {
      const int c = e / sa;
      const int w = __shfl_sync(kFull, wi0, c & 31);
      if (e < total)
        cp_async4(wbase + c * sap + (e - c * sa),
                  stream + clamp_word((int64_t)w + (e - c * sa), W));
    }
    cp_async_wait_all();
    __syncwarp();
  }

  if (live) {
    const int64_t l = i / NC;
    const int c = (int)(i - l * NC);
    const int order = orders[l];
    const int ps_b = max(ps[l], 1);
    const int pb = pbits[l];
    const int fl = flags[l];
    const bool verb = (fl & 1) != 0;
    const bool has_codes = (fl & 2) == 0;
    const int length = lengths[l];
    const int* krow = ks + l * KP;
    const int t0 = c * 32;

    // Word jj of the chunk's gathered slots (jj in [0, SA)).
    auto slot = [&](int jj) -> unsigned {
      if constexpr (kStaged) return words[jj];
      else return __ldg(stream + clamp_word((int64_t)wi0 + jj, W));
    };

    // Partition index of t: #{m in [1, P) : t >= (int)(m * ps)}. Without
    // wrap (mono) the thresholds rise by ps >= 1, so it grows by at most
    // one a step; else it is recounted at each step.
    const bool mono = (P - 1) * (int64_t)ps_b < ((int64_t)1 << 31);
    int p = 0;
    if (mono) p = (int64_t)(t0 / ps_b) < P - 1 ? t0 / ps_b : (int)(P - 1);
    int next = mono && p + 1 < P ? (p + 1) * ps_b : INT32_MAX;
    int k = krow[p];

    int cursor = base & 31;
    for (int j = 0; j < 32; ++j) {
      const int t = t0 + j;
      if (!mono) {
        int q = 0;
        for (int m = 1; m < P; ++m)
          q += t >= (int)((unsigned)m * (unsigned)ps_b) ? 1 : 0;
        p = q;
        k = krow[p];
      } else if (t >= next) {
        ++p;
        next = p + 1 < P ? next + ps_b : INT32_MAX;
        k = krow[p];
      }
      const bool active = t >= order && t < length && has_codes;
      const int pstart =
          p == 0 ? order : (int)((unsigned)p * (unsigned)ps_b);
      const bool first = t == pstart;
      const int pos = (int)((unsigned)cursor + (first && !verb ? pb : 0));

      int wi = pos >> 5;
      wi = wi < 0 ? 0 : (wi > sa - 1 ? sa - 1 : wi);
      const int off = pos & 31;
      const unsigned w0 = slot(wi);
      const unsigned w1 = wi + 1 <= sa - 1 ? slot(wi + 1) : 0u;
      const unsigned w2 = wi + 2 <= sa - 1 ? slot(wi + 2) : 0u;
      const unsigned hi = __funnelshift_l(w1, w0, off);  // off == 0: w0
      const unsigned lo = __funnelshift_l(w2, w1, off);

      // Rice: quotient = leading zeros of the 64-bit window (64 if empty).
      const int z = __clzll(((unsigned long long)hi << 32) | lo);
      const int s1 = z + 1;  // in [1, 65]
      const unsigned rhi = s1 < 32 ? __funnelshift_l(lo, hi, s1)
                                   : lo << min(s1 - 32, 31);
      const unsigned r = k == 0 ? 0u : shr(rhi, 32 - k);
      const unsigned v = shl((unsigned)z, k) | r;
      const unsigned rice = (v & 1u) ? ~(v >> 1) : (v >> 1);

      // Verbatim: sign-extend the k-bit field at the window start.
      const unsigned rv = k == 0 ? 0u : shr(hi, 32 - k);
      const unsigned sbit = shl(1u, max(k - 1, 0));
      const unsigned vb = (rv ^ sbit) - sbit;

      const unsigned res = verb ? vb : rice;
      const int adv = verb ? k : (int)((unsigned)s1 + (unsigned)k);
      if (active) cursor = (int)((unsigned)pos + (unsigned)adv);
      int val = active ? (int)res : 0;
      if (t < order) val = t < WM ? warm[l * WM + t] : 0;
      tile[lane * kTileStride + j] = (unsigned)val;
    }
  }
  __syncwarp();

  // The warp's n_valid * 32 outputs are contiguous from out + i0 * 32, a
  // 4 KB-aligned offset of the wrapper's allocation: 16-byte stores, item
  // v = (chunk v / 8, values 4 * (v % 8) ...).
  int4* dst = reinterpret_cast<int4*>(out + i0 * 32);
  for (int v = lane; v < n_valid * 8; v += 32) {
    const unsigned* row = tile + (v >> 3) * kTileStride + 4 * (v & 7);
    dst[v] = make_int4((int)row[0], (int)row[1], (int)row[2], (int)row[3]);
  }
}

}  // namespace

extern "C" int cxk_entropy_stream(
    const int* stream, int64_t W, const int* bases, const int* ks,
    int64_t KP, int64_t P, const int* ps, const int* orders,
    const int* pbits, const int* flags, const int* warm, int64_t WM,
    const int* lengths, int* out, int64_t L, int64_t NC, int64_t SA,
    void* cuda_stream) {
  const int64_t n = L * NC;
  if (n <= 0) return (int)cudaGetLastError();
  const int64_t blocks = ((n + 31) / 32 + kWarps - 1) / kWarps;
  const bool staged = SA <= kMaxStagedSA;
  const int sa = staged ? (int)SA : (int)(SA > INT32_MAX ? INT32_MAX : SA);
  const size_t smem = (size_t)kWarps * 4 *
                      (32 * kTileStride + (staged ? 32 * (sa | 1) : 0));
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  if (staged) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          entropy_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    entropy_kernel<true><<<(unsigned)blocks, kWarps * 32, smem, s>>>(
        (const unsigned*)stream, W, bases, ks, KP, P, ps, orders, pbits,
        flags, warm, WM, lengths, out, L, NC, sa);
  } else {
    entropy_kernel<false><<<(unsigned)blocks, kWarps * 32, smem, s>>>(
        (const unsigned*)stream, W, bases, ks, KP, P, ps, orders, pbits,
        flags, warm, WM, lengths, out, L, NC, sa);
  }
  return (int)cudaGetLastError();
}
