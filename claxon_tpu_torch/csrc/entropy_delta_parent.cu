// K9 and K10, the parent design: kept for timing only.
//
// The first hand-written form of K9 (claxon_tpu/ops/entropy.py::
// decode_residual_bits) and K10 (decode_residual_bits_stream_delta),
// unchanged but for its entry names (cxk_entropy_delta_slots_parent,
// cxk_entropy_delta_stream_parent). No decode route calls it:
// chip_smoke.py times it beside csrc/entropy_delta.cu on the same inputs,
// and tests/test_torch_cuda.py holds the two equal. What the kernels
// compute, and every exactness rule, is written in entropy_delta.cu.
//
// Design: one warp per (lane, 32-sample chunk), one sample per thread, so
// a warp's delta loads and output stores are contiguous (32 bytes in, 128
// out); the in-chunk exclusive sum of the deltas by __shfl_up_sync; the
// chunk's SA words staged once in shared memory by the warp (consecutive
// threads, consecutive words), each thread then taking its 32-bit window
// from two of them with a funnel shift (above kMaxStagedSA the same
// kernel reads the words from global memory); the partition index t / ps
// where the thresholds m * ps cannot wrap, fuzzed ps counted over P.
// Each warp moves about 212 bytes after two dependent round trips (its
// words, then ps -> partition -> ks[p]), and reloads the lane's fields
// for every chunk. Launch shape: kWarps = 8 warps a block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shifts.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kMaxStagedSA = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t clamp_word(int64_t idx, int64_t W) {
  return idx < 0 ? 0 : (idx > W - 1 ? W - 1 : idx);
}

// #{m in [1, P) : t >= (int)(m * ps)}, for t >= 0.
__device__ __forceinline__ int partition_of(int t, int ps, int P) {
  if (P <= 1) return 0;
  if (ps >= 1 && (int64_t)(P - 1) * ps < ((int64_t)1 << 31)) {
    const int p = t / ps;
    return p < P - 1 ? p : P - 1;
  }
  int p = 0;
  for (int m = 1; m < P; ++m)
    p += t >= (int)((unsigned)m * (unsigned)ps) ? 1 : 0;
  return p;
}

// Exclusive sum of v over the warp's lanes (int32 wrapping).
__device__ __forceinline__ int warp_exclusive_sum(int v, int lane) {
  unsigned s = (unsigned)v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned n = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += n;
  }
  return (int)(s - (unsigned)v);
}

// The value of one sample. `word(j)` is word j of the chunk's bits (j in
// [0, sa)); rbase the bit of the chunk's first code in them, ol the
// exclusive sum of the deltas before this sample, d its delta.
template <class Words>
__device__ __forceinline__ int decode_sample(const Words& word, int sa, int d,
                                             int ol, int rbase, int k,
                                             bool first, int pb, bool verb) {
  const int rpos = (int)((unsigned)rbase + (unsigned)ol + (unsigned)d -
                         (unsigned)k);  // the remainder's first bit
  int wi = rpos >> 5;  // arithmetic, as in JAX
  wi = wi < 0 ? 0 : (wi > sa - 1 ? sa - 1 : wi);
  const int off = rpos & 31;
  const unsigned w0 = word(wi);
  const unsigned w1 = wi + 1 <= sa - 1 ? word(wi + 1) : 0u;
  const unsigned win = __funnelshift_l(w1, w0, off);  // off == 0: w0
  const unsigned r = k == 0 ? 0u : shr(win, (int)(32u - (unsigned)k));
  // Rice: u32-wrapping (q << min(k, 31)) | r, then zig-zag.
  const unsigned q =
      (unsigned)d - 1u - (unsigned)k - (first ? (unsigned)pb : 0u);
  const unsigned v = shl(q, k < 31 ? k : 31) | r;
  const unsigned rice = (v & 1u) ? ~(v >> 1) : (v >> 1);
  // Verbatim: sign-extend the k-bit field.
  const int km1 = (int)((unsigned)k - 1u);
  const unsigned sbit = shl(1u, km1 > 0 ? km1 : 0);
  const unsigned vb = (r ^ sbit) - sbit;
  return (int)(verb ? vb : rice);
}

// K9: slots (L, NC * sa) words, deltas (L, T) uint8.
template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32) delta_slots_kernel(
    const unsigned* __restrict__ slots,
    const unsigned char* __restrict__ deltas,
    const int* __restrict__ ks, int64_t KP, int P, const int* __restrict__ ps,
    const int* __restrict__ orders, const int* __restrict__ pbits,
    const int* __restrict__ vflags, const int* __restrict__ warm, int64_t WM,
    int* __restrict__ out, int64_t L, int64_t NC, int sa) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t g = (int64_t)blockIdx.x * kWarps + warp;  // lane * NC + c
  if (g >= L * NC) return;  // warp-uniform
  const int64_t l = g / NC;
  const int t = (int)(g - l * NC) * 32 + lane;
  const int64_t at = g * 32 + lane;  // l * T + t
  const unsigned* src = slots + g * sa;
  unsigned* staged = smem + warp * (kStaged ? sa : 0);
  if constexpr (kStaged) {
    for (int j = lane; j < sa; j += 32) staged[j] = __ldg(src + j);
    __syncwarp();
  }
  auto word = [&](int j) -> unsigned {
    if constexpr (kStaged) return staged[j];
    else return __ldg(src + j);
  };

  const int d = deltas[at];
  const int ol = warp_exclusive_sum(d, lane);
  const int order = orders[l];
  const int ps_l = ps[l];
  const int p = partition_of(t, ps_l, P);
  const int k = ks[l * KP + p];
  const int pstart = p == 0 ? order : (int)((unsigned)p * (unsigned)ps_l);
  const int res = decode_sample(word, sa, d, ol, 0, k, t == pstart, pbits[l],
                                vflags[l] != 0);
  int val = d > 0 ? res : 0;
  if (t < order) val = t < WM ? warm[l * WM + t] : 0;
  out[at] = val;
}

// K10: stream (W,) words, bases (L, NC), deltas (L, T) int8.
template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32) delta_stream_kernel(
    const unsigned* __restrict__ stream, int64_t W,
    const int* __restrict__ bases, const signed char* __restrict__ deltas,
    const int* __restrict__ ks, int64_t KP, int P, const int* __restrict__ ps,
    const int* __restrict__ orders, const int* __restrict__ pbits,
    const int* __restrict__ flags, const int* __restrict__ warm, int64_t WM,
    const int* __restrict__ lengths, int* __restrict__ out, int64_t L,
    int64_t NC, int sa) {
  extern __shared__ unsigned smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t g = (int64_t)blockIdx.x * kWarps + warp;  // lane * NC + c
  if (g >= L * NC) return;  // warp-uniform
  const int64_t l = g / NC;
  const int t = (int)(g - l * NC) * 32 + lane;
  const int64_t at = g * 32 + lane;
  const int base = bases[g];
  const int64_t wi0 = base >> 5;  // arithmetic, as in JAX
  unsigned* staged = smem + warp * (kStaged ? sa : 0);
  if constexpr (kStaged) {
    for (int j = lane; j < sa; j += 32)
      staged[j] = __ldg(stream + clamp_word(wi0 + j, W));
    __syncwarp();
  }
  auto word = [&](int j) -> unsigned {
    if constexpr (kStaged) return staged[j];
    else return __ldg(stream + clamp_word(wi0 + j, W));
  };

  const int fl = flags[l];
  const bool verb = (fl & 1) != 0;
  const int order = orders[l];
  const int ps_b = max(ps[l], 1);
  const int p = partition_of(t, ps_b, P);
  const int k = ks[l * KP + p];
  const bool act = t >= order && t < lengths[l] && (fl & 2) == 0;
  const int d = verb ? (act ? k : 0) : (int)deltas[at];
  const int ol = warp_exclusive_sum(d, lane);
  const int pstart = p == 0 ? order : (int)((unsigned)p * (unsigned)ps_b);
  const int res = decode_sample(word, sa, d, ol, base & 31, k, t == pstart,
                                pbits[l], verb);
  int val = d > 0 ? res : 0;
  if (t < order) val = t < WM ? warm[l * WM + t] : 0;
  out[at] = val;
}

int64_t blocks_for(int64_t n) { return (n + kWarps - 1) / kWarps; }

}  // namespace

extern "C" int cxk_entropy_delta_slots_parent(
    const int* slots, const unsigned char* deltas, const int* ks, int64_t KP,
    int64_t P, const int* ps, const int* orders, const int* pbits,
    const int* vflags, const int* warm, int64_t WM, int* out, int64_t L,
    int64_t NC, int64_t SA, void* cuda_stream) {
  const int64_t n = L * NC;
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  const unsigned blocks = (unsigned)blocks_for(n);
  const unsigned* w = (const unsigned*)slots;
  if (SA <= kMaxStagedSA) {
    delta_slots_kernel<true><<<blocks, kWarps * 32,
                               (size_t)kWarps * SA * 4, s>>>(
        w, deltas, ks, KP, (int)P, ps, orders, pbits, vflags, warm, WM, out,
        L, NC, (int)SA);
  } else {
    delta_slots_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
        w, deltas, ks, KP, (int)P, ps, orders, pbits, vflags, warm, WM, out,
        L, NC, (int)(SA > INT32_MAX ? INT32_MAX : SA));
  }
  return (int)cudaGetLastError();
}

extern "C" int cxk_entropy_delta_stream_parent(
    const int* stream, int64_t W, const int* bases, const signed char* deltas,
    const int* ks, int64_t KP, int64_t P, const int* ps, const int* orders,
    const int* pbits, const int* flags, const int* warm, int64_t WM,
    const int* lengths, int* out, int64_t L, int64_t NC, int64_t SA,
    void* cuda_stream) {
  const int64_t n = L * NC;
  if (n <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  const unsigned blocks = (unsigned)blocks_for(n);
  const unsigned* w = (const unsigned*)stream;
  if (SA <= kMaxStagedSA) {
    delta_stream_kernel<true><<<blocks, kWarps * 32,
                                (size_t)kWarps * SA * 4, s>>>(
        w, W, bases, deltas, ks, KP, (int)P, ps, orders, pbits, flags, warm,
        WM, lengths, out, L, NC, (int)SA);
  } else {
    delta_stream_kernel<false><<<blocks, kWarps * 32, 0, s>>>(
        w, W, bases, deltas, ks, KP, (int)P, ps, orders, pbits, flags, warm,
        WM, lengths, out, L, NC, (int)(SA > INT32_MAX ? INT32_MAX : SA));
  }
  return (int)cudaGetLastError();
}
