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
// What bounds it on this card: the decode is bit-serial inside a chunk
// (each code's start depends on the previous code's length), so a chunk
// is a chain of 32 dependent steps; chunks are independent, giving
// L * NC threads (885K for the main-path bucket), plenty to fill the card.
//
// First design: one thread per (lane, chunk). Each step reads up to three
// stream words around the cursor (cached loads), builds the 64-bit window
// with funnel shifts and counts the quotient with clz. Every index is
// clamped exactly where the JAX program clamps -- the stream word index
// to [0, W-1] and the in-chunk word to [0, SA-1] -- so a fuzzed stream
// reads only inside the upload and the result equals the plain form's.
// Every shift by a variable amount goes through shl/shr, which give 0 for
// amounts >= 32 like XLA's shifts. Later work: stage each chunk's words
// in registers, stage the output through shared memory so the stores
// coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Logical shifts with XLA semantics: an amount >= 32 (as unsigned) gives 0.
__device__ __forceinline__ unsigned shl(unsigned v, int s) {
  return (unsigned)s >= 32u ? 0u : v << s;
}
__device__ __forceinline__ unsigned shr(unsigned v, int s) {
  return (unsigned)s >= 32u ? 0u : v >> s;
}

__global__ void entropy_kernel(
    const unsigned* __restrict__ stream, int64_t W,
    const int* __restrict__ bases, const int* __restrict__ ks, int64_t KP,
    int64_t P, const int* __restrict__ ps, const int* __restrict__ orders,
    const int* __restrict__ pbits, const int* __restrict__ flags,
    const int* __restrict__ warm, int64_t WM,
    const int* __restrict__ lengths, int* __restrict__ out, int64_t L,
    int64_t NC, int64_t SA) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L * NC) return;
  const int64_t l = i / NC;
  const int c = (int)(i - l * NC);
  const int64_t T = NC * 32;
  int* o = out + l * T + (int64_t)c * 32;

  const int order = orders[l];
  const int ps_b = max(ps[l], 1);
  const int pb = pbits[l];
  const int fl = flags[l];
  const bool verb = (fl & 1) != 0;
  const bool has_codes = (fl & 2) == 0;
  const int length = lengths[l];
  const int* krow = ks + l * KP;

  const int base = bases[l * NC + c];
  const int wi0 = base >> 5;  // arithmetic, as in JAX
  const int sa = (int)SA;
  // Word jj of the chunk's gathered slots (jj in [0, SA)).
  auto slot = [&](int jj) -> unsigned {
    int64_t idx = (int64_t)wi0 + jj;
    idx = idx < 0 ? 0 : (idx > W - 1 ? W - 1 : idx);
    return stream[idx];
  };

  int cursor = base & 31;
  for (int j = 0; j < 32; ++j) {
    const int t = c * 32 + j;
    const bool active = t >= order && t < length && has_codes;
    int p = 0;
    for (int m = 1; m < P; ++m)
      p += t >= (int)((unsigned)m * (unsigned)ps_b) ? 1 : 0;
    const int k = krow[p];
    const int pstart = p == 0 ? order : (int)((unsigned)p * (unsigned)ps_b);
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
    o[j] = val;
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
  if (n > 0) {
    const int threads = 256;
    const int64_t blocks = (n + threads - 1) / threads;
    entropy_kernel<<<(unsigned)blocks, threads, 0,
                     (cudaStream_t)cuda_stream>>>(
        (const unsigned*)stream, W, bases, ks, KP, P, ps, orders, pbits,
        flags, warm, WM, lengths, out, L, NC, SA);
  }
  return (int)cudaGetLastError();
}
