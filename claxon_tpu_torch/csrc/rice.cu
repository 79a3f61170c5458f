// rice_decode on Hopper: one Rice partition a lane over a shared packed
// bit buffer, each lane's bits staged through a ring in shared memory.
//
// Replaces claxon_tpu/ops/rice.py:126 rice_decode (its program _rice_prog
// at :65, an XLA program on the TPU). No decode route runs it in either
// package; its callers are its tests and chip_smoke.py. Lane l reads
// counts[l] codes of parameter k = params[l] from bit start_bits[l] of
// the words (stream bit i is bit 31 - (i & 31) of word i >> 5): the unary
// quotient q up to the next set bit, the k-bit remainder r after it, the
// u32 fold v = (q << k) | r and the zig-zag sign; out[l, j] = 0 past the
// count, end_bits[l] the cursor after the last code.
//
// Exact on garbage, as the JAX program defines it: cursors are int32 and
// wrap (the arithmetic is done on unsigned values); word reads are
// clipped to [0, W-1]; shifts by 32 or more, the amount taken as
// unsigned, give 0 (shl / shr, csrc/shifts.cuh, as in K2); an inactive
// step writes 0 and leaves the cursor. The JAX search for the next set
// bit is one while_loop over all lanes with a global condition: a lane
// that runs off the buffer (masked word 0 at word W) moves on by one
// word for every iteration that any lane, active or not, still needs, N
// in all. rice_kernel decodes each lane alone and sets *flag when an
// active lane runs off the buffer; only then does rice_exact_kernel, one
// block that steps all lanes together and takes N as a block maximum,
// decode the whole input again. On real streams (pack_bits_be's all-ones
// guard word ends every search) the flag stays 0 and the second launch
// returns at once.
//
// What bounds it on this card: a lane's codes are serial (each code's
// start is the previous code's end), so a lane is a chain of dependent
// steps, and the 27,648 lanes of the headline shapes are 864 warps, 6.5
// an SM. Its bytes (the words, the lane arguments, the (L, T) output)
// take 0.0446 ms at 3.35 TB/s at 27,648 lanes of 1,024 codes. The first
// design (in git history; PERF.md §6, row rice_decode) read every code's
// words from global
// memory, three dependent loads a code, and one warp alone took about 880
// cycles a step (NVIDIA H100 80GB HBM3, 700 W power limit; PERF.md): the
// loads' latency set its time.
//
// Design: a lane's chain never waits on global memory while its bits are
// staged ahead of its cursor.
// - Each lane has a ring of kRingWords words in shared memory, laid out
//   word-interleaved (word i of lane t at row i mod kRingWords, column t),
//   so the 32 lanes of a warp read 32 banks whatever their cursors. It is
//   fed by 4-byte cp.async copies. cp.async groups are counted per warp,
//   so the warp refills all its rings together at the top of every
//   32-code chunk: each lane issues the 4-word units up to kAhead past
//   its cursor's unit, the warp commits one group and waits for the group
//   of the chunk before. E, the end of a lane's words that have landed,
//   is fixed for the chunk (at most W).
// - A window of five words (w0..w4, the words at the cursor's word wi and
//   after it) stays in registers, read again from the ring at each
//   chunk's top, with the 32 bits at the cursor in h. An action of a lane
//   on the ring: a code whose quotient ends within those 32 bits (h != 0)
//   takes its quotient and remainder from w0..w2; 32 zero bits (64 where
//   the next 32 are zero too) add to the quotient of the code in
//   progress. Either slides the window by 0, 1 or 2 words without a
//   branch; the two words that enter it are read from the ring at once
//   and used an action later at the earliest.
// - Each lane writes the fold (q << k) | r of the codes of its chunk to
//   its row of a shared tile at its own pace, a lane in a long zero run
//   taking more actions. While every lane with codes left is on the ring
//   (its words wi..wi+2 below E), an iteration is two actions of each
//   lane and no divergent path.
// - A lane leaves the ring for the rest of the chunk, and takes the
//   first design's global-memory path (search / decode_code, unchanged)
//   from the start of its code, when the ring cannot serve it exactly: a
//   k outside 0..31 (for the whole call), a cursor whose word is negative
//   or within kSlack words of the end (reads there are clipped, and a
//   search may run off the buffer), or a code that reaches past E (a
//   zero run longer than the landed words, or a cursor that outran
//   them). At the next chunk's top it starts its ring again at its
//   cursor if that lies in the buffer; the warp then waits for all its
//   copies once.
// - The tile (32 lanes by 32 codes, row stride 33, no bank conflicts) is
//   stored as 128-byte rows, the zig-zag sign applied on the way.
// Launch shape: a warp a block (864 blocks at the headline shapes, at most
// 7 warps an SM), 20.6 KB of shared memory a warp. What holds it now
// (PERF.md): a lane's serial chain of a few dozen instructions an
// action, most of them waiting on the one before, at 6.5 warps an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shifts.cuh"

namespace {

constexpr int kWarps = 1;          // warps per block of rice_kernel
constexpr int kTileStride = 33;    // output tile row stride (ints)
constexpr int kExactThreads = 1024;
constexpr int kRingWords = 128;    // ring words per lane, a power of two
constexpr int kAhead = 24;         // 4-word units issued ahead of the cursor
constexpr int kSlack = 8;          // no ring within this many end words
// Units in flight and the window stay within one ring's length, so a copy
// never lands on a word the lane may still read.
static_assert(4 * kAhead + 8 <= kRingWords, "the ring must hold kAhead");

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

// The global-memory step of a lane off the ring: the sample, and the
// cursor after it; found false when the lane ran off the buffer.
struct Slow {
  int v, pos;
  bool found;
};

__device__ __noinline__ Slow slow_step(const unsigned* __restrict__ words,
                                       int W, int pos, int k) {
  Slow s{0, pos, false};
  const Search f = search(words, W, pos);
  if (f.found) {
    s.v = decode_code(words, W, s.pos, f.wi, f.masked, k);
    s.found = true;
  }
  return s;
}

__device__ __forceinline__ void cp_async4(unsigned* dst, const unsigned* src) {
  const uint32_t sdst = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sdst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// A shared-memory load, ordered after the cp.async waits (volatile), and
// a store, at 32-bit shared addresses.
__device__ __forceinline__ unsigned ld_shared(uint32_t addr) {
  unsigned v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void st_shared(uint32_t addr, int v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
// x, as a value the compiler cannot recompute from what made it (the
// step loop keeps its shared addresses in registers).
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.u32 %0, %0;\n" : "+r"(x));
  return x;
}

__device__ __forceinline__ int zigzag(unsigned v) {
  return (int)((v >> 1) ^ (0u - (v & 1u)));
}

__global__ void __launch_bounds__(kWarps * 32)
rice_kernel(const unsigned* __restrict__ words, int W,
            const int* __restrict__ start_bits,
            const int* __restrict__ params, const int* __restrict__ counts,
            int64_t L, int T, int* __restrict__ out,
            int* __restrict__ end_bits, int* __restrict__ flag) {
  __shared__ int tile[kWarps][32 * kTileStride];
  __shared__ unsigned rings[kWarps][kRingWords][32];
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
  // Only k in 0..31 takes the ring (shifts by k are then plain shifts).
  const bool ringable = (unsigned)k < 32u;
  const int sh = 32 - k;
  // Word i of this lane's ring: row i mod kRingWords, this lane's
  // column, read at a shared address computed once.
  const uint32_t ring = opaque((uint32_t)__cvta_generic_to_shared(
      &rings[warp][0][lane]));
  // This lane's row of the output tile.
  const uint32_t trow = opaque((uint32_t)__cvta_generic_to_shared(
      &tile[warp][lane * kTileStride]));
  auto ring_at = [&](int i) {
    return ld_shared(ring + ((unsigned)i & (kRingWords - 1)) * 128u);
  };
  bool ok = true, fast = false;
  int wi = 0, off = 0;   // the cursor, while fast: bit off of word wi
  unsigned qa = 0;       // zero bits of the current code passed, while fast
  int issued = 0;        // the next unit to copy
  int E = 0;             // the end of the landed words (at most W)
  unsigned w0 = 0, w1 = 0, w2 = 0, w3 = 0, w4 = 0, h = 0;
  auto load_window = [&]() {
    w0 = ring_at(wi);
    w1 = ring_at(wi + 1);
    w2 = ring_at(wi + 2);
    w3 = ring_at(wi + 3);
    w4 = ring_at(wi + 4);
    h = __funnelshift_l(w1, w0, off);
  };
  int* t = tile[warp];
  for (int j0 = 0; j0 < T; j0 += 32) {
    // The warp's refill.
    const bool act = ok && j0 < n;
    const bool restart = act && !fast && ringable && pos >= 0 &&
                         (pos >> 5) <= W - kSlack;
    const bool any = __any_sync(0xffffffffu, restart);
    if (any) cp_async_wait<0>();  // no copy in flight onto a slot reused
    if (restart) {
      wi = pos >> 5;
      off = pos & 31;
      issued = wi >> 2;
      fast = true;
    }
    const int landed = issued;
    if (fast && act) {
      for (const int end = (wi >> 2) + kAhead; issued < end; ++issued) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int x = issued * 4 + i;
          if (x < W)
            cp_async4(&rings[warp][x & (kRingWords - 1)][lane], words + x);
        }
      }
    }
    __syncwarp();
    cp_async_commit();
    if (any) {
      cp_async_wait<0>();
      E = 4 * issued;
    } else {
      cp_async_wait<1>();
      E = 4 * landed;
    }
    E = E < W ? E : W;
    // The window again: its words past the last chunk's E were read
    // before they landed.
    if (fast) load_window();
    const int lim = E - 3;  // a step reads words wi .. wi + 2
    int c = 0;  // the codes this lane wrote in the chunk
    const int want = n - j0 < 32 ? n - j0 : 32;
    // One action on the ring: a code whose quotient ends within the 32
    // bits at the cursor goes to column c of the tile; 32 or 64 zero bits
    // move the cursor on and count into the quotient qa.
    auto ring_step = [&]() {
      const bool zero = h == 0u;
      const int q0 = __clz(h);           // 32 when zero
      const int p = off + q0 + 1;        // 1..63 for a code
      const bool zz = zero && __funnelshift_l(w2, w1, off) == 0u;
      const int no = zero ? off + (zz ? 64 : 32) : p + k;  // 1..95
      // The next window first: the cursor's chain.
      const bool s1 = no >= 32, s2 = no >= 64;
      const unsigned n0 = s2 ? w2 : (s1 ? w1 : w0);
      const unsigned n1 = s2 ? w3 : (s1 ? w2 : w1);
      const unsigned ra = __funnelshift_l(w1, w0, p);
      const unsigned rb = __funnelshift_l(w2, w1, p);
      const unsigned r = __funnelshift_rc(p & 32 ? rb : ra, 0u, sh);
      const unsigned n2 = s2 ? w4 : (s1 ? w3 : w2);
      wi += no >> 5;
      off = no & 31;
      h = __funnelshift_l(n1, n0, off);
      w0 = n0;
      w1 = n1;
      w2 = n2;
      w3 = ring_at(wi + 3);  // used an action later at the earliest
      w4 = ring_at(wi + 4);
      // The fold (q << k) | r; the writeback applies the zig-zag.
      if (!zero) st_shared(trow + 4u * (unsigned)c,
                           (int)(((qa + (unsigned)q0) << k) | r));
      c += !zero;
      qa = zero ? qa + (zz ? 64u : 32u) : 0u;
    };

    // Each lane writes its codes of the chunk to its tile row, at its own
    // pace: a lane in a zero run takes more actions. While every lane
    // with codes left is on the ring within E, an iteration is two
    // actions of each, without a divergent path.
    for (;;) {
      const bool pend = ok && c < want;
      const bool on = fast && wi <= lim;
      // Bit 0: a lane has codes left; bit 1: one of them is off the ring.
      const unsigned need = __reduce_or_sync(
          0xffffffffu, (unsigned)pend | (unsigned)(pend && !on) << 1);
      if (!(need & 1u)) break;
      if (!(need & 2u)) {
        if (pend) {  // two actions an iteration
          ring_step();
          if (c < want && wi <= lim) ring_step();
        }
      } else if (pend) {
        if (on) {
          ring_step();
        } else {
          if (fast) {  // off the ring until the next chunk, back at the
            fast = false;  // start of the code
            pos = (int)((unsigned)(wi * 32 + off) - qa);
            qa = 0u;
          }
          const Slow r = slow_step(words, W, pos, k);
          pos = r.pos;
          ok = r.found;  // else rice_exact_kernel decodes the input again
          if (ok)  // the fold again, as the ring's codes store it
            st_shared(trow + 4u * (unsigned)c++,
                      (int)(((unsigned)r.v << 1) ^ (unsigned)(r.v >> 31)));
        }
      }
    }
    for (; c < 32; ++c) st_shared(trow + 4u * (unsigned)c, 0);
    __syncwarp();
    const int cols = T - j0 < 32 ? T - j0 : 32;
    if (lane < cols)
      for (int r = 0; r < rows; ++r)
        out[(l0 + r) * (int64_t)T + j0 + lane] =
            zigzag((unsigned)t[r * kTileStride + lane]);
    __syncwarp();
  }
  cp_async_wait<0>();  // no copy outlives the block
  if (live) end_bits[l] = fast ? wi * 32 + off : pos;
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
extern "C" int cxk_rice_decode(const int* words, int64_t W,
                               const int* start_bits, const int* params,
                               const int* counts, int64_t L, int64_t T,
                               int* out, int* end_bits, int* flag,
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
