// K7: the subframe walk, on Hopper.
//
// Replaces claxon_tpu/ops/demux.py::walk_frames / _walk_subframe (an XLA
// program on the TPU). For each frame f, starting at bit start_bits[f] of
// the big-endian stream, the walk parses nch subframes in turn (channel
// c + 1 starts where channel c ends): the subframe header and wasted bits,
// the warm-up samples, the LPC precision, shift and coefficients, the
// residual header, and then every residual code, whose value it decodes
// (Rice with u32-wrapping zig-zag, or sign-extended sf_bps-bit fields for
// verbatim lanes). Per lane (frame f, channel c at row f * nch + c) it
// writes the descriptors, the Rice parameter of each partition, the bit
// position of each 32-sample chunk and the decoded values; per frame the
// byte-aligned end bit and ok.
//
// ok reproduces the JAX walk's accept set: it is false for a reserved
// subframe type, an escape code or any code longer than 32 bits, more than
// 64 partitions, a block size not divisible by the partition count, an
// order not below the partition size, an LPC precision code of 15 or a
// negative QLP shift, wasted bits >= bps or a subframe bps above 32, and a
// chunk spanning more than 64 words. Reads past the stream end give zero
// bits, as the JAX program's padded row gather does.
//
// What bounds it on this card: the walk is bit-serial along a frame (each
// code's start depends on the previous code's length, and channel c + 1 on
// channel c's end), so a frame is one chain of nch * T dependent steps
// (8,192 at a 4096-sample stereo frame); frames are independent, and a
// batch has a few thousand of them, about one warp per scheduler. So the
// latency of one step of that chain bounds it, not bytes (the outputs,
// 134 MB at the headline batch, take 0.05 ms) and not operations. The
// first design (one thread per frame, the next word loaded one word ahead
// from global memory) waited a memory round trip every few codes.
//
// Design: one thread per frame, 32 frames per warp, and per code step a
// dependency chain of clz, add, min, two funnel shifts and a select.
// - Header fields are read from global memory (a few reads a subframe).
// - The residual's bits come through a ring of 128 words per walker in
//   shared memory, fed by cp.async 16-byte copies (4-byte copies when the
//   stream view is not 16-byte aligned; the zero-fill form at the stream
//   end). cp.async groups are counted per warp, so the warp refills all
//   its rings together at each 32-position chunk, kAhead units past each
//   cursor, and waits only for the copies of kLag chunks before.
// - The window (four words in registers) moves without a branch; the word
//   entering it on a slide is read from the ring a step ahead of its use.
// - The chunk loop is warp-uniform; inside a chunk each lane's codes are
//   split at its partition starts, so the inner loop has k fixed and no
//   per-code mode tests. Per chunk the walk records the cursor and k
//   (scratch), per lane the residual's shape (scratch).
// - values_kernel, one thread per (lane, chunk), decodes the chunk's 32
//   values from its recorded cursor, in the walk's arithmetic, into a
//   shared tile; each warp then writes its 32 chunks (4 KB of contiguous
//   output) as coalesced 16-byte stores, and the chunk bases. Chunks past
//   the block size get zeros and no decode. Asked for them (the
//   segmented delta decode, K10), it also writes each code's bit advance
//   as int8 (the JAX walk's deltas); the values-only kernel is a separate
//   instantiation, unchanged. (Decoding the values in the
//   walk itself, off the chain, was slower: the step's time follows its
//   instruction count.)
// Launch shape: 32 frames per warp (every lane walks), kWalkWarps = 2
// warps per block. Of the shapes measured on the headline and mixed
// groups (32 frames per warp with 1, 2 or 4 warps a block, 16 with 4, 8
// with 8; PERF.md), no 32-frame shape was more than a few percent from
// another, and 8 frames per warp was 12-17% slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPCap = 64;
// Ring per walker: 32 units of 16 bytes (128 stream words).
constexpr int kRingUnits = 32;
constexpr int kWalkWarps = 2;

__device__ __forceinline__ unsigned top_bits(unsigned hi, int n) {
  return n == 0 ? 0u : hi >> (32 - n);
}

__device__ __forceinline__ int sext(unsigned v, int n) {
  const unsigned sbit = 1u << (n > 1 ? n - 1 : 0);
  return (int)((v ^ sbit) - sbit);
}

__device__ __forceinline__ unsigned word_at(const unsigned* s, int64_t W,
                                            int64_t i) {
  return (i >= 0 && i < W) ? __ldg(s + i) : 0u;
}

// cp.async: a copy from global to shared memory that the thread does not
// wait for (16 bytes, of which `bytes` are read and the rest zero-filled;
// or 4 bytes), grouped by commit and waited for by group count.
__device__ __forceinline__ void cp_async16(unsigned* dst, const unsigned* src,
                                           int bytes) {
  const uint32_t sdst = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sdst),
               "l"(src), "r"(bytes)
               : "memory");
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
// Waits until at most n of the newest groups are pending. The hardware
// counts groups per warp, so commits and waits are made warp-wide.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Global-memory reader: a three-word window that slides forward a word at
// a time (zero bits outside the stream).
struct Reader {
  const unsigned* s;
  int64_t W;
  int64_t wi;  // word index of w0
  unsigned w0, w1, w2;

  // The 32 bits starting at bit pos.
  __device__ unsigned peek(int64_t pos) {
    const int64_t q = pos >> 5;
    if (q != wi) {
      if (q == wi + 1) {
        w0 = w1;
        w1 = w2;
      } else {
        w0 = word_at(s, W, q);
        w1 = word_at(s, W, q + 1);
      }
      w2 = word_at(s, W, q + 2);
      wi = q;
    }
    return __funnelshift_l(w1, w0, (unsigned)(pos & 31));
  }
};

// The walker's shared-memory ring: kRingUnits 16-byte units (stream
// words 4u .. 4u + 3 in unit u mod kRingUnits), contiguous per walker.
//
// cp.async groups are counted per warp, not per thread, so the ring is
// refilled by the whole warp at once: at the top of every 32-position
// chunk each walker issues the units up to kAhead past its cursor's unit,
// the warp commits one group and waits until at most kLag groups are
// pending. A chunk moves the cursor by at most 32 codes of 32 bits (8
// units, 10 with the window's four words and the word read ahead), so the
// units it reads were issued kLag chunks earlier as long as
// kAhead >= 8 kLag + 11. (A lag of 2 chunks measured no faster.)
constexpr int kLag = 1;

template <bool kVec16>
struct Ring {
  static constexpr int kAhead = 10 * (kLag + 1);
  static_assert(kAhead < kRingUnits, "the ring must hold kAhead units");
  static_assert(kAhead >= 8 * kLag + 11, "a chunk reads ahead of its copies");
  static constexpr unsigned kMask = kRingUnits * 4 - 1;
  const unsigned* s;
  int64_t W;
  unsigned* words;  // this walker's ring
  int64_t wi0;      // word index of w0 at start()
  unsigned r0, r;   // (wi0 + 4) and (the current w0's index + 4), mod 2^32
  int64_t issued;   // the next unit to copy
  unsigned w0, w1, w2, w3;  // stream words wi .. wi + 3
  int off;          // bit offset of the cursor in w0
  unsigned h;       // the 32 bits at the cursor

  __device__ int64_t wi() const { return wi0 + (int)(r - r0); }
  __device__ unsigned read(unsigned w) const { return words[w & kMask]; }

  // Starts copying unit u into its slot (zeros outside the stream).
  __device__ void put(int64_t u) const {
    unsigned* dst = words + ((unsigned)u * 4 & kMask);
    const int64_t w = u * 4;
    if (kVec16) {
      const int64_t n = w < 0 || w >= W ? 0 : (W - w < 4 ? W - w : 4);
      if (n == 0)
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      else
        cp_async16(dst, s + w, (int)n * 4);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (w + i >= 0 && w + i < W)
          cp_async4(dst + i, s + w + i);
        else
          dst[i] = 0u;
      }
    }
  }

  __device__ void fill() {
    for (const int64_t end = (wi() >> 2) + kAhead; issued < end; ++issued)
      put(issued);
  }

  // Warp-wide: positions each walking lane's window at its bit pos, fills
  // the ring ahead of it and waits for all of it.
  __device__ void start(bool on, int64_t pos) {
    if (on) {
      wi0 = pos >> 5;
      r0 = r = (unsigned)wi0 + 4;
      off = (int)(pos & 31);
      issued = wi0 >> 2;
      fill();
    }
    __syncwarp();
    cp_async_commit();
    cp_async_wait<0>();
    if (on) {
      w0 = read(r - 4);
      w1 = read(r - 3);
      w2 = read(r - 2);
      w3 = read(r - 1);
      h = __funnelshift_l(w1, w0, (unsigned)off);
    }
  }

  // Warp-wide, at the top of a chunk.
  __device__ void refill(bool on) {
    if (on) fill();
    __syncwarp();
    cp_async_commit();
    cp_async_wait<kLag>();
  }

  __device__ int64_t cur() const { return wi() * 32 + off; }
  __device__ unsigned peek() const { return h; }

  // Moves the cursor to bit offset o (< 64) of w0, without a branch: the
  // next window is taken from w0:w1 or w1:w2 (both shifts by o mod 32 run
  // beside the compare), and the word that enters the window on a slide
  // is read from the ring before and used two slides later.
  __device__ void move_to(int o) {
    const unsigned x = read(r);
    const bool sl = o >= 32;
    const unsigned ha = __funnelshift_l(w1, w0, (unsigned)o);
    const unsigned hb = __funnelshift_l(w2, w1, (unsigned)o);
    h = sl ? hb : ha;
    off = o & 31;
    w0 = sl ? w1 : w0;
    w1 = sl ? w2 : w1;
    w2 = sl ? w3 : w2;
    w3 = sl ? x : w3;
    r += sl;
  }
  // Moves the cursor forward by a <= 32 bits.
  __device__ void advance(int a) { move_to(off + a); }
};

struct LaneOut {
  int *order, *shift, *wasted, *n_parts, *ps, *pbits, *flags, *warm, *coefs,
      *ks, *bases, *sa_words, *values;
};

// Per-lane scratch for the values pass: the residual's shape.
struct Shape {
  int64_t* state;  // per chunk: cursor * 32 + k in force at its start
  int4* desc;      // per lane: {mode | pbits << 4 | sf_r << 8, order, ps,
                   //            end position}; mode 1 Rice, 2 verbatim
};

// Fixed-predictor coefficients of order o, oldest tap first: they occupy
// slots 32 - o .. 31 of the order-aligned LPC row (claxon
// src/subframe.rs:524-583).
__constant__ int kFixed[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {-1, 2, 0, 0}, {1, -3, 3, 0}, {-1, 4, -6, 4}};

// Walks the cursor of one subframe, warp-wide: each lane with `has` parses
// lane `lane`'s subframe from bit pos; the lanes' Rice residuals are then
// walked together, one code position of every lane per step. Returns the
// end bit and clears *ok when the lane leaves the device path.
template <bool kVec16>
__device__ int64_t walk_subframe(Reader& rd, Ring<kVec16>& ring,
                                 const LaneOut& o, const Shape& sh, bool has,
                                 int64_t lane, int64_t pos, int bs,
                                 int ch_bps, int T, int NC, bool* ok) {
  bool okc = true, is_const = false, is_verb = false, resd_l = false;
  int pbits = 0, n_parts = 1, ps_s = 1, order_l = 0, sf_bps = 0, sf_r = 1;
  int t_end = 0;
  int64_t rel = pos;
  if (has) {
    unsigned hi = rd.peek(pos);
    okc &= (hi >> 31) == 0;
    const int ty = (int)((hi >> 25) & 63u);
    const bool wflag = ((hi >> 24) & 1u) != 0;
    rel = pos + 8;
    is_const = ty == 0;
    is_verb = ty == 1;
    const bool is_fixed = (ty & 0x38) == 0x08, is_lpc = ty >= 32;
    const int f_ord = ty & 7;
    const int order = is_const ? 1
                      : is_fixed ? f_ord
                      : is_lpc   ? (ty & 31) + 1
                                 : 0;
    okc &= is_const || is_verb || (is_fixed && f_ord <= 4) || is_lpc;

    // Wasted bits: a flag, then a unary count (64 when the window is 0).
    const unsigned whi = rd.peek(rel), wlo = rd.peek(rel + 32);
    const int z = whi ? __clz(whi) : 32 + __clz(wlo);
    const int wasted = wflag ? z + 1 : 0;
    rel += wasted;
    okc &= wasted < ch_bps;
    sf_bps = ch_bps - wasted;
    okc &= sf_bps <= 32;
    sf_r = sf_bps < 1 ? 1 : (sf_bps > 32 ? 32 : sf_bps);

    // Warm-up samples (a constant's value is its one warm-up sample).
    const int warm_order = is_verb ? 0 : (order < 32 ? order : 32);
    int4* warm = reinterpret_cast<int4*>(o.warm + lane * 32);
    for (int i4 = 0; i4 < 8; ++i4) {
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i4 * 4 + u;
        v[u] = i < warm_order ? sext(top_bits(rd.peek(rel + (int64_t)i * sf_r),
                                              sf_r),
                                     sf_r)
                              : 0;
      }
      warm[i4] = make_int4(v[0], v[1], v[2], v[3]);
    }
    rel += (int64_t)warm_order * sf_r;

    // LPC precision, shift and coefficients (slot 31 - i holds coef i).
    hi = rd.peek(rel);
    const int prec = (int)((hi >> 28) & 15u) + 1;
    okc &= !is_lpc || prec != 16;
    const int shift5 = sext((hi >> 23) & 31u, 5);
    okc &= !is_lpc || shift5 >= 0;
    if (is_lpc) rel += 9;
    int4* coefs = reinterpret_cast<int4*>(o.coefs + lane * 32);
    for (int s4 = 0; s4 < 8; ++s4) {
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = 31 - (s4 * 4 + u);  // slot s4 * 4 + u holds coef i
        int cv = 0;
        if (is_lpc && i < order)
          cv = sext(top_bits(rd.peek(rel + (int64_t)i * prec), prec), prec);
        if (is_fixed) {
          const int fo = f_ord <= 4 ? f_ord : 4;
          cv = i < fo ? kFixed[fo][fo - 1 - i] : 0;
        }
        if (is_const && i == 0) cv = 1;
        v[u] = cv;
      }
      coefs[s4] = make_int4(v[0], v[1], v[2], v[3]);
    }
    if (is_lpc) rel += (int64_t)order * prec;

    // Residual header (fixed and LPC lanes).
    const bool resd = is_fixed || is_lpc;
    hi = rd.peek(rel);
    const int meth = (int)(hi >> 30);
    okc &= !resd || meth <= 1;
    const int po = (int)((hi >> 26) & 15u);
    if (resd) rel += 6;
    pbits = resd ? 4 + meth : 0;
    n_parts = resd ? (1 << po) : 1;
    okc &= !resd || n_parts <= kPCap;
    const int ps =
        (resd && n_parts <= kPCap) ? (int)((unsigned)bs >> po) : bs;
    okc &= !resd || (bs & (n_parts - 1)) == 0;
    okc &= !resd || order < (ps > 1 ? ps : 1);

    o.order[lane] = is_verb ? 0 : order;
    o.shift[lane] = is_lpc ? shift5 : 0;
    o.wasted[lane] = wasted;
    o.n_parts[lane] = n_parts;
    o.ps[lane] = ps;
    o.pbits[lane] = pbits;
    o.flags[lane] = is_const ? 2 : (is_verb ? 1 : 0);

    // The residual: codes at positions [order, t_end) (Rice) or
    // [0, t_end) (verbatim).
    ps_s = ps > 1 ? ps : 1;
    resd_l = resd && okc;
    const bool verb_l = is_verb && okc;
    order_l = is_verb ? 0 : order;
    const int t_cap = bs < NC * 32 ? bs : NC * 32;
    t_end = (resd_l || verb_l) && t_cap > 0 ? t_cap : 0;
    sh.desc[lane] = make_int4(
        (resd_l ? 1 : (verb_l ? 2 : 0)) | pbits << 4 | sf_r << 8, order_l,
        ps_s, t_end);
  }

  // Chunk records: the cursor and k at each chunk's first position, and the
  // largest chunk span over the first ncl chunks (from the int32 bases).
  int64_t* state = sh.state + lane * NC;
  const int ncl = (bs + 31) >> 5;
  int rec = 0, prev_b = 0, last_b = 0;
  int64_t span_max = 0;
  auto record = [&](int64_t cur, int k) {
    const int b = (int)cur;
    state[rec] = cur * 32 + k;
    if (rec >= 1 && rec < ncl) {
      const int64_t span = (int64_t)b - prev_b;
      span_max = span > span_max ? span : span_max;
    }
    if (rec == ncl - 1) last_b = b;
    prev_b = b;
    ++rec;
  };

  // ks[p] is the Rice parameter in force at position t_p (t_0 = order,
  // t_p = p * ps), clipped to T - 1, for p below the partition count: the
  // parameter read at partition p's first code, or the one in force after
  // position T - 1 (k_t) for partitions that start past it.
  const int plim = n_parts < kPCap ? n_parts : kPCap;
  int* ks = o.ks + lane * kPCap;
  const bool rice = has && resd_l && order_l < t_end;
  const bool verb = has && !resd_l && t_end > 0;
  int k = 0, k_t = 0, n_t = 0;
  int64_t cur = rel;
  if (verb) {
    // Verbatim codes are sf_r bits each: no walk.
    while (rec < NC) {
      const int t = rec * 32 < t_end ? rec * 32 : t_end;
      record(rel + (int64_t)t * sf_r, 0);
    }
    cur = rel + (int64_t)t_end * sf_r;
  }
  if (__any_sync(0xffffffffu, rice)) {
    // The Rice lanes of the warp, one code position of each per step, for
    // the chunks up to the warp's last code.
    const int nc_stop =
        (int)((__reduce_max_sync(0xffffffffu, rice ? (unsigned)t_end : 0u) +
               31) >> 5);
    int n_seen = 0, mx = 0, nb = order_l;
    bool escape = false;
    const int full = (1 << pbits) - 1;
    ring.start(rice, rel);
    for (int c = 0; c < nc_stop; ++c) {
      ring.refill(rice);
      if (rice) {
        record(ring.cur(), k);
        const int t0 = c * 32;
        const int ja = order_l > t0 ? order_l - t0 : 0;
        const int jb = t_end - t0 < 32 ? t_end - t0 : 32;
        // k_t: position T - 1 may also lie before the chunk's first code
        // or after its last.
        const bool in_c = T - 1 >= t0 && T - 1 < t0 + 32;
        if (in_c && T - 1 < t0 + ja) {
          k_t = k;
          n_t = n_seen;
        }
        // The chunk's codes, split at partition starts: the inner loop is
        // peek, clz, advance with k fixed.
        const int end = t0 + jb;
        int t = t0 + ja;
        while (t < end) {
          if (t == nb) {
            // A partition's first code: its Rice parameter, then the code.
            const unsigned h = ring.peek();
            const int kr = (int)top_bits(h, pbits);
            escape |= kr == full;
            k = kr;
            nb = t == order_l ? ps_s : t + ps_s;
            if (t < T && n_seen < plim) ks[n_seen] = k;
            ++n_seen;
            const int adv = pbits + __clz(h << pbits) + 1 + k;
            mx = adv > mx ? adv : mx;
            ring.advance(adv < 32 ? adv : 32);
            if (t == T - 1) {
              k_t = k;
              n_t = n_seen;
            }
            ++t;
          }
          const int stop = end < nb ? end : nb;
          if (T - 1 >= t && T - 1 < stop) {
            k_t = k;
            n_t = n_seen;
          }
          const int k1 = k + 1;
          for (; t < stop; ++t) {
            // The chain: clz, add, min, two funnel shifts, select.
            const int zz = __clz(ring.peek());
            const int o = ring.off + zz + k1, o32 = ring.off + 32;
            mx = zz + k1 > mx ? zz + k1 : mx;
            ring.move_to(o < o32 ? o : o32);
          }
        }
        if (in_c && T - 1 >= t0 + (ja > jb ? ja : jb)) {
          k_t = k;
          n_t = n_seen;
        }
      }
    }
    if (rice) {
      if (T - 1 >= nc_stop * 32) {
        k_t = k;
        n_t = n_seen;
      }
      okc &= !escape && mx <= 32;
      cur = ring.cur();
    }
    cp_async_wait<0>();
  }
  if (has) {
    while (rec < NC) record(cur, k);
    const int n_w = n_t < plim ? n_t : plim;
    for (int p = n_w; p < kPCap; ++p) ks[p] = p < plim ? k_t : 0;
    if (is_verb) ks[0] = sf_bps;

    const int end32 = (int)cur;
    if (ncl >= 1 && ncl <= NC) {
      const int64_t span = (int64_t)end32 - last_b;
      span_max = span > span_max ? span : span_max;
    }
    o.sa_words[lane] = is_const ? 0 : (int)((span_max >> 5) + 2);
    okc &= is_const || span_max <= 64 * 32;
    *ok = *ok && okc;
  }
  return cur;
}

// One lane per frame; every lane of the warp runs the loops (lanes past
// F walk nothing) so the ring's refills stay warp-wide.
template <bool kVec16>
__global__ void walk_kernel(const unsigned* __restrict__ stream, int64_t W,
                            const int* __restrict__ start_bits,
                            const int* __restrict__ bs,
                            const int* __restrict__ modes,
                            const int* __restrict__ bps0, int64_t F, int T,
                            int nch, LaneOut o, Shape sh,
                            int* __restrict__ end_bits,
                            unsigned char* __restrict__ ok_out) {
  __shared__ uint4 ring_units[32 * kWalkWarps * kRingUnits];
  const int64_t f = (int64_t)blockIdx.x * (32 * kWalkWarps) + threadIdx.x;
  const bool has = f < F;
  const int NC = (T + 31) / 32;
  const int b = has ? bs[f] : 0, mode = has ? modes[f] : 0;
  const int bps = has ? bps0[f] : 0;
  Reader rd{stream, W, INT64_MIN, 0u, 0u, 0u};
  Ring<kVec16> ring{
      stream, W,
      reinterpret_cast<unsigned*>(ring_units + threadIdx.x * kRingUnits)};
  int64_t pos = has ? start_bits[f] : 0;
  bool ok = b >= 1 && b <= T;
  for (int ch = 0; ch < nch; ++ch) {
    // Stereo: the side channel carries one extra bit (left/side and
    // mid/side: channel 1; right/side: channel 0).
    const int side = nch == 2 && ((ch == 1 && (mode == 1 || mode == 3)) ||
                                  (ch == 0 && mode == 2))
                         ? 1
                         : 0;
    pos = walk_subframe(rd, ring, o, sh, has, has ? f * nch + ch : 0, pos, b,
                        bps + side, T, NC, &ok);
  }
  if (has) {
    end_bits[f] = (int)((pos + 7) & ~(int64_t)7);
    ok_out[f] = ok ? 1 : 0;
  }
}

constexpr int kValuesWarps = 8;

// One thread per (lane, chunk) g = lane * NC + c: the chunk's 32 values
// from its recorded cursor, then coalesced stores of the warp's 32 chunks.
// With kDeltas it also writes each code's bit advance (the JAX walk's
// int8 deltas: the cursor step, including the Rice parameter at a
// partition's first code; 0 at inactive positions) through a second
// shared tile, 1 KB of contiguous output a warp.
template <bool kDeltas>
__global__ void values_kernel(const unsigned* __restrict__ stream, int64_t W,
                              Shape sh, int64_t G, int NC,
                              int* __restrict__ values,
                              int* __restrict__ bases,
                              signed char* __restrict__ deltas) {
  __shared__ int tile[kValuesWarps][32][33];
  // 32 bytes a chunk, row stride 36 bytes (one word when unused).
  __shared__ unsigned
      dtile[kDeltas ? kValuesWarps : 1][32][kDeltas ? 9 : 1];
  const int i = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t g0 = (int64_t)blockIdx.x * blockDim.x + w * 32;
  const int64_t g = g0 + i;
  int* row = tile[w][i];
  unsigned char* drow = reinterpret_cast<unsigned char*>(dtile[0][0]);
  if constexpr (kDeltas)
    drow = reinterpret_cast<unsigned char*>(dtile[w][i]);
  bool decoded = false;
  if (g < G) {
    const int64_t lane = g / NC;
    const int c = (int)(g - lane * NC);
    const int64_t st = sh.state[g];
    int64_t cur = st >> 5;
    int k = (int)(st & 31);
    bases[g] = (int)cur;
    const int4 d = sh.desc[lane];
    const int mode = d.x & 3;
    const int pbits = (d.x >> 4) & 15, sf_r = d.x >> 8;
    const int order_l = d.y, ps_s = d.z, t_end = d.w;
    const int t0 = c * 32;
    Reader rd{stream, W, INT64_MIN, 0u, 0u, 0u};
    if (mode == 1 && t0 < t_end) {
      int nb = t0 <= order_l ? order_l : (t0 + ps_s - 1) / ps_s * ps_s;
      for (int j = 0; j < 32; ++j) {
        const int t = t0 + j;
        int val = 0, na = 0;
        if (t >= order_l && t < t_end) {
          const unsigned h = rd.peek(cur);
          int shb = 0;
          if (t == nb) {
            k = (int)top_bits(h, pbits);
            shb = pbits;
            nb = t == order_l ? ps_s : t + ps_s;
          }
          const unsigned h2 = h << shb;
          const int zz = __clz(h2);  // 32 for 0
          const int adv = shb + zz + 1 + k;
          const int kc = k < 31 ? k : 31;
          int rsh = 32 - zz - 1 - k;
          rsh = rsh < 0 ? 0 : (rsh > 31 ? 31 : rsh);
          const unsigned r = (h2 >> rsh) & (k == 0 ? 0u : (1u << kc) - 1u);
          const unsigned vv = ((unsigned)zz << kc) | r;
          val = (int)((vv & 1u) ? ~(vv >> 1) : (vv >> 1));
          na = adv < 32 ? adv : 32;
          cur += na;
        }
        row[j] = val;
        if constexpr (kDeltas) drow[j] = (unsigned char)na;
      }
      decoded = true;
    } else if (mode == 2 && t0 < t_end) {
      for (int j = 0; j < 32; ++j) {
        int val = 0, na = 0;
        if (t0 + j < t_end) {
          val = sext(top_bits(rd.peek(cur), sf_r), sf_r);
          na = sf_r;
          cur += sf_r;
        }
        row[j] = val;
        if constexpr (kDeltas) drow[j] = (unsigned char)na;
      }
      decoded = true;
    }
  }
  if (!decoded) {
    for (int j = 0; j < 32; ++j) row[j] = 0;
    if constexpr (kDeltas)
      for (int j = 0; j < 8; ++j) dtile[w][i][j] = 0u;
  }
  __syncwarp();
  // The warp's chunks are 32 consecutive rows of 32 values: 4 KB of
  // contiguous output, written as 8 coalesced int4 stores per thread.
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int q = m * 32 + i, r = q >> 3, c4 = (q & 7) * 4;
    if (g0 + r < G) {
      const int* src = tile[w][r] + c4;
      reinterpret_cast<int4*>(values + (g0 + r) * 32)[c4 >> 2] =
          make_int4(src[0], src[1], src[2], src[3]);
    }
  }
  if constexpr (kDeltas) {
    // And their deltas: 32 rows of 32 bytes, 2 int4 stores per thread.
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int q = m * 32 + i, r = q >> 1, h = q & 1;
      if (g0 + r < G) {
        const unsigned* src = dtile[w][r] + 4 * h;
        reinterpret_cast<int4*>(deltas + (g0 + r) * 32)[h] =
            make_int4((int)src[0], (int)src[1], (int)src[2], (int)src[3]);
      }
    }
  }
}

}  // namespace

// state (F * nch * NC int64) and desc (F * nch int4) are scratch; deltas
// ((F * nch, NC * 32) int8) is written when it is not null.
extern "C" int cxk_walk_frames(const int* stream, int64_t W,
                               const int* start_bits, const int* bs,
                               const int* modes, const int* bps0, int64_t F,
                               int64_t T, int64_t nch, int* order,
                               int* shift, int* wasted, int* n_parts, int* ps,
                               int* pbits, int* flags, int* warm, int* coefs,
                               int* ks, int* bases, int* sa_words,
                               int* values, signed char* deltas,
                               int* end_bits, unsigned char* ok,
                               int64_t* state, int* desc, void* cuda_stream) {
  if (F <= 0) return (int)cudaGetLastError();
  const LaneOut o{order, shift, wasted, n_parts, ps, pbits, flags,
                  warm,  coefs, ks,     bases,   sa_words, values};
  const Shape sh{state, reinterpret_cast<int4*>(desc)};
  const cudaStream_t st = (cudaStream_t)cuda_stream;
  const unsigned* s = (const unsigned*)stream;
  const int per_block = 32 * kWalkWarps;
  const unsigned blocks = (unsigned)((F + per_block - 1) / per_block);
  if (((uintptr_t)stream & 15) == 0)
    walk_kernel<true><<<blocks, per_block, 0, st>>>(
        s, W, start_bits, bs, modes, bps0, F, (int)T, (int)nch, o, sh,
        end_bits, ok);
  else
    walk_kernel<false><<<blocks, per_block, 0, st>>>(
        s, W, start_bits, bs, modes, bps0, F, (int)T, (int)nch, o, sh,
        end_bits, ok);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int NC = (int)((T + 31) / 32);
  const int64_t G = F * nch * NC;
  const int vthreads = 32 * kValuesWarps;
  const unsigned vblocks = (unsigned)((G + vthreads - 1) / vthreads);
  if (deltas != nullptr)
    values_kernel<true><<<vblocks, vthreads, 0, st>>>(s, W, sh, G, NC,
                                                      values, bases, deltas);
  else
    values_kernel<false><<<vblocks, vthreads, 0, st>>>(s, W, sh, G, NC,
                                                       values, bases,
                                                       nullptr);
  return (int)cudaGetLastError();
}
