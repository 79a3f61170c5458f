// K7: the subframe walk, on Hopper.
//
// Replaces claxon_tpu/ops/demux.py::walk_frames / _walk_subframe (an XLA
// program on the TPU). For each frame f, starting at bit start_bits[f] of
// the big-endian stream, the walk parses nch subframes in turn (channel
// c + 1 starts where channel c ends): the subframe header and wasted bits,
// the warm-up samples, the LPC precision, shift and coefficients, the
// residual header, and then every residual code, whose value it decodes as
// it goes (Rice with u32-wrapping zig-zag, or sign-extended sf_bps-bit
// fields for verbatim lanes). Per lane (frame f, channel c at row
// f * nch + c) it writes the descriptors, the Rice parameter of each
// partition, the bit position of each 32-sample chunk and the decoded
// values; per frame the byte-aligned end bit and ok.
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
// channel c's end), so a frame is one chain of nch * T dependent steps;
// frames are independent. It is latency-bound: a few thousand frames give
// fewer warps than the card has schedulers.
//
// Design: one thread per frame, 32 frames per block so the few thousand
// frames of a batch spread over the SMs. The bit cursor and a three-word
// window stay in registers; the window slides forward a word at a time and
// its third word is loaded one word ahead of use, so the load overlaps the
// codes still decoded from the first two. A code costs a funnel shift, a
// clz and a few integer ops; the TPU's slab and one-hot machinery is not
// carried over. Values go out four at a time as 16-byte stores. Later
// work: split a frame's channels and chunks over a warp once the chunk
// bases are known.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPCap = 64;

struct Reader {
  const unsigned* s;
  int64_t W;
  int64_t wi;  // word index of w0
  unsigned w0, w1, w2;

  __device__ unsigned word(int64_t i) const {
    return (i >= 0 && i < W) ? s[i] : 0u;
  }
  // The 32 bits starting at bit pos (zero bits outside the stream).
  __device__ unsigned peek(int64_t pos) {
    const int64_t q = pos >> 5;
    if (q != wi) {
      if (q == wi + 1) {
        w0 = w1;
        w1 = w2;
      } else {
        w0 = word(q);
        w1 = word(q + 1);
      }
      w2 = word(q + 2);  // prefetch: first used after the next slide
      wi = q;
    }
    const int off = (int)(pos & 31);
    return off ? (w0 << off) | (w1 >> (32 - off)) : w0;
  }
};

__device__ __forceinline__ unsigned top_bits(unsigned hi, int n) {
  return n == 0 ? 0u : hi >> (32 - n);
}

__device__ __forceinline__ int sext(unsigned v, int n) {
  const unsigned sbit = 1u << (n > 1 ? n - 1 : 0);
  return (int)((v ^ sbit) - sbit);
}

struct LaneOut {
  int *order, *shift, *wasted, *n_parts, *ps, *pbits, *flags, *warm, *coefs,
      *ks, *bases, *sa_words, *values;
};

// Fixed-predictor coefficients of order o, oldest tap first: they occupy
// slots 32 - o .. 31 of the order-aligned LPC row (claxon
// src/subframe.rs:524-583).
__constant__ int kFixed[5][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {-1, 2, 0, 0}, {1, -3, 3, 0}, {-1, 4, -6, 4}};

// Walks one subframe of lane `lane` from bit pos; returns its end bit and
// clears *ok when the lane leaves the device path.
__device__ int64_t walk_subframe(Reader& rd, const LaneOut& o, int64_t lane,
                                 int64_t pos, int bs, int ch_bps, int T,
                                 int NC, bool* ok) {
  bool okc = true;
  unsigned hi = rd.peek(pos);
  okc &= (hi >> 31) == 0;
  const int ty = (int)((hi >> 25) & 63u);
  const bool wflag = ((hi >> 24) & 1u) != 0;
  int64_t rel = pos + 8;
  const bool is_const = ty == 0, is_verb = ty == 1;
  const bool is_fixed = (ty & 0x38) == 0x08, is_lpc = ty >= 32;
  const int f_ord = ty & 7;
  const int order = is_const ? 1
                    : is_fixed ? f_ord
                    : is_lpc   ? (ty & 31) + 1
                               : 0;
  okc &= is_const || is_verb || (is_fixed && f_ord <= 4) || is_lpc;

  // Wasted bits: a flag, then a unary count (64 when the window is zero).
  const unsigned whi = rd.peek(rel), wlo = rd.peek(rel + 32);
  const int z = whi ? __clz(whi) : 32 + __clz(wlo);
  const int wasted = wflag ? z + 1 : 0;
  rel += wasted;
  okc &= wasted < ch_bps;
  const int sf_bps = ch_bps - wasted;
  okc &= sf_bps <= 32;
  const int sf_r = sf_bps < 1 ? 1 : (sf_bps > 32 ? 32 : sf_bps);

  // Warm-up samples (a constant's value is its one warm-up sample).
  const int warm_order = is_verb ? 0 : (order < 32 ? order : 32);
  int* warm = o.warm + lane * 32;
  for (int i = 0; i < 32; ++i)
    warm[i] = i < warm_order ? sext(top_bits(rd.peek(rel + (int64_t)i * sf_r),
                                             sf_r), sf_r)
                             : 0;
  rel += (int64_t)warm_order * sf_r;

  // LPC precision, shift and coefficients (slot 31 - i holds coef i).
  hi = rd.peek(rel);
  const int prec = (int)((hi >> 28) & 15u) + 1;
  okc &= !is_lpc || prec != 16;
  const int shift5 = sext((hi >> 23) & 31u, 5);
  okc &= !is_lpc || shift5 >= 0;
  if (is_lpc) rel += 9;
  int* coefs = o.coefs + lane * 32;
  for (int i = 0; i < 32; ++i) {
    int cv = 0;
    if (is_lpc && i < order)
      cv = sext(top_bits(rd.peek(rel + (int64_t)i * prec), prec), prec);
    if (is_fixed) {
      const int fo = f_ord <= 4 ? f_ord : 4;
      cv = i < fo ? kFixed[fo][fo - 1 - i] : 0;
    }
    coefs[31 - i] = cv;
  }
  if (is_const) coefs[31] = 1;
  if (is_lpc) rel += (int64_t)order * prec;

  // Residual header (fixed and LPC lanes).
  const bool resd = is_fixed || is_lpc;
  hi = rd.peek(rel);
  const int meth = (int)(hi >> 30);
  okc &= !resd || meth <= 1;
  const int po = (int)((hi >> 26) & 15u);
  if (resd) rel += 6;
  const int pbits = resd ? 4 + meth : 0;
  const int n_parts = resd ? (1 << po) : 1;
  okc &= !resd || n_parts <= kPCap;
  const int ps = (resd && n_parts <= kPCap) ? (int)((unsigned)bs >> po) : bs;
  okc &= !resd || (bs & (n_parts - 1)) == 0;
  okc &= !resd || order < (ps > 1 ? ps : 1);

  o.order[lane] = is_verb ? 0 : order;
  o.shift[lane] = is_lpc ? shift5 : 0;
  o.wasted[lane] = wasted;
  o.n_parts[lane] = n_parts;
  o.ps[lane] = ps;
  o.pbits[lane] = pbits;
  o.flags[lane] = is_const ? 2 : (is_verb ? 1 : 0);

  // The residual walk: every code of the subframe, in order.
  const int ps_s = ps > 1 ? ps : 1;
  const bool resd_l = resd && okc, verb_l = is_verb && okc;
  const int order_l = is_verb ? 0 : order;
  // ks[p] is the Rice parameter in force at position t_p (t_0 = order,
  // t_p = p * ps), clipped to T - 1, for p below the partition count: the
  // parameter read at partition p's first code, or at T - 1 for
  // partitions that start past it.
  const int plim = n_parts < kPCap ? n_parts : kPCap;
  int* ks = o.ks + lane * kPCap;
  for (int p = 0; p < kPCap; ++p) ks[p] = 0;
  int* bases = o.bases + lane * NC;
  int4* vals = reinterpret_cast<int4*>(o.values + lane * (int64_t)NC * 32);
  int64_t cur = rel;
  int k = 0, nb = order_l, n_seen = 0;
  bool bad = false;
  for (int c = 0; c < NC; ++c) {
    bases[c] = (int)cur;
    for (int j4 = 0; j4 < 8; ++j4) {
      int v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = c * 32 + j4 * 4 + u;
        const bool act_r = resd_l && t >= order_l && t < bs;
        const bool act_v = verb_l && t < bs;
        int val = 0;
        if (act_r) {
          const bool first = t == nb;
          unsigned h = rd.peek(cur);
          int sh = 0;
          bool escape = false;
          if (first) {
            const int kr = (int)top_bits(h, pbits);
            escape = kr == (1 << pbits) - 1;
            k = kr;
            sh = pbits;
            nb = t == order_l ? ps_s : t + ps_s;
            if (t < T && n_seen < plim) ks[n_seen] = k;
            ++n_seen;
          }
          const unsigned h2 = h << sh;
          const int zz = __clz(h2);  // 32 for 0
          const int adv = sh + zz + 1 + k;
          bad |= escape || adv > 32;
          const int kc = k < 31 ? k : 31;
          int rsh = 32 - zz - 1 - k;
          rsh = rsh < 0 ? 0 : (rsh > 31 ? 31 : rsh);
          const unsigned r = (h2 >> rsh) & (k == 0 ? 0u : (1u << kc) - 1u);
          const unsigned vv = ((unsigned)zz << kc) | r;
          val = (int)((vv & 1u) ? ~(vv >> 1) : (vv >> 1));
          cur += adv < 32 ? adv : 32;
        } else if (act_v) {
          val = sext(top_bits(rd.peek(cur), sf_r), sf_r);
          cur += sf_r;
        }
        v[u] = val;
        if (t == T - 1)
          for (int p = n_seen; p < plim; ++p) ks[p] = k;
      }
      vals[c * 8 + j4] = make_int4(v[0], v[1], v[2], v[3]);
    }
  }
  okc &= !bad;
  if (is_verb) ks[0] = sf_bps;
  if (is_const)
    for (int p = 0; p < kPCap; ++p) ks[p] = 0;

  // Largest chunk span in bits -> per-lane gather width.
  const int end32 = (int)cur;
  const int ncl = (bs + 31) >> 5;
  int64_t span_max = 0;
  for (int c = 0; c < NC && c < ncl; ++c) {
    const int nxt = c + 1 < ncl ? bases[c + 1 < NC ? c + 1 : NC - 1] : end32;
    const int64_t span = (int64_t)nxt - bases[c];
    span_max = span > span_max ? span : span_max;
  }
  o.sa_words[lane] = is_const ? 0 : (int)((span_max >> 5) + 2);
  okc &= is_const || span_max <= 64 * 32;
  *ok = *ok && okc;
  return cur;
}

__global__ void walk_kernel(const unsigned* __restrict__ stream, int64_t W,
                            const int* __restrict__ start_bits,
                            const int* __restrict__ bs,
                            const int* __restrict__ modes,
                            const int* __restrict__ bps0, int64_t F, int T,
                            int nch, LaneOut o, int* __restrict__ end_bits,
                            unsigned char* __restrict__ ok_out) {
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int NC = (T + 31) / 32;
  const int b = bs[f], mode = modes[f];
  Reader rd{stream, W, INT64_MIN, 0u, 0u, 0u};
  int64_t pos = start_bits[f];
  bool ok = b >= 1 && b <= T;
  for (int ch = 0; ch < nch; ++ch) {
    // Stereo: the side channel carries one extra bit (left/side and
    // mid/side: channel 1; right/side: channel 0).
    const int side = nch == 2 && ((ch == 1 && (mode == 1 || mode == 3)) ||
                                  (ch == 0 && mode == 2))
                         ? 1
                         : 0;
    pos = walk_subframe(rd, o, f * nch + ch, pos, b, bps0[f] + side, T, NC,
                        &ok);
  }
  end_bits[f] = (int)((pos + 7) & ~(int64_t)7);
  ok_out[f] = ok ? 1 : 0;
}

}  // namespace

extern "C" int cxk_walk_frames(const int* stream, int64_t W,
                               const int* start_bits, const int* bs,
                               const int* modes, const int* bps0, int64_t F,
                               int64_t T, int64_t nch, int* order,
                               int* shift, int* wasted, int* n_parts, int* ps,
                               int* pbits, int* flags, int* warm, int* coefs,
                               int* ks, int* bases, int* sa_words,
                               int* values, int* end_bits,
                               unsigned char* ok, void* cuda_stream) {
  if (F > 0) {
    const LaneOut o{order, shift, wasted, n_parts, ps, pbits, flags,
                    warm,  coefs, ks,     bases,   sa_words, values};
    const int threads = 32;
    const int64_t blocks = (F + threads - 1) / threads;
    walk_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)cuda_stream>>>(
        (const unsigned*)stream, W, start_bits, bs, modes, bps0, F, (int)T,
        (int)nch, o, end_bits, ok);
  }
  return (int)cudaGetLastError();
}
