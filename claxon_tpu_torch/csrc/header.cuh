// The frame-header grammar on a candidate's 16-byte window, shared by K5's
// header check, K6's field decode and the fused demux front.
//
// A window holds the bytes at a sync hit's position p .. p + 15 (bytes past
// the upload repeat the bytes of its last word). The checks follow the
// reference reader (claxon src/frame.rs:131-316): the fixed fields, the
// UTF-8 frame or sample number, and the CRC-8 (polynomial 0x07) over the
// header bytes against the byte after them.

#pragma once

#include <stdint.h>

namespace {

constexpr int kWin = 16;
constexpr int kMaxHeader = 15;
// Per-candidate field row (ops/seg_parse.py FIELDS).
enum Field {
  kBlockSize, kHlen, kNchHdr, kMode, kVariable, kLo, kHi, kBps, kWalkable,
  kFields
};

// The window is indexed with compile-time constants only, so that it stays
// in registers: a byte at a runtime offset is picked by a select chain.
__device__ __forceinline__ unsigned win_at(const unsigned* w, int i) {
  unsigned r = w[0];
#pragma unroll
  for (int j = 1; j < kWin; ++j) r = i == j ? w[j] : r;
  return r;
}

// Bits per sample of a header's sample-size code (0: STREAMINFO's; -1:
// reserved).
__device__ __forceinline__ int bps_of_code(int code) {
  return code == 1 ? 8 : code == 2 ? 12 : code == 4 ? 16 : code == 5 ? 20
       : code == 6 ? 24 : code == 0 ? 0 : -1;
}

// The CRC-8 table, filled by every thread of the block; the caller
// synchronises before the first lookup.
__device__ __forceinline__ void fill_crc8_table(unsigned char* table) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    unsigned c = (unsigned)i;
    for (int b = 0; b < 8; ++b) c = (c & 0x80u) ? ((c << 1) ^ 0x07u) : (c << 1);
    table[i] = (unsigned char)(c & 0xFFu);
  }
}

__device__ __forceinline__ int leading_ones8(unsigned b) {
  return __clz(~(b << 24));  // b << 24 has zero low bits: the ~ stops at 8
}

// K5's check: the grammar and CRC-8 of the window of a hit at ``pos`` (-1
// for a row past the hits), and the header's CRC byte inside n_bytes.
__device__ __forceinline__ bool header_valid(const unsigned* w, int64_t pos,
                                             int64_t n_bytes,
                                             const unsigned char* table) {
  const unsigned bs_code = w[2] >> 4, sr_code = w[2] & 15u;
  const unsigned ca = w[3] >> 4, bps_code = (w[3] >> 1) & 7u;
  bool ok = bs_code != 0 && sr_code != 15 && ca <= 10 && bps_code != 3 &&
            bps_code != 7 && (w[3] & 1u) == 0;
  const int lead = leading_ones8(w[4]);
  const int utf8_len = lead == 0 ? 1 : lead;
  ok = ok && lead != 1 && lead != 8;
#pragma unroll
  for (int j = 1; j < 7; ++j)
    ok = ok && (j >= utf8_len || (w[4 + j] & 0xC0u) == 0x80u);
  const int bs_extra = (bs_code == 6 ? 1 : 0) + (bs_code == 7 ? 2 : 0);
  const int sr_extra =
      (sr_code == 12 ? 1 : 0) + (sr_code == 13 || sr_code == 14 ? 2 : 0);
  const int hlen = 4 + utf8_len + bs_extra + sr_extra;
  unsigned state = 0;
#pragma unroll
  for (int j = 0; j < kMaxHeader; ++j)
    if (j < hlen) state = table[state ^ w[j]];
  const unsigned stored = win_at(w, hlen < kWin - 1 ? hlen : kWin - 1);
  const int64_t p = pos < 0 ? 0 : pos;
  return ok && state == stored && pos >= 0 && p + hlen < n_bytes;
}

// K6's field row of a window at byte p (>= 0) whose K5 check gave
// ``valid``: block size, header length with the CRC byte, channel count
// and assignment, blocking flag, the UTF-8 number split into 32-bit lo and
// 4-bit hi, the stream's bits per sample (a binary search of the stream
// ends, side right, clamped to S - 1) and the walkable predicate.
__device__ __forceinline__ void header_fields(const unsigned* w, int p,
                                              bool valid,
                                              const int* __restrict__ ends,
                                              const int* __restrict__ si_bps,
                                              int S, int T, int nch, int* f) {
  const int variable = (int)(w[1] & 1u);
  const int bs_code = (int)(w[2] >> 4), sr_code = (int)(w[2] & 15u);
  const int ca = (int)(w[3] >> 4), bps_code = (int)((w[3] >> 1) & 7u);
  const int nch_hdr = ca < 8 ? ca + 1 : 2;
  const int mode = ca < 8 ? 0 : ca - 7;

  // UTF-8 frame/sample number: up to 36 bits, split lo (32) / hi.
  const int lead = leading_ones8(w[4]);
  const int ulen = lead == 0 ? 1 : lead;
  // The first byte's value bits: 7 for lead 0, none for lead 1 (invalid),
  // else 7 - lead.
  unsigned lo = w[4] & (lead == 1 ? 0u : 0x7Fu >> (lead < 7 ? lead : 7));
  unsigned hi = 0;
#pragma unroll
  for (int j = 1; j < 7; ++j) {
    if (j < ulen) {
      hi = (hi << 6) | ((lo >> 26) & 0x3Fu);
      lo = (lo << 6) | (w[4 + j] & 0x3Fu);
    }
  }

  const int bs_extra = (bs_code == 6 ? 1 : 0) + (bs_code == 7 ? 2 : 0);
  const int sr_extra =
      (sr_code == 12 ? 1 : 0) + (sr_code == 13 || sr_code == 14 ? 2 : 0);
  const int o = 4 + ulen;
  const int b8 = (int)win_at(w, o < 15 ? o : 15);
  const int b16 = (b8 << 8) | (int)win_at(w, o + 1 < 15 ? o + 1 : 15);
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
  const bool ok = valid && !(bs_code == 7 && b16 == 0xFFFF);
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
  const int bps = bps_code == 0 ? si_bps[si] : bps_of_code(bps_code);
  const bool walkable = ok && nch_hdr == nch && bps > 0 && block_size >= 1 &&
                        block_size <= T;

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

}  // namespace
