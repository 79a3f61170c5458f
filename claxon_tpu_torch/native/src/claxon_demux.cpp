// C++ host demux core: the native production path of claxon_tpu.
//
// Does for the TPU pipeline what the reference's input.rs/frame.rs/
// subframe.rs layers do natively in Rust (SURVEY.md section 2 parity
// requirement): walk the bit-serial FLAC stream once, verify CRC-8/CRC-16,
// and either
//   * EXTRACT per-(frame, channel) descriptors -- residual/warm-up samples
//     plus (order, shift, coefficients, wasted bits) -- for the batched
//     device kernels (claxon_tpu.ops), or
//   * DECODE fully on the host (prediction + wasted-bits + stereo
//     decorrelation), the reference-fidelity scalar path used as oracle and
//     as the low-latency single-stream fallback.
//
// Semantics (including every validation and its exact error message) mirror
// claxon `src/frame.rs:131-316`, `src/subframe.rs:29-380,651-721`; the two
// implementations are differentially tested against each other and against
// the STREAMINFO MD5 oracle.
//
// C ABI (ctypes, see ../binding.py): cxt_extract/cxt_decode parse a whole
// stream positioned at its first frame byte; counts are queried, the caller
// allocates numpy buffers, cxt_fill/cxt_pcm_fill copy out, cxt_free frees.

#include <cstdint>
#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

// Per-frame descriptor; the SAME definition is the internal storage and
// the C-ABI output record (matched by FRAME_DTYPE in binding.py), so the
// layouts can never drift apart.
struct CxtFrame {
  int64_t time;
  int32_t block_size, channels, mode, bps;
};

// Bits-path per-frame record (BFRAME_DTYPE in binding.py). flags bit 0
// marks a fallback frame whose subframes carry decoded samples (legacy
// layout) instead of deltas/slots. s_class is the frame-uniform slot size
// in words per 32-sample chunk (both channels share it so a stereo pair
// always lands in one device bucket).
// byte0/byte1: the frame's byte span within the walked section, byte1 one
// past the trailing stored CRC-16 -- the device CRC verifier's ranges.
// flags bit 0: sample-path fallback lane; bit 1: frame CRC-16 verification
// deferred to the device (walk ran with defer_crc).
struct CxtBFrame {
  int64_t time;
  int32_t block_size, channels, mode, bps;
  int32_t flags, s_class, byte0, byte1;
};

// Bits-path per-subframe record (BSUB_DTYPE in binding.py). For normal
// frames the residual stream is described by (a) one byte per sample
// ("deltas": the end-to-end bit distance from the previous code's end --
// unary + terminator + remainder, plus the Rice parameter preceding a
// partition's first code; 0 at warm-up positions) and (b) the raw
// residual-section bits, re-sliced into fixed-stride slots of
// (s_class + 1) words per 32-sample chunk, each chunk's bits starting
// word-aligned. That layout lets the TPU kernel reconstruct every residual
// with no gather and no scan (ops/entropy.py): the cumulative delta locates
// each code's end, q = delta - 1 - k (- pbits at a partition's first code),
// and the remainder is the k bits before the end.
struct CxtBSub {
  int32_t order, shift, wasted, n_parts;  // n_parts == 0: fallback lane
  int32_t ps, n_chunks, pbits, flags;     // flags: bit0 verbatim,
                                          //        bit1 no residual codes
  int32_t coefs[32];  // left-padded like SubDesc
  int32_t warm[32];   // warm-up sample values ([0, order))
};

namespace {

// ---------------------------------------------------------------------------
// Errors: code 1 = FormatError, 2 = Unsupported, 3 = IoError (EOF).
// Messages are static strings identical to the Python/claxon wording.

struct Err {
  int32_t code;
  const char* msg;
};

[[noreturn]] void fmt_err(const char* msg) { throw Err{1, msg}; }
[[noreturn]] void unsupported(const char* msg) { throw Err{2, msg}; }
[[noreturn]] void eof_err() { throw Err{3, "unexpected end of stream"}; }

// ---------------------------------------------------------------------------
// CRC tables (generated from the polynomials; claxon `src/crc.rs:59-69`).

struct CrcTables {
  uint8_t crc8[256];
  uint16_t crc16[8][256];  // crc16[j][b]: CRC of byte b then j zero bytes
  CrcTables() {
    for (int b = 0; b < 256; ++b) {
      uint32_t c8 = b;
      uint32_t c16 = b << 8;
      for (int i = 0; i < 8; ++i) {
        c8 = (c8 & 0x80) ? ((c8 << 1) ^ 0x07) : (c8 << 1);
        c16 = (c16 & 0x8000) ? ((c16 << 1) ^ 0x8005) : (c16 << 1);
      }
      crc8[b] = (uint8_t)c8;
      crc16[0][b] = (uint16_t)c16;
    }
    for (int j = 1; j < 8; ++j)
      for (int b = 0; b < 256; ++b) {
        uint16_t c = crc16[j - 1][b];  // advance one zero byte
        crc16[j][b] = crc16[0][c >> 8] ^ (uint16_t)(c << 8);
      }
  }
};
const CrcTables kCrc;

uint8_t crc8_range(const uint8_t* p, const uint8_t* end) {
  uint8_t crc = 0;
  for (; p < end; ++p) crc = kCrc.crc8[crc ^ *p];
  return crc;
}

// Slice-by-8 CRC-16 (same polynomial/semantics as the reference's
// byte-table loop, claxon `src/crc.rs:33-57`; just 8 bytes per step).
uint16_t crc16_range(const uint8_t* p, const uint8_t* end) {
  uint16_t crc = 0;
  while (end - p >= 8) {
    crc = kCrc.crc16[7][p[0] ^ (crc >> 8)] ^
          kCrc.crc16[6][p[1] ^ (crc & 0xFF)] ^
          kCrc.crc16[5][p[2]] ^ kCrc.crc16[4][p[3]] ^
          kCrc.crc16[3][p[4]] ^ kCrc.crc16[2][p[5]] ^
          kCrc.crc16[1][p[6]] ^ kCrc.crc16[0][p[7]];
    p += 8;
  }
  for (; p < end; ++p)
    crc = kCrc.crc16[0][(crc >> 8) ^ *p] ^ (uint16_t)(crc << 8);
  return crc;
}

// ---------------------------------------------------------------------------
// MSB-first bit reader over an in-memory byte range (the native counterpart
// of claxon `src/input.rs:414-643`). The accumulator keeps unconsumed bits
// left-aligned so the Rice quotient read is a count-leading-zeros.

struct Bits {
  const uint8_t* base;
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // top `n` bits are valid; bits below are zero
  int n = 0;

  explicit Bits(const uint8_t* data, size_t len)
      : base(data), p(data), end(data + len) {}

  inline void refill() {
    // Fast path: one unaligned 64-bit load + byte swap inserts every
    // whole byte that fits ((64-n) & ~7 bits) in a single operation.
    if (__builtin_expect(n <= 56 && end - p >= 8, 1)) {
      uint64_t w;
      std::memcpy(&w, p, 8);
      w = __builtin_bswap64(w);
      int t = (64 - n) & ~7;  // >= 8 since n <= 56
      acc |= (w & (~0ULL << (64 - t))) >> n;
      p += t >> 3;
      n += t;
      return;
    }
    while (n <= 56 && p < end) {
      acc |= (uint64_t)(*p++) << (56 - n);
      n += 8;
    }
  }

  inline bool at_eos() const { return n == 0 && p == end; }

  // Read k bits (0 <= k <= 32), MSB-first.
  inline uint32_t read(int k) {
    if (k == 0) return 0;
    if (n < k) {
      refill();
      if (n < k) eof_err();
    }
    uint32_t v = (uint32_t)(acc >> (64 - k));
    acc <<= k;
    n -= k;
    return v;
  }

  inline bool read_bit() { return read(1) != 0; }

  // Count zeros until the terminating 1 (Rice quotient; claxon
  // `src/input.rs:475-511` uses the same leading-zeros acceleration).
  inline uint32_t read_unary() {
    uint32_t q = 0;
    for (;;) {
      if (n == 0) {
        refill();
        if (n == 0) eof_err();
      }
      if (acc == 0) {  // all n buffered bits are zeros
        q += (uint32_t)n;
        n = 0;
        continue;
      }
      int z = __builtin_clzll(acc);  // acc != 0, and z < n by invariant
      q += (uint32_t)z;
      // z can be 63 right after a full-word refill (n == 64); a shift by
      // 64 is UB and would leave a stale bit in the accumulator.
      int c = z + 1;
      acc = (c == 64) ? 0 : acc << c;
      n -= c;
      return q;
    }
  }

  // Drop bits to the next byte boundary (bitstream drop in the reference,
  // `src/frame.rs:744-750`).
  inline void align() {
    int r = n & 7;
    acc <<= r;
    n -= r;
  }

  // Byte offset from `base` of the next unconsumed byte; valid only when
  // byte-aligned.
  inline size_t bytepos() const { return (size_t)(p - base) - (size_t)(n / 8); }

  // Absolute bit offset from `base` of the next unconsumed bit.
  inline uint64_t bitpos() const {
    return ((uint64_t)(p - base) << 3) - (uint64_t)n;
  }

  inline uint32_t read_u8() { return read(8); }
  inline uint32_t read_be_u16() { return read(16); }
};

inline int32_t extend_sign(uint32_t val, int bits) {
  int64_t v = val;
  if (v >= (int64_t)1 << (bits - 1)) v -= (int64_t)1 << bits;
  return (int32_t)v;
}

// ---------------------------------------------------------------------------
// Frame header (claxon `src/frame.rs:131-316`).

struct Header {
  int64_t time;  // resolved first inter-channel sample number
  int32_t block_size;
  int32_t channels;
  int32_t mode;  // 0 independent, 1 left/side, 2 right/side, 3 mid/side
  int32_t bps;   // -1 when the header omits it
};

// "UTF-8"-style variable-length int, up to 36 bits (`src/frame.rs:61-105`).
uint64_t read_var_length_int(Bits& b) {
  uint32_t first = b.read_u8();
  int read_additional = 0;
  uint32_t mask_data = 0x7F, mask_mark = 0x80;
  while (first & mask_mark) {
    ++read_additional;
    mask_data >>= 1;
    mask_mark >>= 1;
  }
  if (read_additional > 0) {
    if (read_additional == 1) fmt_err("invalid variable-length integer");
    --read_additional;
  }
  uint64_t result = (uint64_t)(first & mask_data) << (6 * read_additional);
  for (int i = read_additional - 1; i >= 0; --i) {
    uint32_t byte = b.read_u8();
    if ((byte & 0xC0) != 0x80) fmt_err("invalid variable-length integer");
    result |= (uint64_t)(byte & 0x3F) << (6 * i);
  }
  return result;
}

// Returns false at a clean EOF: the stream ending at the frame boundary
// OR one byte into the would-be sync word, matching the reference's
// read_be_u16_or_eof (`src/input.rs:93-100`).
bool read_frame_header(Bits& b, Header& h) {
  if ((size_t)b.n + 8 * (size_t)(b.end - b.p) < 16) return false;
  size_t hdr_start = b.bytepos();

  uint32_t sync_res_block = b.read_be_u16();
  if ((sync_res_block & 0xFFFC) != 0xFFF8) fmt_err("frame sync code missing");
  if (sync_res_block & 0x0002)
    fmt_err("invalid frame header, encountered reserved value");
  bool variable_blocking = (sync_res_block & 1) != 0;

  uint32_t bs_sr = b.read_u8();
  uint32_t bs_code = bs_sr >> 4;
  int32_t block_size = 0;
  bool read_8bit_bs = false, read_16bit_bs = false;
  if (bs_code == 0) {
    fmt_err("invalid frame header, encountered reserved value");
  } else if (bs_code == 1) {
    block_size = 192;
  } else if (bs_code <= 5) {
    block_size = 576 << (bs_code - 2);
  } else if (bs_code == 6) {
    read_8bit_bs = true;
  } else if (bs_code == 7) {
    read_16bit_bs = true;
  } else {
    block_size = 256 << (bs_code - 8);
  }

  static const int32_t kSampleRates[16] = {
      0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
      32000, 44100, 48000, 96000, -1, -1, -1, -1};
  uint32_t sr_code = bs_sr & 0x0F;
  bool read_8bit_sr = false, read_16bit_sr = false, read_16bit_sr_ten = false;
  if (sr_code == 0x0C) read_8bit_sr = true;
  else if (sr_code == 0x0D) read_16bit_sr = true;
  else if (sr_code == 0x0E) read_16bit_sr_ten = true;
  else if (sr_code == 0x0F) fmt_err("invalid frame header");

  uint32_t chan_bps_res = b.read_u8();
  uint32_t ca = chan_bps_res >> 4;
  if (ca < 8) {
    h.channels = (int32_t)ca + 1;
    h.mode = 0;
  } else if (ca == 0x8) {
    h.channels = 2;
    h.mode = 1;  // left/side
  } else if (ca == 0x9) {
    h.channels = 2;
    h.mode = 2;  // right/side
  } else if (ca == 0xA) {
    h.channels = 2;
    h.mode = 3;  // mid/side
  } else {
    fmt_err("invalid frame header, encountered reserved value");
  }

  static const int32_t kBps[8] = {-1, 8, 12, -2, 16, 20, 24, -2};
  uint32_t bps_code = (chan_bps_res & 0x0E) >> 1;
  int32_t bps = kBps[bps_code];
  if (bps == -2) fmt_err("invalid frame header, encountered reserved value");
  if (chan_bps_res & 1)
    fmt_err("invalid frame header, encountered reserved value");

  uint64_t time_value;
  bool time_is_frame_number;
  if (variable_blocking) {
    time_value = read_var_length_int(b);  // sample number, <= 36 bits
    time_is_frame_number = false;
  } else {
    time_value = read_var_length_int(b);  // frame number, <= 31 bits
    if (time_value > 0x7FFFFFFF)
      fmt_err("invalid frame header, frame number too large");
    time_is_frame_number = true;
  }

  if (read_8bit_bs) block_size = (int32_t)b.read_u8() + 1;
  if (read_16bit_bs) {
    uint32_t bs = b.read_be_u16();
    // 0xffff would exceed the 16-bit max block size in the streaminfo.
    if (bs == 0xFFFF) fmt_err("invalid block size, exceeds 65535");
    block_size = (int32_t)bs + 1;
  }
  if (read_8bit_sr) (void)b.read_u8();
  if (read_16bit_sr) (void)b.read_be_u16();
  if (read_16bit_sr_ten) (void)b.read_be_u16();
  (void)kSampleRates;

  uint8_t computed = crc8_range(b.base + hdr_start, b.base + b.bytepos());
  uint32_t presumed = b.read_u8();
  if (computed != presumed) fmt_err("frame header CRC mismatch");

  h.block_size = block_size;
  h.bps = bps;
  // Reference quirk (`src/frame.rs:771-773`): with fixed-size blocking the
  // time is current_block_size * frame_number.
  h.time = time_is_frame_number ? (int64_t)block_size * (int64_t)time_value
                                : (int64_t)time_value;
  return true;
}

// ---------------------------------------------------------------------------
// Subframes (claxon `src/subframe.rs`).

struct SubDesc {
  int32_t order, shift, wasted, pad_;
  int32_t coefs[32];  // left-padded: coefs[31] multiplies out[t-1]
};

void decode_rice_partition(Bits& b, int32_t* buf, int64_t start, int64_t len,
                           bool rice2) {
  int param_bits = rice2 ? 5 : 4;
  uint32_t rice_param = b.read(param_bits);
  if (rice_param == (uint32_t)((1 << param_bits) - 1))
    unsupported("unencoded binary is not yet implemented");
  int k = (int)rice_param;
  for (int64_t i = start; i < start + len; ++i) {
    // Fast path: refill only under 17 buffered bits -- one load+bswap
    // amortizes over several codes (typical code ~6-12 bits), and the
    // in-window guard below catches the rare longer one. Measured ~1.4x
    // over refilling every code.
    if (b.n <= 16) b.refill();
    if (__builtin_expect(b.acc != 0, 1)) {
      int z = __builtin_clzll(b.acc);
      // z+1+k < 64 also keeps every shift below 64 (no UB).
      if (__builtin_expect(z + 1 + k <= b.n && z + 1 + k < 64, 1)) {
        uint32_t r = k ? (uint32_t)((b.acc << (z + 1)) >> (64 - k)) : 0;
        b.acc <<= z + 1 + k;
        b.n -= z + 1 + k;
        uint32_t v = (((uint32_t)z) << k) | r;
        buf[i] = (v & 1) ? (int32_t)~(v >> 1) : (int32_t)(v >> 1);
        continue;
      }
    }
    // Slow path: long quotient run or end-of-buffer straddle.
    uint32_t q = b.read_unary();
    uint32_t r = b.read(k);
    // u32 wrap like the reference (`src/subframe.rs:340`).
    uint32_t v = (q << rice_param) | r;
    buf[i] = (v & 1) ? (int32_t)~(v >> 1) : (int32_t)(v >> 1);
  }
}

void decode_residual(Bits& b, int64_t block_size, int32_t* buf, int64_t start,
                     int64_t len) {
  uint32_t method = b.read(2);
  bool rice2;
  if (method == 0) rice2 = false;
  else if (method == 1) rice2 = true;
  else fmt_err("invalid residual, encountered reserved value");

  uint32_t order = b.read(4);
  int64_t n_partitions = (int64_t)1 << order;
  int64_t per_partition = block_size >> order;
  if (block_size & (n_partitions - 1)) fmt_err("invalid partition order");
  int64_t n_warm_up = block_size - len;
  if (n_warm_up > per_partition) fmt_err("invalid residual");

  int64_t pos = start;
  int64_t length = per_partition - n_warm_up;
  for (int64_t p = 0; p < n_partitions; ++p) {
    decode_rice_partition(b, buf, pos, length, rice2);
    pos += length;
    length = per_partition;
  }
}

void decode_verbatim(Bits& b, int bps, int32_t* buf, int64_t start,
                     int64_t len) {
  for (int64_t i = start; i < start + len; ++i)
    buf[i] = extend_sign(b.read(bps), bps);
}

// Pascal's-triangle coefficients (`src/subframe.rs:427-431`), oldest first.
const int32_t kFixedCoefs[5][4] = {
    {}, {1}, {-1, 2}, {1, -3, 3}, {-1, 4, -6, 4}};

// Parse one subframe: fills buf[0..block_size) with warm-up ++ residuals
// (no prediction applied) and the descriptor. Mirrors claxon
// `src/subframe.rs:29-91,184-228,651-721` and claxon_tpu.extract.
void parse_subframe(Bits& b, int bps, int64_t block_size, int32_t* buf,
                    SubDesc& d) {
  // Header: one padding bit, 6-bit type, optional unary wasted-bits count.
  if (b.read_bit()) fmt_err("invalid subframe header");
  uint32_t n = b.read(6);
  enum { CONSTANT, VERBATIM, FIXED, LPC } type;
  int order = 0;
  if (n == 0) {
    type = CONSTANT;
  } else if (n == 1) {
    type = VERBATIM;
  } else if ((n & 0x3E) == 0x02 || (n & 0x3C) == 0x04 || (n & 0x30) == 0x10) {
    fmt_err("invalid subframe header, encountered reserved value");
    __builtin_unreachable();
  } else if ((n & 0x38) == 0x08) {
    order = (int)(n & 0x07);
    if (order > 4)
      fmt_err("invalid subframe header, encountered reserved value");
    type = FIXED;
  } else {
    type = LPC;
    order = (int)(n & 0x1F) + 1;
  }

  // Keep the unary count unsigned so a pathological multi-billion-zero
  // run cannot wrap negative and bypass the bound checks (the reference
  // stays in u32 for the same reason).
  uint32_t wasted_u = 0;
  if (b.read_bit()) wasted_u = 1 + b.read_unary();
  if (wasted_u > 31) fmt_err("wasted bits per sample must not exceed 31");
  int wasted = (int)wasted_u;
  if (wasted >= bps) fmt_err("subframe has no non-wasted bits");
  int sf_bps = bps - wasted;

  std::memset(d.coefs, 0, sizeof(d.coefs));
  d.wasted = wasted;
  d.shift = 0;
  d.order = 0;
  d.pad_ = 0;

  switch (type) {
    case CONSTANT: {
      int32_t v = extend_sign(b.read(sf_bps), sf_bps);
      for (int64_t i = 0; i < block_size; ++i) buf[i] = v;
      return;
    }
    case VERBATIM:
      decode_verbatim(b, sf_bps, buf, 0, block_size);
      return;
    case FIXED: {
      if (block_size < order)
        fmt_err("invalid fixed subframe, order is larger than block size");
      decode_verbatim(b, sf_bps, buf, 0, order);
      decode_residual(b, block_size, buf, order, block_size - order);
      d.order = order;
      for (int k = 0; k < order; ++k) d.coefs[32 - order + k] = kFixedCoefs[order][k];
      return;
    }
    case LPC: {
      if (block_size < order)
        fmt_err("invalid LPC subframe, lpc order is larger than block size");
      decode_verbatim(b, sf_bps, buf, 0, order);
      int qlp_precision = (int)b.read(4) + 1;
      if (qlp_precision - 1 == 0x0F)
        fmt_err("invalid subframe, qlp precision value invalid");
      int32_t qlp_shift = extend_sign(b.read(5), 5);
      if (qlp_shift < 0)
        unsupported(
            "a negative quantized linear predictor coefficient shift is "
            "not supported, please file a bug.");
      // Most recent sample's coefficient first in the stream; store
      // oldest-first, right-aligned at column 31.
      for (int k = order - 1; k >= 0; --k)
        d.coefs[32 - order + k] = extend_sign(b.read(qlp_precision), qlp_precision);
      decode_residual(b, block_size, buf, order, block_size - order);
      d.order = order;
      d.shift = qlp_shift;
      return;
    }
  }
}

// ---------------------------------------------------------------------------
// Bits-path walker: boundary-only residual scan (SURVEY.md section 7
// "throughput work": drop the host's per-sample value materialization).
// The host walks the Rice codes exactly like the sample path -- it must, to
// segment the stream -- but instead of decoding, it emits (a) one
// code-length byte per sample and (b) the raw remainders re-packed into
// fixed-stride chunk slots; the TPU reconstructs every residual from those
// in parallel (claxon `src/subframe.rs:309-351` semantics live in
// ops/entropy.py on the device side).

constexpr int64_t kPCap = 64;  // partitions beyond this: sample path
constexpr int kSClasses[9] = {4, 6, 8, 12, 16, 24, 32, 48, 64};  // slot words/chunk

// Copy nbits starting at absolute bit src_bit of the byte stream into
// word-aligned dst, MSB-first (the device kernel's bit order: slot bit i
// lives in word[i >> 5] at bit 31 - (i & 31)). Reads clamp at src_len.
void copy_bits_from_bytes(const uint8_t* src, size_t src_len,
                          uint64_t src_bit, uint32_t* dst, uint64_t nbits) {
  for (uint64_t done = 0; done < nbits; done += 32, src_bit += 32) {
    size_t byte = (size_t)(src_bit >> 3);
    uint64_t w = 0;
    if (__builtin_expect(byte + 8 <= src_len, 1)) {
      std::memcpy(&w, src + byte, 8);
      w = __builtin_bswap64(w);
    } else {
      for (size_t i = 0; i < 8 && byte + i < src_len; ++i)
        w |= (uint64_t)src[byte + i] << (56 - 8 * i);
    }
    uint32_t v = (uint32_t)((w << (src_bit & 7)) >> 32);
    uint64_t rem = nbits - done;
    if (rem < 32) v &= ~0u << (32 - rem);
    *dst++ = v;
  }
}

// Growable word buffer whose growth does NOT zero-initialize (the slot
// buffer is large and mostly overwritten; padding words beyond each
// chunk's copied span are never read into any decoded output -- the
// kernel masks to the k bits inside the span -- so zeroing them would be
// a pure memset tax).
struct RawWords {
  uint32_t* data = nullptr;
  size_t size = 0, cap = 0;
  ~RawWords() { std::free(data); }
  RawWords() = default;
  RawWords(const RawWords&) = delete;
  RawWords& operator=(const RawWords&) = delete;

  inline uint32_t* extend(size_t n) {
    if (size + n > cap) {
      cap = std::max(cap * 2, size + n + 65536);
      void* p = std::realloc(data, cap * sizeof(uint32_t));
      if (!p) throw std::bad_alloc();
      data = (uint32_t*)p;
    }
    uint32_t* out = data + size;
    size += n;
    return out;
  }
};

// Per-subframe scratch: the absolute source bit position where each
// 32-sample chunk's bits begin (chunk c covers the codes at block
// positions [32c, 32c + 32), including any Rice parameters read between
// them). Reused across frames; reset() keeps the vector's capacity.
struct SubScratch {
  std::vector<uint64_t> bases;
  int64_t cur_chunk = -1;

  inline void reset() {
    bases.clear();
    cur_chunk = -1;
  }
  inline void ensure_chunk(int64_t c, uint64_t pos) {
    while (cur_chunk < c) {
      bases.push_back(pos);
      ++cur_chunk;
    }
  }
  // Close the layout: bases[n_chunks] = end position, so chunk c spans
  // bases[c+1] - bases[c] bits.
  void finish(int64_t n_chunks, uint64_t end_pos) {
    ensure_chunk(n_chunks, end_pos);
  }
};

// Scan one subframe's partitioned residual: validate exactly like
// decode_residual (same order, same messages), emit the per-sample bit
// gaps, record chunk base positions. Returns false when the frame must
// take the sample path (too many partitions, a gap wider than the delta
// byte, or an empty first partition -- whose Rice parameter no code's
// delta could account for).
bool scan_residual_bits(Bits& b, int64_t block_size, int order, CxtBSub& d,
                        SubScratch& sc, std::vector<int32_t>& ks,
                        uint8_t* deltas) {
  uint32_t method = b.read(2);
  bool rice2;
  if (method == 0) rice2 = false;
  else if (method == 1) rice2 = true;
  else fmt_err("invalid residual, encountered reserved value");

  uint32_t po = b.read(4);
  int64_t n_partitions = (int64_t)1 << po;
  int64_t per_partition = block_size >> po;
  if (block_size & (n_partitions - 1)) fmt_err("invalid partition order");
  if (order > per_partition) fmt_err("invalid residual");
  if (n_partitions > kPCap) return false;
  if (order == per_partition) return false;  // empty first partition

  d.n_parts = (int32_t)n_partitions;
  d.ps = (int32_t)per_partition;
  int param_bits = rice2 ? 5 : 4;
  d.pbits = param_bits;
  int64_t t = order;
  int64_t len = per_partition - order;
  for (int64_t p = 0; p < n_partitions; ++p) {
    // The chunk of this partition's first code must open before the Rice
    // parameter: the code's delta spans the parameter bits too.
    sc.ensure_chunk(t >> 5, b.bitpos());
    uint32_t rice_param = b.read(param_bits);
    if (rice_param == (uint32_t)((1 << param_bits) - 1))
      unsupported("unencoded binary is not yet implemented");
    int k = (int)rice_param;
    ks.push_back(k);
    // First code of the partition: delta includes the parameter bits.
    // The cap keeps every code (with its parameter) inside the device
    // kernel's 64-bit parse window; longer codes take the sample path.
    uint32_t max_q = 63u - (uint32_t)(k + param_bits);
    int extra = param_bits;
    for (int64_t i = 0; i < len; ++i, ++t) {
      // Chunks advance only at 32-sample boundaries (the partition's
      // first code was ensured above), so the position computation is
      // off the per-code hot path.
      if (__builtin_expect((t & 31) == 0, 0))
        sc.ensure_chunk(t >> 5, b.bitpos());
      uint32_t q;
      // Same lazy-refill fast path as decode_rice_partition (one
      // load+bswap per several codes; the in-window guard catches the
      // rare code longer than the buffered bits).
      if (b.n <= 16) b.refill();
      if (__builtin_expect(b.acc != 0, 1)) {
        int z = __builtin_clzll(b.acc);
        if (__builtin_expect(z + 1 + k <= b.n && z + 1 + k < 64, 1)) {
          b.acc <<= z + 1 + k;
          b.n -= z + 1 + k;
          q = (uint32_t)z;
        } else {
          q = b.read_unary();
          (void)b.read(k);
        }
      } else {
        q = b.read_unary();
        (void)b.read(k);
      }
      if (__builtin_expect(q > max_q, 0)) return false;
      deltas[t] = (uint8_t)(q + 1 + (uint32_t)(k + extra));
      if (extra) {
        max_q += param_bits;
        extra = 0;
      }
    }
    len = per_partition;
  }
  return true;
}

// Bits-path subframe parse: header/warm-up/coefficients like
// parse_subframe (identical validation + messages), residuals via
// scan_residual_bits. CONSTANT becomes an order-1 predictor with
// coefficient 1 and the value as warm-up (bit-exact: out[t] = out[t-1]).
// VERBATIM lanes ride the same delta/slot encoding with delta = k = the
// subframe's bit depth and a flag telling the kernel to sign-extend the
// k-bit field instead of zig-zag decoding a Rice code.
// Returns false -> caller reruns the whole frame through the sample path.
bool parse_subframe_bits(Bits& b, int bps, int64_t block_size, CxtBSub& d,
                         SubScratch& sc, std::vector<int32_t>& ks,
                         uint8_t* deltas) {
  if (b.read_bit()) fmt_err("invalid subframe header");
  uint32_t n = b.read(6);
  enum { CONSTANT, VERBATIM, FIXED, LPC } type;
  int order = 0;
  if (n == 0) {
    type = CONSTANT;
  } else if (n == 1) {
    type = VERBATIM;
  } else if ((n & 0x3E) == 0x02 || (n & 0x3C) == 0x04 || (n & 0x30) == 0x10) {
    fmt_err("invalid subframe header, encountered reserved value");
    __builtin_unreachable();
  } else if ((n & 0x38) == 0x08) {
    order = (int)(n & 0x07);
    if (order > 4)
      fmt_err("invalid subframe header, encountered reserved value");
    type = FIXED;
  } else {
    type = LPC;
    order = (int)(n & 0x1F) + 1;
  }

  uint32_t wasted_u = 0;
  if (b.read_bit()) wasted_u = 1 + b.read_unary();
  if (wasted_u > 31) fmt_err("wasted bits per sample must not exceed 31");
  int wasted = (int)wasted_u;
  if (wasted >= bps) fmt_err("subframe has no non-wasted bits");
  int sf_bps = bps - wasted;

  std::memset(d.coefs, 0, sizeof(d.coefs));
  std::memset(d.warm, 0, sizeof(d.warm));
  d.wasted = wasted;
  d.shift = 0;
  d.order = 0;
  d.n_parts = 0;
  d.ps = 0;
  d.n_chunks = (int32_t)((block_size + 31) / 32);
  d.pbits = 0;
  d.flags = 0;

  switch (type) {
    case CONSTANT: {
      int32_t v = extend_sign(b.read(sf_bps), sf_bps);
      d.order = 1;
      d.warm[0] = v;
      d.coefs[31] = 1;
      d.n_parts = 1;
      d.ps = (int32_t)block_size;
      d.flags = 2;  // no residual codes: the scan kernel must not parse
      ks.push_back(0);
      sc.finish(d.n_chunks, b.bitpos());
      return true;
    }
    case VERBATIM: {
      d.flags = 1;
      d.n_parts = 1;
      d.ps = (int32_t)block_size;
      ks.push_back(sf_bps);
      for (int64_t t = 0; t < block_size; ++t) {
        if ((t & 31) == 0) sc.ensure_chunk(t >> 5, b.bitpos());
        (void)b.read(sf_bps);
        deltas[t] = (uint8_t)sf_bps;
      }
      sc.finish(d.n_chunks, b.bitpos());
      return true;
    }
    case FIXED: {
      if (block_size < order)
        fmt_err("invalid fixed subframe, order is larger than block size");
      for (int i = 0; i < order; ++i)
        d.warm[i] = extend_sign(b.read(sf_bps), sf_bps);
      d.order = order;
      for (int k = 0; k < order; ++k)
        d.coefs[32 - order + k] = kFixedCoefs[order][k];
      if (!scan_residual_bits(b, block_size, order, d, sc, ks, deltas))
        return false;
      sc.finish(d.n_chunks, b.bitpos());
      return true;
    }
    case LPC: {
      if (block_size < order)
        fmt_err("invalid LPC subframe, lpc order is larger than block size");
      for (int i = 0; i < order; ++i)
        d.warm[i] = extend_sign(b.read(sf_bps), sf_bps);
      int qlp_precision = (int)b.read(4) + 1;
      if (qlp_precision - 1 == 0x0F)
        fmt_err("invalid subframe, qlp precision value invalid");
      int32_t qlp_shift = extend_sign(b.read(5), 5);
      if (qlp_shift < 0)
        unsupported(
            "a negative quantized linear predictor coefficient shift is "
            "not supported, please file a bug.");
      for (int k = order - 1; k >= 0; --k)
        d.coefs[32 - order + k] =
            extend_sign(b.read(qlp_precision), qlp_precision);
      d.order = order;
      d.shift = qlp_shift;
      if (!scan_residual_bits(b, block_size, order, d, sc, ks, deltas))
        return false;
      sc.finish(d.n_chunks, b.bitpos());
      return true;
    }
  }
  return false;  // unreachable
}

// ---------------------------------------------------------------------------
// Host prediction + epilogue (decode mode; the reference's hot loops,
// `src/subframe.rs:417-474,524-614`, `src/frame.rs:318-399`).

// Fixed-order instantiations let the compiler fully unroll and vectorize
// the inner product (the reference specializes low orders the same way,
// zero-padding to a fixed width 12, `src/subframe.rs:524-583`).
template <int ORDER>
void predict_order(const int32_t* c, int32_t shift, int32_t* buf,
                   int64_t block_size) {
  for (int64_t i = ORDER; i < block_size; ++i) {
    int64_t acc = 0;
    for (int k = 0; k < ORDER; ++k)
      acc += (int64_t)c[k] * (int64_t)buf[i - ORDER + k];
    int64_t pred = acc >> shift;
    buf[i] = (int32_t)(uint32_t)((uint64_t)pred + (uint32_t)buf[i]);
  }
}

void predict_in_place(const SubDesc& d, int32_t* buf, int64_t block_size) {
  int order = d.order;
  if (order == 0) return;
  const int32_t* c = d.coefs + 32 - order;
  switch (order) {
    case 1: return predict_order<1>(c, d.shift, buf, block_size);
    case 2: return predict_order<2>(c, d.shift, buf, block_size);
    case 3: return predict_order<3>(c, d.shift, buf, block_size);
    case 4: return predict_order<4>(c, d.shift, buf, block_size);
    case 5: return predict_order<5>(c, d.shift, buf, block_size);
    case 6: return predict_order<6>(c, d.shift, buf, block_size);
    case 7: return predict_order<7>(c, d.shift, buf, block_size);
    case 8: return predict_order<8>(c, d.shift, buf, block_size);
    case 9: return predict_order<9>(c, d.shift, buf, block_size);
    case 10: return predict_order<10>(c, d.shift, buf, block_size);
    case 11: return predict_order<11>(c, d.shift, buf, block_size);
    case 12: return predict_order<12>(c, d.shift, buf, block_size);
    default: break;
  }
  for (int64_t i = order; i < block_size; ++i) {
    int64_t acc = 0;
    for (int k = 0; k < order; ++k)
      acc += (int64_t)c[k] * (int64_t)buf[i - order + k];
    int64_t pred = acc >> d.shift;
    buf[i] = (int32_t)(uint32_t)((uint64_t)pred + (uint32_t)buf[i]);
  }
}

void apply_wasted(int wasted, int32_t* buf, int64_t n) {
  if (!wasted) return;
  for (int64_t i = 0; i < n; ++i)
    buf[i] = (int32_t)((uint32_t)buf[i] << wasted);
}

// ---------------------------------------------------------------------------
// Whole-stream walkers.

struct Handle {
  std::vector<CxtFrame> frames;
  std::vector<SubDesc> subs;
  std::vector<int32_t> samples;  // extract: lane-concatenated x buffers
  std::vector<int32_t> pcm;      // decode: interleaved samples
  // Bits-path outputs (cxt_extract_bits).
  std::vector<CxtBFrame> bframes;
  std::vector<CxtBSub> bsubs;
  std::vector<uint8_t> deltas;   // one code-length byte per sample
  RawWords slots;                // residual-section bits, chunk-slotted
  std::vector<int32_t> ks;       // per-partition Rice parameters
  std::vector<int32_t> bases;    // absolute bit position of each chunk's
                                 // first code (n_chunks per bits lane) --
                                 // the device gathers chunk words straight
                                 // from the uploaded stream with these
};

// Per-channel subframe bps: the side channel carries one extra bit
// (`src/frame.rs:705-742`).
inline int channel_bps(int mode, int ch, int bps) {
  switch (mode) {
    case 1: return ch == 1 ? bps + 1 : bps;  // left/side
    case 2: return ch == 0 ? bps + 1 : bps;  // right/side
    case 3: return ch == 1 ? bps + 1 : bps;  // mid/side
    default: return bps;
  }
}

void walk_stream(const uint8_t* data, size_t len, bool full_decode,
                 Handle& h, int64_t max_frames = -1,
                 size_t* consumed = nullptr) {
  Bits b(data, len);
  std::vector<int32_t> scratch;
  // Typical FLAC compresses 16-bit audio to ~0.5x, i.e. about one sample
  // per input byte; reserving 2x that (capped) avoids the growth
  // reallocations' large memcpys on the extraction hot path.
  if (!full_decode && max_frames < 0)
    h.samples.reserve(std::min<size_t>(len * 2, (size_t)1 << 27));
  if (full_decode && max_frames < 0)
    h.pcm.reserve(std::min<size_t>(len * 2, (size_t)1 << 27));
  while (max_frames < 0 || (int64_t)h.frames.size() < max_frames) {
    size_t frame_start = b.bytepos();
    Header hdr;
    if (!read_frame_header(b, hdr)) break;
    if (hdr.bps < 0) unsupported("header without bits per sample info");

    int64_t bs = hdr.block_size;
    int nch = hdr.channels;

    int32_t* bufs;
    size_t sub0 = h.subs.size();
    if (full_decode) {
      scratch.resize((size_t)bs * nch);
      bufs = scratch.data();
    } else {
      size_t off = h.samples.size();
      h.samples.resize(off + (size_t)bs * nch);
      bufs = h.samples.data() + off;
    }

    for (int ch = 0; ch < nch; ++ch) {
      SubDesc d;
      parse_subframe(b, channel_bps(hdr.mode, ch, hdr.bps), bs,
                     bufs + (size_t)ch * bs, d);
      h.subs.push_back(d);
    }

    b.align();
    uint16_t computed = crc16_range(b.base + frame_start, b.base + b.bytepos());
    uint32_t presumed = b.read_be_u16();
    if (computed != presumed) fmt_err("frame CRC mismatch");

    h.frames.push_back(
        CxtFrame{hdr.time, hdr.block_size, hdr.channels, hdr.mode, hdr.bps});

    if (full_decode) {
      for (int ch = 0; ch < nch; ++ch) {
        const SubDesc& d = h.subs[sub0 + ch];
        int32_t* buf = bufs + (size_t)ch * bs;
        predict_in_place(d, buf, bs);
        apply_wasted(d.wasted, buf, bs);
      }
      if (hdr.mode != 0) {
        int32_t* c0 = bufs;
        int32_t* c1 = bufs + bs;
        if (hdr.mode == 1) {          // left/side: right = left - side
          for (int64_t i = 0; i < bs; ++i)
            c1[i] = (int32_t)((uint32_t)c0[i] - (uint32_t)c1[i]);
        } else if (hdr.mode == 2) {   // right/side: left = side + right
          for (int64_t i = 0; i < bs; ++i)
            c0[i] = (int32_t)((uint32_t)c0[i] + (uint32_t)c1[i]);
        } else {                      // mid/side
          for (int64_t i = 0; i < bs; ++i) {
            int32_t mid2 =
                (int32_t)((uint32_t)c0[i] << 1) | (c1[i] & 1);
            int32_t side = c1[i];
            // mid2 +- side is always even; >> is the truncating div by 2.
            c0[i] = (int32_t)((uint32_t)mid2 + (uint32_t)side) >> 1;
            c1[i] = (int32_t)((uint32_t)mid2 - (uint32_t)side) >> 1;
          }
        }
      }
      size_t off = h.pcm.size();
      h.pcm.resize(off + (size_t)bs * nch);
      int32_t* out = h.pcm.data() + off;
      for (int ch = 0; ch < nch; ++ch) {
        const int32_t* buf = bufs + (size_t)ch * bs;
        for (int64_t i = 0; i < bs; ++i) out[i * nch + ch] = buf[i];
      }
      h.subs.resize(sub0);  // decode mode keeps only frames + pcm
    }
    if (consumed) *consumed = b.bytepos();
  }
}

// Bits-mode whole-stream walker. Every frame first tries the bits path;
// a frame the device kernel cannot represent (verbatim subframe, > kPCap
// partitions, a code longer than 255 bits) is rewound and re-parsed
// through the sample path, marked flags bit 0 -- the pipeline routes those
// lanes through the legacy sample-shipping program. Header validation,
// CRC-8/CRC-16 verification and every error message are identical to
// walk_stream.
void walk_stream_bits(const uint8_t* data, size_t len, Handle& h,
                      bool emit_slots, bool defer_crc = false,
                      int64_t max_frames = -1,
                      size_t* consumed = nullptr) {
  Bits b(data, len);
  std::vector<SubScratch> scratch;
  std::vector<int32_t> scratch_x;
  h.deltas.reserve(std::min<size_t>(len, (size_t)1 << 26));
  // Slot words ~ samples * (s_class+1)/32 ~ 0.6 * stream bytes; one
  // up-front extend avoids realloc copies on the hot path.
  h.slots.extend(std::min<size_t>(len, (size_t)1 << 25));
  h.slots.size = 0;
  while (max_frames < 0 || (int64_t)h.bframes.size() < max_frames) {
    size_t frame_start = b.bytepos();
    Bits saved = b;
    Header hdr;
    if (!read_frame_header(b, hdr)) break;
    if (hdr.bps < 0) unsupported("header without bits per sample info");

    int64_t bs = hdr.block_size;
    int nch = hdr.channels;
    int64_t n_chunks = (bs + 31) / 32;

    size_t ks0 = h.ks.size();
    size_t deltas0 = h.deltas.size();
    size_t bsubs0 = h.bsubs.size();
    size_t bases0 = h.bases.size();
    h.deltas.resize(deltas0 + (size_t)bs * nch, 0);
    if ((int)scratch.size() < nch) scratch.resize(nch);
    for (int ch = 0; ch < nch; ++ch) scratch[ch].reset();

    bool ok = true;
    for (int ch = 0; ch < nch; ++ch) {
      CxtBSub d;
      ok = parse_subframe_bits(b, channel_bps(hdr.mode, ch, hdr.bps), bs, d,
                               scratch[ch], h.ks,
                               h.deltas.data() + deltas0 + (size_t)ch * bs);
      if (!ok) break;
      h.bsubs.push_back(d);
    }

    int32_t flags = 0, s_class = 0;
    if (ok) {
      b.align();
      if (defer_crc) {
        b.read_be_u16();  // stored CRC: consumed here, verified on device
        flags |= 2;
      } else {
        uint16_t computed =
            crc16_range(b.base + frame_start, b.base + b.bytepos());
        uint32_t presumed = b.read_be_u16();
        if (computed != presumed) fmt_err("frame CRC mismatch");
      }

      // Frame-uniform slot class: both channels of a stereo pair must
      // share a stride so they land in one device bucket, pair-aligned.
      // Chunk spans include the Rice parameters read between codes; the
      // deltas account for them, so the kernel's cumulative offsets match.
      int s = 1;
      for (int ch = 0; ch < nch; ++ch) {
        const auto& bases = scratch[ch].bases;
        for (int64_t c = 0; c < n_chunks; ++c)
          s = std::max(s, (int)((bases[c + 1] - bases[c] + 31) / 32));
      }
      s_class = 0;
      for (int cls : kSClasses)
        if (cls >= s) { s_class = cls; break; }
      if (s_class == 0) {
        ok = false;  // pathological bit density; sample path
      } else {
        for (int ch = 0; ch < nch; ++ch) {
          const auto& bases = scratch[ch].bases;
          for (int64_t c = 0; c < n_chunks; ++c)
            h.bases.push_back((int32_t)bases[c]);
          if (!emit_slots) continue;
          uint32_t* dst = h.slots.extend((size_t)n_chunks * (s_class + 1));
          for (int64_t c = 0; c < n_chunks; ++c) {
            uint64_t cb = bases[c + 1] - bases[c];
            if (cb)
              copy_bits_from_bytes(b.base, len, bases[c],
                                   dst + (size_t)c * (s_class + 1), cb);
          }
        }
      }
    }
    if (!ok) {
      // Rewind; decode this frame's lanes on the host (legacy layout).
      h.ks.resize(ks0);
      h.deltas.resize(deltas0);
      h.bases.resize(bases0);
      h.bsubs.resize(bsubs0);
      b = saved;
      read_frame_header(b, hdr);  // re-reads the validated header
      flags = 1;
      scratch_x.resize((size_t)bs * nch);
      for (int ch = 0; ch < nch; ++ch) {
        SubDesc sd;
        parse_subframe(b, channel_bps(hdr.mode, ch, hdr.bps), bs,
                       scratch_x.data() + (size_t)ch * bs, sd);
        CxtBSub d;
        std::memset(&d, 0, sizeof(d));
        d.order = sd.order;
        d.shift = sd.shift;
        d.wasted = sd.wasted;
        std::memcpy(d.coefs, sd.coefs, sizeof(d.coefs));
        h.bsubs.push_back(d);
      }
      b.align();
      if (defer_crc) {
        b.read_be_u16();
        flags |= 2;
      } else {
        uint16_t computed =
            crc16_range(b.base + frame_start, b.base + b.bytepos());
        uint32_t presumed = b.read_be_u16();
        if (computed != presumed) fmt_err("frame CRC mismatch");
      }
      h.samples.insert(h.samples.end(), scratch_x.begin(), scratch_x.end());
    }

    h.bframes.push_back(CxtBFrame{hdr.time, hdr.block_size, hdr.channels,
                                  hdr.mode, hdr.bps, flags, s_class,
                                  (int32_t)frame_start,
                                  (int32_t)b.bytepos()});
    if (consumed) *consumed = b.bytepos();
  }
}

Handle* run(const uint8_t* data, uint64_t len, bool full_decode,
            int32_t* err_code, char* err_msg, uint64_t msg_cap,
            int64_t max_frames = -1, size_t* consumed = nullptr) {
  // Everything, including the allocation, stays inside the try: no C++
  // exception (bad_alloc included) may cross the extern "C" boundary.
  Handle* h = nullptr;
  try {
    h = new Handle();
    walk_stream(data, (size_t)len, full_decode, *h, max_frames, consumed);
    *err_code = 0;
    return h;
  } catch (const Err& e) {
    *err_code = e.code;
    if (msg_cap) {
      std::strncpy(err_msg, e.msg, msg_cap - 1);
      err_msg[msg_cap - 1] = 0;
    }
  } catch (const std::exception& e) {
    *err_code = 100;
    if (msg_cap) {
      std::strncpy(err_msg, e.what(), msg_cap - 1);
      err_msg[msg_cap - 1] = 0;
    }
  }
  delete h;
  return nullptr;
}

}  // namespace

extern "C" {

void* cxt_extract(const uint8_t* data, uint64_t len, int32_t* err_code,
                  char* err_msg, uint64_t msg_cap) {
  return run(data, len, /*full_decode=*/false, err_code, err_msg, msg_cap);
}

// Deferred frame CRCs precede a walk error in stream order; re-verifying
// them on this cold path keeps the surfaced error identical to the
// reference's sequential decode (which would have hit the earlier CRC
// mismatch first).
void check_deferred_crcs(const uint8_t* data, const Handle& h) {
  for (const CxtBFrame& f : h.bframes) {
    if (!(f.flags & 2)) continue;
    const uint8_t* q = data + f.byte1 - 2;
    uint16_t computed = crc16_range(data + f.byte0, q);
    uint16_t presumed = (uint16_t)((q[0] << 8) | q[1]);
    if (computed != presumed) fmt_err("frame CRC mismatch");
  }
}

// Bits-mode extraction (see walk_stream_bits). opts bit 0: also emit the
// host-relocated chunk slots (the delta-kernel path); without it only the
// chunk base positions are emitted and the device gathers chunk words
// straight from the uploaded stream (the minimal-uplink production path).
// opts bit 1: defer frame CRC-16 verification to the device verifier
// (stream mode only -- the raw bytes must actually ship). max_frames < 0
// walks the whole section; otherwise the walk stops after that many
// frames (container chunks hold a declared frame count) and *consumed
// reports the bytes of the frames actually parsed.
void* cxt_extract_bits(const uint8_t* data, uint64_t len, int32_t opts,
                       int64_t max_frames, uint64_t* consumed,
                       int32_t* err_code, char* err_msg, uint64_t msg_cap) {
  Handle* h = nullptr;
  try {
    h = new Handle();
    size_t used = 0;
    try {
      walk_stream_bits(data, (size_t)len, *h, (opts & 1) != 0,
                       (opts & 2) != 0, max_frames, &used);
    } catch (const Err&) {
      if (opts & 2) check_deferred_crcs(data, *h);
      throw;
    }
    if (consumed) *consumed = (uint64_t)used;
    *err_code = 0;
    return h;
  } catch (const Err& e) {
    *err_code = e.code;
    if (msg_cap) {
      std::strncpy(err_msg, e.msg, msg_cap - 1);
      err_msg[msg_cap - 1] = 0;
    }
  } catch (const std::exception& e) {
    *err_code = 100;
    if (msg_cap) {
      std::strncpy(err_msg, e.what(), msg_cap - 1);
      err_msg[msg_cap - 1] = 0;
    }
  }
  delete h;
  return nullptr;
}

// Sizes of the seven bits-mode output buffers, in elements: [frames,
// subframes, delta bytes, slot words, ks entries, sample words, bases].
void cxt_b_counts(void* hv, uint64_t* out) {
  Handle* h = (Handle*)hv;
  out[0] = h->bframes.size();
  out[1] = h->bsubs.size();
  out[2] = h->deltas.size();
  out[3] = h->slots.size;
  out[4] = h->ks.size();
  out[5] = h->samples.size();
  out[6] = h->bases.size();
}

void cxt_b_fill(void* hv, CxtBFrame* frames, CxtBSub* subs, uint8_t* deltas,
                int32_t* slots, int32_t* ks, int32_t* samples,
                int32_t* bases) {
  Handle* h = (Handle*)hv;
  static_assert(sizeof(CxtBFrame) == 40, "CxtBFrame layout");
  static_assert(sizeof(CxtBSub) == 32 + 256, "CxtBSub layout");
  if (frames && !h->bframes.empty())
    std::memcpy(frames, h->bframes.data(),
                h->bframes.size() * sizeof(CxtBFrame));
  if (subs && !h->bsubs.empty())
    std::memcpy(subs, h->bsubs.data(), h->bsubs.size() * sizeof(CxtBSub));
  if (deltas && !h->deltas.empty())
    std::memcpy(deltas, h->deltas.data(), h->deltas.size());
  if (slots && h->slots.size)
    std::memcpy(slots, h->slots.data, h->slots.size * sizeof(uint32_t));
  if (ks && !h->ks.empty())
    std::memcpy(ks, h->ks.data(), h->ks.size() * sizeof(int32_t));
  if (samples && !h->samples.empty())
    std::memcpy(samples, h->samples.data(),
                h->samples.size() * sizeof(int32_t));
  if (bases && !h->bases.empty())
    std::memcpy(bases, h->bases.data(), h->bases.size() * sizeof(int32_t));
}

void* cxt_decode(const uint8_t* data, uint64_t len, int32_t* err_code,
                 char* err_msg, uint64_t msg_cap) {
  return run(data, len, /*full_decode=*/true, err_code, err_msg, msg_cap);
}

// Extract at most max_frames frames (container chunks hold a known frame
// count; parsing must stop before inter-chunk slack).
void* cxt_extract_limited(const uint8_t* data, uint64_t len,
                          int64_t max_frames, uint64_t* consumed,
                          int32_t* err_code, char* err_msg,
                          uint64_t msg_cap) {
  size_t used = 0;
  Handle* h = run(data, len, /*full_decode=*/false, err_code, err_msg,
                  msg_cap, max_frames, &used);
  *consumed = used;
  return h;
}

// Decode at most max_frames frames; *consumed reports the bytes consumed
// by the successfully decoded frames (the streaming FrameReader entry).
void* cxt_decode_limited(const uint8_t* data, uint64_t len,
                         int64_t max_frames, uint64_t* consumed,
                         int32_t* err_code, char* err_msg,
                         uint64_t msg_cap) {
  size_t used = 0;
  Handle* h = run(data, len, /*full_decode=*/true, err_code, err_msg,
                  msg_cap, max_frames, &used);
  *consumed = used;
  return h;
}

uint64_t cxt_n_frames(void* h) { return ((Handle*)h)->frames.size(); }
uint64_t cxt_n_subframes(void* h) { return ((Handle*)h)->subs.size(); }
uint64_t cxt_n_lane_samples(void* h) { return ((Handle*)h)->samples.size(); }
uint64_t cxt_pcm_len(void* h) { return ((Handle*)h)->pcm.size(); }

void cxt_fill(void* hv, CxtFrame* frames, void* subs, int32_t* samples) {
  Handle* h = (Handle*)hv;
  static_assert(sizeof(CxtFrame) == 24, "CxtFrame layout");
  static_assert(sizeof(SubDesc) == 16 + 128, "SubDesc layout");
  if (frames && !h->frames.empty())
    std::memcpy(frames, h->frames.data(),
                h->frames.size() * sizeof(CxtFrame));
  if (subs && !h->subs.empty())
    std::memcpy(subs, h->subs.data(), h->subs.size() * sizeof(SubDesc));
  if (samples && !h->samples.empty())
    std::memcpy(samples, h->samples.data(),
                h->samples.size() * sizeof(int32_t));
}

void cxt_pcm_fill(void* hv, int32_t* out) {
  Handle* h = (Handle*)hv;
  if (out && !h->pcm.empty())
    std::memcpy(out, h->pcm.data(), h->pcm.size() * sizeof(int32_t));
}

void cxt_free(void* h) { delete (Handle*)h; }

// Fused bucket-fill helper for the pipeline's packed-input fast path:
// copy n_rows rows of bs int32 samples (starting at src[0]) into an int16
// destination with dst_stride int16 elements per row, converting in one
// pass (values must already be known to fit int16; the caller decides via
// a min/max scan). Rows beyond bs stay untouched (pre-zeroed by caller).
void cxt_rows_to_i16(const int32_t* __restrict src, int64_t n_rows,
                     int64_t bs, int16_t* __restrict dst,
                     int64_t dst_stride, int64_t lane0) {
  for (int64_t r = 0; r < n_rows; ++r) {
    const int32_t* __restrict s = src + r * bs;
    int16_t* __restrict d = dst + (lane0 + r) * dst_stride;
#pragma GCC ivdep
    for (int64_t i = 0; i < bs; ++i) d[i] = (int16_t)s[i];
  }
}

// Min/max over a run of int32 samples (the packing decision), single pass.
void cxt_minmax(const int32_t* src, int64_t n, int32_t* mn, int32_t* mx) {
  int32_t lo = 0, hi = 0;  // padding is zero, so include 0 in the range
  for (int64_t i = 0; i < n; ++i) {
    int32_t v = src[i];
    lo = v < lo ? v : lo;
    hi = v > hi ? v : hi;
  }
  *mn = lo;
  *mx = hi;
}

// Bulk CRC-16 over a byte range (slice-by-8). Used by Python cold paths
// that must re-verify deferred frame CRCs before surfacing another error
// (reference sequential order: the earlier failure wins).
int32_t cxt_crc16(const uint8_t* data, uint64_t len) {
  return crc16_range(data, data + len);
}

int32_t cxt_abi_version() { return 5; }

}  // extern "C"
