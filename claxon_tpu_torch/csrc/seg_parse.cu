// K6: the fused demux's own body, on Hopper.
//
// Replaces the body of claxon_tpu/ops/seg_parse.py::_program.prog (one XLA
// program on the TPU that also runs the sync scan, K5, and the subframe
// walk, K7). The decode path runs the fused front before K7 and the
// summary after it:
//
//   front    two kernels for what was seven operations (the bswap, K5's
//            three launches and a cumsum, the fields and the compaction):
//            the little-endian upload to the big-endian stream that K7 and
//            K4 index, the sync hits (K5's scan), each hit's header check
//            (K5's grammar and CRC-8) and fields (block size, header
//            length, channel count and assignment, blocking flag, the
//            UTF-8 frame or sample number split into 32-bit lo and 4-bit
//            hi, the stream it lies in by a binary search of the stream
//            ends, its bits per sample, and the walkable predicate: CRC-8
//            valid, block size code 7 not 0xFFFF, the group's channel
//            count, bps > 0, 1 <= block size <= T), and the walkable
//            candidates compacted in stream order into K7's first wcap
//            lanes;
//   summary  one thread per candidate: gather its walk lane's verdict, end
//            bit, largest partition count and gather width, and pack the
//            5-word summary row with the JAX program's bit widths.
//
// What bounds the front on this card: device-memory bandwidth. It reads the
// upload once and writes the stream once (35.6 MB each for the main-path
// group); the candidate rows are under a megabyte. Design, in two kernels
// with no host round trip and no pass over the upload but the first:
//
//   scan     tiles of 4096 words, each block as many as the card holds at
//            once, the next tile's words copied into shared memory
//            (cp.async) while it works on the current one. A block swaps
//            the tile's bytes (__byte_perm) and stores the stream with
//            16-byte stores, tests each of its threads' 16 consecutive
//            words for sync hits (a SIMD-within-a-register test, the exact
//            lanes only for the rare words that pass it), checks and
//            decodes each hit's window from shared memory (the tile has a
//            halo of 4 words; the stream ends sit in shared memory too),
//            and ranks its hits with one block scan. It writes the tile's
//            counts (hits, walkable hits) and its first kSlots hits. Then
//            it writes every row and lane as it stands past the hits.
//   rank     one block per 32 tiles, launched to overlap the scan's end
//            (programmatic dependent launch): the counts of the tiles
//            before give each tile's rank and walk rank; the hits of rank
//            below C, spread over the block's threads, write their rows and
//            lanes, each window read back from the stream. A tile with more
//            than kSlots hits (dense sync mimics) is scanned again by the
//            whole block.
//
// A single pass with a decoupled look-back (Merrill and Garland, 2016) was
// tried first: with some 600 tiles in flight, each look-back waited on the
// tiles before it for longer than the tile took to stream (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "header.cuh"
#include "scan.cuh"

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void summary_kernel(const int* __restrict__ positions,
                               const int* __restrict__ fields,
                               const int* __restrict__ lane_of, int64_t C,
                               const int* __restrict__ end_bits,
                               const unsigned char* __restrict__ walk_ok,
                               const int* __restrict__ n_parts,
                               const int* __restrict__ sa_words, int nch,
                               int* __restrict__ summary) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int* f = fields + c * kFields;
  const int lane = lane_of[c];
  int ok = 0, eb = 0, np_max = 0, sa_max = 0;
  if (lane >= 0) {
    ok = walk_ok[lane] ? 1 : 0;
    eb = end_bits[lane];
    for (int ch = 0; ch < nch; ++ch) {
      const int64_t r = (int64_t)lane * nch + ch;
      np_max = ch == 0 || n_parts[r] > np_max ? n_parts[r] : np_max;
      sa_max = ch == 0 || sa_words[r] > sa_max ? sa_words[r] : sa_max;
    }
  }
  const unsigned w3 = (unsigned)clampi(f[kBlockSize], 0, 0x1FFFF) |
                      ((unsigned)clampi(f[kHlen], 0, 31) << 17) |
                      ((unsigned)clampi(f[kNchHdr], 0, 15) << 22) |
                      ((unsigned)clampi(f[kMode], 0, 3) << 26) |
                      ((unsigned)(f[kVariable] & 1) << 28) |
                      ((unsigned)f[kWalkable] << 29) | ((unsigned)ok << 30);
  const unsigned w4 = ((unsigned)f[kHi] & 0xFu) |
                      ((unsigned)clampi(np_max, 0, 127) << 4) |
                      ((unsigned)clampi(sa_max, 0, 511) << 11) |
                      ((unsigned)clampi(f[kBps], 0, 63) << 20);
  int* s = summary + c * 5;
  s[0] = positions[c];
  s[1] = eb >> 3;
  s[2] = f[kLo];
  s[3] = (int)w3;
  s[4] = (int)w4;
}

// ---- the fused front ----------------------------------------------------

constexpr int kFrontThreads = 256;
constexpr int kThreadWords = 16;  // consecutive words a thread scans
constexpr int kFrontTile = kFrontThreads * kThreadWords;  // 4096 words
constexpr int kFrontVecs = kFrontTile / 4;  // 16-byte vectors in a tile
constexpr int kFrontHalo = 4;  // words past the tile a hit's window reaches
// Hits of a tile the scan keeps for the rank kernel; a tile with more is
// scanned again there.
constexpr int kSlots = 128;
// Tiles a block of the rank kernel ranks.
constexpr int kRankTiles = 32;
// Groups of up to this many streams keep their ends and bits per sample in
// shared memory (the header decode's binary search reads them).
constexpr int kSharedStreams = 256;

struct FrontArgs {
  const unsigned* in;  // (W,) little-endian upload words
  unsigned* out;       // (W,) big-endian stream
  int64_t W, n_bytes, C, wcap, n_tiles;
  const int* ends;  // (S,) stream end bytes
  const int* si_bps;
  int S, T, nch;
  bool vec;  // in and out are 16-byte aligned
  int* positions;
  unsigned char* valid;
  int* win;
  int* fields;
  int* lane_of;
  int* start_bits;
  int* w_bs;
  int* w_mode;
  int* w_bps;
  int* counts;  // (2,): all sync hits, walkable among the first C
  int2* agg;    // (n_tiles,): each tile's hits and walkable hits
  // (n_tiles, kSlots): each tile's first hits in stream order, as (byte
  // position, walkable hits before it in the tile | walkable << 31).
  int2* slots;
};

// What every block of both kernels keeps in shared memory besides a tile.
struct FrontShared {
  unsigned char table[256];
  int ends[kSharedStreams], bps[kSharedStreams];
};

__device__ __forceinline__ unsigned bswap32(unsigned x) {
  return __byte_perm(x, 0, 0x0123);
}

// The CRC-8 table and, for up to kSharedStreams streams, their ends and
// bits per sample into shared memory; returns whether the streams are
// there. The caller synchronises before using them.
__device__ __forceinline__ bool load_shared(const FrontArgs& a,
                                            FrontShared& sh) {
  fill_crc8_table(sh.table);
  if (a.S > kSharedStreams) return false;
  for (int i = threadIdx.x; i < a.S; i += blockDim.x) {
    sh.ends[i] = a.ends[i];
    sh.bps[i] = a.si_bps[i];
  }
  return true;
}

// Shared slot of the tile's 16-byte vector v. The XOR keeps both the load
// layout (vector 256 j + t) and the scan layout (vector 4 t + j) free of
// bank conflicts.
__device__ __forceinline__ int swz(int v) { return v ^ ((v >> 3) & 7); }

// Big-endian word i of the tile (0 <= i < kFrontTile + kFrontHalo); shared
// memory holds the upload's little-endian words.
__device__ __forceinline__ unsigned tile_word(const uint4* sv,
                                              const unsigned* halo, int i) {
  if (i >= kFrontTile) return bswap32(halo[i - kFrontTile]);
  return bswap32(
      reinterpret_cast<const unsigned*>(sv)[(swz(i >> 2) << 2) | (i & 3)]);
}

// Zero in byte lane l (0 = most significant) exactly when lane l of word x
// is 0xFF and the byte after it (nxt: the next word) masked with 0xFE is
// 0xF8: a sync hit.
__device__ __forceinline__ unsigned sync_word(unsigned x, unsigned nxt) {
  const unsigned after = __funnelshift_l(nxt, x, 8);
  return ~x | ((after ^ 0xF8F8F8F8u) & 0xFEFEFEFEu);
}

// Nonzero when some byte lane of v is zero (the lanes it marks may be
// wrong above a zero lane; sync_lanes is exact).
__device__ __forceinline__ unsigned any_zero_lane(unsigned v) {
  return (v - 0x01010101u) & ~v & 0x80808080u;
}

// Bit l set exactly when byte lane l of v is zero.
__device__ __forceinline__ unsigned sync_lanes(unsigned v) {
  const unsigned z = ~(((v & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | v | 0x7F7F7F7Fu);
  // Lane l's flag (bit 31 - 8 l) to bit l.
  return (((z >> 7) & 0x01010101u) * 0x08040201u) >> 24;
}

// The 16 window bytes from five big-endian words, starting at byte lane l.
__device__ __forceinline__ void window_from(const unsigned* x, int l,
                                            unsigned* w) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const unsigned y = __funnelshift_l(x[m + 1], x[m], 8 * l);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[4 * m + k] = (y >> (24 - 8 * k)) & 0xFFu;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// Start copying tile ``tile``'s little-endian upload words and its halo
// into shared memory (cp.async, or plain loads with ``sync``); words past
// the upload repeat word W - 1.
__device__ __forceinline__ void fetch_tile(const FrontArgs& a, int64_t tile,
                                           bool sync, uint4* sv,
                                           unsigned* halo) {
  const int t = threadIdx.x;
  const int64_t b0 = tile * kFrontTile, W = a.W;
#pragma unroll
  for (int j = 0; j < kFrontVecs / kFrontThreads; ++j) {
    const int v = j * kFrontThreads + t;
    const int64_t g = b0 + 4 * v;
    if (a.vec && g + 3 < W && !sync) {
      cp_async16(&sv[swz(v)], a.in + g);
    } else {
      unsigned e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) e[k] = a.in[g + k < W ? g + k : W - 1];
      sv[swz(v)] = make_uint4(e[0], e[1], e[2], e[3]);
    }
  }
  if (t < kFrontHalo) {
    const int64_t i = b0 + kFrontTile + t;
    if (sync)
      halo[t] = a.in[i < W ? i : W - 1];
    else
      cp_async4(&halo[t], a.in + (i < W ? i : W - 1));
  }
}

// The sync hits of the thread's 16 consecutive words of the tile in shared
// memory: bit 4 k + l for byte lane l of word k. Hits are rare: a cheap
// test per word, the exact lanes only for the words that pass it.
__device__ __forceinline__ unsigned long long thread_hits(
    const FrontArgs& a, int64_t tile, const uint4* sv, const unsigned* halo) {
  const int r0 = kThreadWords * threadIdx.x;
  unsigned wd[kThreadWords + 1];
#pragma unroll
  for (int j = 0; j < kThreadWords / 4; ++j) {
    const uint4 x = sv[swz(r0 / 4 + j)];
    wd[4 * j] = bswap32(x.x);
    wd[4 * j + 1] = bswap32(x.y);
    wd[4 * j + 2] = bswap32(x.z);
    wd[4 * j + 3] = bswap32(x.w);
  }
  wd[kThreadWords] = tile_word(sv, halo, r0 + kThreadWords);
  unsigned maybe = 0;
#pragma unroll
  for (int k = 0; k < kThreadWords; ++k)
    maybe |= any_zero_lane(sync_word(wd[k], wd[k + 1])) ? 1u << k : 0u;
  unsigned long long hits = 0;
  for (; maybe; maybe &= maybe - 1) {
    const int k = __ffs(maybe) - 1;
    hits |= (unsigned long long)sync_lanes(sync_word(
                tile_word(sv, halo, r0 + k), tile_word(sv, halo, r0 + k + 1)))
            << (4 * k);
  }
  // A hit lies below n_bytes - 2 and below the upload's last byte, whose
  // next byte is 0 (the shared words past the upload repeat word W - 1).
  const int64_t end =
      a.n_bytes - 2 < 4 * a.W - 1 ? a.n_bytes - 2 : 4 * a.W - 1;
  const int64_t lim = end - 4 * (tile * kFrontTile + r0);
  if (lim < 64) hits &= lim <= 0 ? 0ull : (1ull << lim) - 1;
  return hits;
}

// Check and decode the window ``w`` of the hit at ``pos``; returns whether
// its header is valid (K5), the fields in ``f`` (K6).
__device__ __forceinline__ bool decode_hit(const FrontArgs& a,
                                           const FrontShared& sh,
                                           bool streams_shared,
                                           const unsigned* w, int64_t pos,
                                           int* f) {
  const bool ok = header_valid(w, pos, a.n_bytes, sh.table);
  header_fields(w, (int)pos, ok, streams_shared ? sh.ends : a.ends,
                streams_shared ? sh.bps : a.si_bps, a.S, a.T, a.nch, f);
  return ok;
}

// The walkable ones among the thread's hits.
__device__ __forceinline__ unsigned long long thread_walk(
    const FrontArgs& a, const FrontShared& sh, bool streams_shared,
    int64_t tile, const uint4* sv, const unsigned* halo,
    unsigned long long hits) {
  const int r0 = kThreadWords * threadIdx.x;
  unsigned long long walk = 0;
  for (unsigned long long m = hits; m; m &= m - 1) {
    const int bit = __ffsll((long long)m) - 1;
    const int r = r0 + (bit >> 2);
    unsigned x[5], w[kWin];
#pragma unroll
    for (int k = 0; k < 5; ++k) x[k] = tile_word(sv, halo, r + k);
    window_from(x, bit & 3, w);
    int f[kFields];
    decode_hit(a, sh, streams_shared, w, 4 * (tile * kFrontTile + r) +
               (bit & 3), f);
    if (f[kWalkable]) walk |= 1ull << bit;
  }
  return walk;
}

// Candidate row ``rank`` (below C) of the hit at ``pos``, and its walk lane
// ``lane`` when walkable and below wcap; the hit of rank C - 1 writes the
// walkable count of the first C.
__device__ __forceinline__ void write_row(const FrontArgs& a,
                                          const FrontShared& sh,
                                          bool streams_shared, int64_t rank,
                                          int64_t lane, int64_t pos,
                                          const unsigned* w) {
  int f[kFields];
  const bool ok = decode_hit(a, sh, streams_shared, w, pos, f);
  a.positions[rank] = (int)pos;
  a.valid[rank] = ok ? 1 : 0;
  int4* wrow = reinterpret_cast<int4*>(a.win + rank * kWin);
#pragma unroll
  for (int q = 0; q < kWin / 4; ++q)
    wrow[q] = make_int4((int)w[4 * q], (int)w[4 * q + 1], (int)w[4 * q + 2],
                        (int)w[4 * q + 3]);
#pragma unroll
  for (int k = 0; k < kFields; ++k) a.fields[rank * kFields + k] = f[k];
  const bool walked = f[kWalkable] && lane < a.wcap;
  a.lane_of[rank] = walked ? (int)lane : -1;
  if (walked) {
    a.start_bits[lane] = (int)(unsigned)((pos + f[kHlen]) * 8);
    a.w_bs[lane] = f[kBlockSize];
    a.w_mode[lane] = f[kMode];
    a.w_bps[lane] = f[kBps];
  }
  if (rank == a.C - 1) a.counts[1] = (int)(lane + f[kWalkable]);
}

// Kernel 1: each block takes the tiles blockIdx.x, + gridDim.x, ..., the
// next tile's words copied into its second shared buffer (cp.async) while
// it works on the current one: the upload's words to the big-endian
// stream, the tile's sync hits and which are walkable, its counts and its
// first kSlots hits. Then every block writes its share of the rows and
// lanes as they stand past the hits: position -1, not valid, no lane, the
// window at byte 0 and its fields (a window of zeros when nothing is
// scanned), and walk lanes of block size 0 (which K7 rejects) and bps 1.
// The rank kernel overwrites the rows and lanes of the candidates.
__global__ void __launch_bounds__(kFrontThreads) scan_kernel(FrontArgs a) {
  __shared__ uint4 sv[2][kFrontVecs];
  __shared__ unsigned halo[2][kFrontHalo];
  __shared__ FrontShared sh;
  __shared__ unsigned w0[kWin];
  __shared__ int f0[kFields];
  const int t = threadIdx.x;
  const bool streams_shared = load_shared(a, sh);
  int64_t tile = blockIdx.x;
  if (tile < a.n_tiles) fetch_tile(a, tile, false, sv[0], halo[0]);
  __syncthreads();
  if (t == 0) {
    const bool none = a.W == 0 || a.n_bytes < 2;
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      const int64_t wi = (j >> 2) < a.W - 1 ? (j >> 2) : a.W - 1;
      w0[j] = none ? 0u : (bswap32(a.in[wi]) >> (24 - 8 * (j & 3))) & 0xFFu;
    }
    header_fields(w0, 0, false, streams_shared ? sh.ends : a.ends,
                  streams_shared ? sh.bps : a.si_bps, a.S, a.T, a.nch, f0);
  }
  for (int cur = 0; tile < a.n_tiles; tile += gridDim.x, cur ^= 1) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const int64_t next = tile + gridDim.x;
    if (next < a.n_tiles)
      fetch_tile(a, next, false, sv[cur ^ 1], halo[cur ^ 1]);
    const int64_t b0 = tile * kFrontTile, W = a.W;
#pragma unroll
    for (int j = 0; j < kFrontVecs / kFrontThreads; ++j) {
      const int v = j * kFrontThreads + t;
      const int64_t g = b0 + 4 * v;
      uint4 x = sv[cur][swz(v)];
      x = make_uint4(bswap32(x.x), bswap32(x.y), bswap32(x.z), bswap32(x.w));
      if (a.vec && g + 3 < W) {
        reinterpret_cast<uint4*>(a.out)[g >> 2] = x;
      } else {
        const unsigned e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (g + k < W) a.out[g + k] = e[k];
      }
    }
    const unsigned long long hits = thread_hits(a, tile, sv[cur], halo[cur]);
    const unsigned long long walk = thread_walk(a, sh, streams_shared, tile,
                                                sv[cur], halo[cur], hits);
    int total;
    const int pre = block_excl_scan<kFrontThreads>(
        (__popcll(hits) << 16) | __popcll(walk), &total);
    if (t == 0) a.agg[tile] = make_int2(total >> 16, total & 0xFFFF);
    int slot = pre >> 16, walked = pre & 0xFFFF;
    const int64_t p0 = 4 * (b0 + kThreadWords * t);
    for (unsigned long long m = hits; m && slot < kSlots; m &= m - 1) {
      const int bit = __ffsll((long long)m) - 1;
      const int wk = (int)((walk >> bit) & 1);
      a.slots[tile * kSlots + slot++] =
          make_int2((int)(p0 + bit), walked | (wk << 31));
      walked += wk;
    }
  }
  __syncthreads();
  // The rank kernel's blocks may be scheduled now (they wait for this
  // grid's end before reading its results).
  asm volatile("griddepcontrol.launch_dependents;\n");
  const int64_t i0 = (int64_t)blockIdx.x * blockDim.x + t;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = i0; e < a.C * kWin; e += step)
    a.win[e] = (int)w0[e & (kWin - 1)];
  for (int64_t e = i0; e < a.C * kFields; e += step)
    a.fields[e] = f0[e % kFields];
  for (int64_t r = i0; r < a.C; r += step) {
    a.positions[r] = -1;
    a.valid[r] = 0;
    a.lane_of[r] = -1;
  }
  for (int64_t l = i0; l < a.wcap; l += step) {
    a.start_bits[l] = 0;
    a.w_bs[l] = 0;
    a.w_mode[l] = 0;
    a.w_bps[l] = 1;
  }
}

// Kernel 2, one block per kRankTiles tiles: each tile's rank and walk rank
// from the counts of the tiles before it, then the rows and lanes of its
// hits of rank below C from its slots, the block's hits spread over its
// threads, each window read back from the stream; a tile with more than
// kSlots hits is scanned again by the whole block. The last block writes
// the counts.
__global__ void __launch_bounds__(kFrontThreads) rank_kernel(FrontArgs a) {
  __shared__ uint4 sv[kFrontVecs];
  __shared__ unsigned halo[kFrontHalo];
  __shared__ FrontShared sh;
  __shared__ long long s_sum[2][kFrontThreads / 32];
  __shared__ long long s_base[kRankTiles][2];
  __shared__ int s_first_hit[kRankTiles + 1];
  __shared__ int s_over[kRankTiles];
  __shared__ int s_n_over;
  const int t = threadIdx.x;
  const bool streams_shared = load_shared(a, sh);
  if (t == 0) s_n_over = 0;
  // Everything below reads the scan kernel's results.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // Hits and walkable hits of the tiles before this block's.
  const int64_t first = (int64_t)blockIdx.x * kRankTiles;
  long long h = 0, wk = 0;
  for (int64_t i = t; i < first; i += kFrontThreads) {
    const int2 g = a.agg[i];
    h += g.x;
    wk += g.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    h += __shfl_xor_sync(0xFFFFFFFFu, h, o);
    wk += __shfl_xor_sync(0xFFFFFFFFu, wk, o);
  }
  if ((t & 31) == 0) {
    s_sum[0][t >> 5] = h;
    s_sum[1][t >> 5] = wk;
  }
  __syncthreads();
  // Warp 0: the block's tiles, one a lane.
  if (t < 32) {
    long long base_h = 0, base_w = 0;
#pragma unroll
    for (int i = 0; i < kFrontThreads / 32; ++i) {
      base_h += s_sum[0][i];
      base_w += s_sum[1][i];
    }
    const int64_t tile = first + t;
    const int2 g = tile < a.n_tiles ? a.agg[tile] : make_int2(0, 0);
    long long in_h = g.x, in_w = g.y;  // inclusive within the block
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long yh = __shfl_up_sync(0xFFFFFFFFu, in_h, o);
      const long long yw = __shfl_up_sync(0xFFFFFFFFu, in_w, o);
      if (t >= o) {
        in_h += yh;
        in_w += yw;
      }
    }
    base_h += in_h - g.x;
    base_w += in_w - g.y;
    if (blockIdx.x == gridDim.x - 1 && t == 31) {
      const long long all = base_h + g.x;  // the last tile, or after it
      a.counts[0] = (int)all;
      if (all < a.C) a.counts[1] = (int)(base_w + g.y);
    }
    // This tile's hits to write: from its slots, or scanned again.
    int mine = 0;
    if (g.x > 0 && base_h < a.C) {
      if (g.x <= kSlots)
        mine = (int)(g.x < a.C - base_h ? g.x : a.C - base_h);
      else
        s_over[atomicAdd(&s_n_over, 1)] = t;
    }
    s_base[t][0] = base_h;
    s_base[t][1] = base_w;
    int off = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, off, o);
      if (t >= o) off += y;
    }
    s_first_hit[t] = off - mine;
    if (t == 31) s_first_hit[kRankTiles] = off;
  }
  __syncthreads();
  const int n_hits = s_first_hit[kRankTiles];
  for (int j = t; j < n_hits; j += kFrontThreads) {
    // The tile u of the block's j-th hit: the last with s_first_hit <= j.
    int lo = 0, hi = kRankTiles;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_first_hit[mid] <= j)
        lo = mid;
      else
        hi = mid;
    }
    const int i = j - s_first_hit[lo];
    const int2 e = a.slots[(first + lo) * kSlots + i];
    unsigned x[5], w[kWin];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int64_t wi = (e.x >> 2) + k;
      x[k] = a.out[wi < a.W - 1 ? wi : a.W - 1];
    }
    window_from(x, e.x & 3, w);
    write_row(a, sh, streams_shared, s_base[lo][0] + i,
              s_base[lo][1] + (e.y & 0x7FFFFFFF), e.x, w);
  }
  // The tiles of more than kSlots hits (dense sync mimics: garbage).
  for (int k = 0; k < s_n_over; ++k) {
    const int u = s_over[k];
    const int64_t over = first + u;
    __syncthreads();  // the previous tile's words are no longer read
    fetch_tile(a, over, true, sv, halo);
    __syncthreads();
    const unsigned long long hits = thread_hits(a, over, sv, halo);
    const unsigned long long walk =
        thread_walk(a, sh, streams_shared, over, sv, halo, hits);
    int total;
    const int pre = block_excl_scan<kFrontThreads>(
        (__popcll(hits) << 16) | __popcll(walk), &total);
    long long rank = s_base[u][0] + (pre >> 16);
    long long lane = s_base[u][1] + (pre & 0xFFFF);
    const int r0 = kThreadWords * t;
    for (unsigned long long m = hits; m && rank < a.C; m &= m - 1, ++rank) {
      const int bit = __ffsll((long long)m) - 1;
      const int r = r0 + (bit >> 2);
      unsigned x[5], w[kWin];
#pragma unroll
      for (int q = 0; q < 5; ++q) x[q] = tile_word(sv, halo, r + q);
      window_from(x, bit & 3, w);
      write_row(a, sh, streams_shared, rank, lane,
                4 * (over * kFrontTile + r) + (bit & 3), w);
      lane += (walk >> bit) & 1;
    }
  }
}

unsigned blocks_for(int64_t n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" int cxk_seg_summary(const int* positions, const int* fields,
                               const int* lane_of, int64_t C,
                               const int* end_bits,
                               const unsigned char* walk_ok,
                               const int* n_parts, const int* sa_words,
                               int64_t nch, int* summary,
                               void* cuda_stream) {
  if (C > 0)
    summary_kernel<<<blocks_for(C, 128), 128, 0,
                     (cudaStream_t)cuda_stream>>>(
        positions, fields, lane_of, C, end_bits, walk_ok, n_parts, sa_words,
        (int)nch, summary);
  return (int)cudaGetLastError();
}

static int64_t front_tiles(int64_t W) {
  return (W + kFrontTile - 1) / kFrontTile;
}

// Ints of the scratch the entry point takes: each tile's counts and slots.
extern "C" int64_t cxk_front_scratch(int64_t W) {
  return front_tiles(W) * (2 + 2 * kSlots);
}

extern "C" int cxk_demux_front(const int* words_le, int64_t W,
                               int64_t n_bytes, const int* ends,
                               const int* si_bps, int64_t S, int64_t T,
                               int64_t nch, int64_t C, int64_t wcap,
                               int* stream, int* positions,
                               unsigned char* valid, int* win, int* fields,
                               int* lane_of, int* start_bits, int* w_bs,
                               int* w_mode, int* w_bps, int* counts,
                               int* scratch, void* cuda_stream) {
  const cudaStream_t cs = (cudaStream_t)cuda_stream;
  const int64_t tiles = front_tiles(W);
  FrontArgs a;
  a.in = (const unsigned*)words_le;
  a.out = (unsigned*)stream;
  a.W = W;
  a.n_bytes = n_bytes;
  a.C = C;
  a.wcap = wcap;
  a.n_tiles = tiles;
  a.ends = ends;
  a.si_bps = si_bps;
  a.S = (int)S;
  a.T = (int)T;
  a.nch = (int)nch;
  a.vec = (((uintptr_t)words_le | (uintptr_t)stream) & 15) == 0;
  a.positions = positions;
  a.valid = valid;
  a.win = win;
  a.fields = fields;
  a.lane_of = lane_of;
  a.start_bits = start_bits;
  a.w_bs = w_bs;
  a.w_mode = w_mode;
  a.w_bps = w_bps;
  a.counts = counts;
  a.agg = (int2*)scratch;
  a.slots = (int2*)scratch + tiles;
  // The scan kernel's grid: the blocks the card holds at once, per device.
  static int capacity[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (capacity[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_kernel,
                                                        kFrontThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    capacity[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int64_t scan_blocks = tiles < capacity[dev] ? tiles : capacity[dev];
  scan_kernel<<<(unsigned)(scan_blocks > 0 ? scan_blocks : 1), kFrontThreads,
                0, cs>>>(a);
  // The rank kernel may start as the scan kernel's blocks leave their
  // tiles (programmatic dependent launch); it waits for the scan's results
  // with griddepcontrol.wait.
  const int64_t rank_blocks = (tiles + kRankTiles - 1) / kRankTiles;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rank_blocks > 0 ? rank_blocks : 1));
  cfg.blockDim = dim3(kFrontThreads);
  cfg.stream = cs;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rank_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
