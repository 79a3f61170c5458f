// K9 and K10: delta-fed Rice decoding on Hopper.
//
// K9 replaces claxon_tpu/ops/entropy.py::decode_residual_bits, K10
// claxon_tpu/ops/entropy.py::decode_residual_bits_stream_delta (XLA
// programs on the TPU). Both are given every code's length in bits
// (deltas: unary, terminator, remainder, and the Rice parameter before a
// partition's first code; 0 at warm-up and padding positions), so every
// sample decodes on its own. Within a 32-sample chunk, the exclusive sum
// of the deltas is the offset of each code in the chunk's bits; the
// remainder is the k bits ending at offset + delta, the quotient is
// delta - 1 - k - pbits * [first code of a partition], and the value the
// u32-wrapping zig-zag of (q << k) | r, or for verbatim lanes the k-bit
// field sign-extended. Warm-up samples fill t < order.
//
// K9 (the host-walk path, CLAXON_TPU_ENTROPY=delta) reads each chunk's
// bits from its slot of SA words, which the host walk relocated so that
// the chunk's first code starts at bit 0; its deltas are uint8. K10 (the
// segmented path, CLAXON_TPU_SEG_ENTROPY=delta) reads SA stream words
// from word bases >> 5 (the index clipped to [0, W - 1]), the first code
// at bit bases & 31; its deltas come from the walk as int8 and are
// sign-extended; verbatim lanes take delta = k at their active positions
// and lanes without codes (flags bit 1) decode nothing.
//
// Exactness on any input, as the JAX programs and the plain forms: the
// partition index counts the m in [1, P) with t >= m * ps (int32
// products; K9 takes ps as given, K10 as at least 1); the in-chunk word
// index is clipped to [0, SA - 1] and the word after SA - 1 reads as 0;
// every shift by a variable amount gives 0 for amounts >= 32 as an
// unsigned value; int32 sums wrap.
//
// What bounds it on this card: bytes. Each sample is read (one delta
// byte), decoded and written (4 bytes) once, and each chunk's SA words
// are read once: about 0.056 ms for K9 at the main-path bucket. Chunks
// are independent, and inside a chunk only the running sum of the deltas
// is shared. The work is integer instructions, and an H100 SM issues half
// as many of those a cycle as it has schedulers; so the instructions a
// sample costs set the time once the loads are in flight.
//
// The first design (in git history; PERF.md §6, rows K9 and K10) ran
// a warp per (lane, chunk), a thread a sample: 0.274 / 0.307 ms for K9 /
// K10 at the main-path bucket on an H100 (700 W), each warp waiting on two
// dependent round trips for 212 bytes. Measured there on the way here: a
// warp per run of 16 chunks of one lane with all loads issued at once,
// still a thread a sample, 0.144 / 0.181 ms, whatever the run length or
// block size (about 85 integer instructions a chunk: the prefix sum, the
// k shuffle, the guarded shifts); a thread a chunk, 0.130 / 0.141 ms with
// the walk's 32 samples unrolled, 0.099 / 0.119 with the loop kept small
// and the Rice parameters and warm-up samples staged, 0.092 / 0.102 with
// the forms below. A thread a chunk loses where the launch is small: its
// 32 samples are a serial walk, and below some 800 warps latency rules.
//
// Design, two launches by the chunk count:
// - Walk kernels (kWalkMinChunks chunks or more): a chunk a thread, 32
//   consecutive chunks of the flat (L, NC) chunk grid a warp (a warp may
//   straddle lanes; each thread reads its own lane's fields), as K2 does.
//   A thread walks its 32 samples with a running sum of the deltas, so no
//   prefix sum and no shuffle is spent per sample, and sets the Rice
//   parameter's shifts and masks once a partition, not once a sample.
//   At the warp's start every load is issued before the first wait: the
//   lane fields (first, since the later warm-up samples wait on the
//   orders), the deltas (rows of 9 words, so 32 rows start in 32 banks),
//   the words (K9: the warp's contiguous slot words; K10: each chunk's SA
//   words from word bases >> 5, every index clipped to the stream, the
//   base shuffled from the chunk's thread), the Rice parameters of the
//   warp's lanes, and the warm-up samples of the lanes' first chunks,
//   straight into the output tile. Word rows have an odd stride of at
//   least SA + 1, so they start in 32 banks and word SA, a zero, is the
//   word after the last: the window's second word needs no test. Where
//   no thread of a warp meets a partition threshold or a warm-up sample
//   (the main path's usual case), the walk takes a form with no partition
//   step and no order test; where no lane of the warp is verbatim, one
//   without the verbatim value. The 32 values go to a shared tile (row
//   stride 33) and leave as 16-byte stores, 512 contiguous bytes an
//   instruction. Above kMaxStagedSA (or past kMaxStagedKs Rice
//   parameters) the words (and parameters) are read from global memory.
// - Sample kernels (fewer chunks): a warp a chunk, a thread a sample, as
//   the first design, with the words copied by cp.async while the deltas and
//   the lane's fields load, and a 32-bit division for the lane. Loading
//   more ahead was slower at these sizes, by 1-4%: the Rice parameters
//   held in registers (thread j: ks[j] and ks[j + 32], k by __shfl_sync)
//   instead of ks[p] once the partition is known, and the lane's first
//   warm-up samples loaded with the fields: the extra loads of every
//   warp cost more than the round trips they save.
// Launch shape: kWarps = 4 warps a block (2, 8 and 16 were no faster for
// the sample kernels).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "shifts.cuh"

namespace {

constexpr int kWarps = 4;           // warps per block
constexpr int kTileStride = 33;     // output tile row stride (words)
constexpr int kDeltaStride = 9;     // a chunk's 32 deltas: 8 words and 1
constexpr int kMaxStagedSA = 128;   // above: words read from global memory
constexpr int kMaxStagedKs = 2048;  // Rice parameters a warp stages, at most
// The walk kernels run where they get at least this many warps (about 6
// an SM of an H100's 132); smaller launches, whose time is latency, take
// the sample kernels, a warp a chunk.
constexpr int64_t kWalkMinChunks = 24576;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(unsigned* dst, const void* src) {
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

// Staged row stride: odd, at least sa + 1 (word sa of a row is a zero).
__host__ __device__ __forceinline__ int row_stride(int sa) {
  return (sa + 1) | 1;
}

// Lanes that a warp's 32 consecutive chunks can touch.
__host__ __device__ __forceinline__ int warp_lanes(int64_t NC) {
  return NC >= 32 ? 2 : (int)(31 / NC + 2 < 32 ? 31 / NC + 2 : 32);
}

// The lane of chunk i (32-bit division where the grid allows).
__device__ __forceinline__ int64_t lane_of(int64_t i, int64_t n,
                                           int64_t NC) {
  return n <= INT_MAX ? (int64_t)((unsigned)i / (unsigned)NC) : i / NC;
}

// ---- The sample kernels: a warp a chunk, a thread a sample -------------

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

// #{m in [1, P) : t >= (int)(m * ps)}, for t >= 0.
__device__ __forceinline__ int partition_of(int t, int ps, int P) {
  if (P <= 1) return 0;
  if (ps >= 1 && (int64_t)(P - 1) * ps < ((int64_t)1 << 31))
    return min(t / ps, P - 1);
  int p = 0;
  for (int m = 1; m < P; ++m)
    p += t >= (int)((unsigned)m * (unsigned)ps) ? 1 : 0;
  return p;
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
  const int wi = max(0, min(rpos >> 5, sa - 1));  // arithmetic, as in JAX
  const unsigned w0 = word(wi);
  const unsigned w1 = wi + 1 <= sa - 1 ? word(wi + 1) : 0u;
  const unsigned win = __funnelshift_l(w1, w0, rpos);  // rpos & 31
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

// What a sample kernel's warp loads of its lane.
struct SampleLane {
  int order, ps, pb, fl, length;
  const int* ks_row;
  const int* warm_row;

  __device__ __forceinline__ void load(
      int64_t l, const int* ks, int64_t KP,
      const int* ps_, const int* orders, const int* pbits, const int* flags,
      const int* lengths, const int* warm, int64_t WM) {
    order = __ldg(orders + l);
    ps = __ldg(ps_ + l);
    pb = __ldg(pbits + l);
    fl = __ldg(flags + l);
    length = lengths ? __ldg(lengths + l) : 0;
    ks_row = ks + l * KP;
    warm_row = warm + l * WM;
  }
  // Warm-up sample t < order (0 from WM on).
  __device__ __forceinline__ int warm_at(int t, int64_t WM) const {
    return t < WM ? __ldg(warm_row + t) : 0;
  }
};

// K9, a warp a chunk g: slots (L, NC * sa) words, deltas (L, T) uint8.
template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32) delta_slots_sample_kernel(
    const unsigned* __restrict__ slots,
    const unsigned char* __restrict__ deltas,
    const int* __restrict__ ks, int64_t KP, int P, const int* __restrict__ ps,
    const int* __restrict__ orders, const int* __restrict__ pbits,
    const int* __restrict__ vflags, const int* __restrict__ warm, int64_t WM,
    int* __restrict__ out, int64_t L, int64_t NC, int sa) {
  extern __shared__ __align__(16) unsigned smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n = L * NC;
  const int64_t g = (int64_t)blockIdx.x * kWarps + warp;  // l * NC + c
  if (g >= n) return;  // warp-uniform
  const int64_t l = lane_of(g, n, NC);
  const int c = (int)(g - l * NC);
  const int t = c * 32 + lane;
  const unsigned* src = slots + g * sa;
  unsigned* staged = smem + warp * (kStaged ? sa : 0);
  if constexpr (kStaged) {
    for (int j = lane; j < sa; j += 32) cp_async4(staged + j, src + j);
  }
  const int d = deltas[g * 32 + lane];
  SampleLane f;
  f.load(l, ks, KP, ps, orders, pbits, vflags, nullptr, warm, WM);
  if constexpr (kStaged) {
    cp_async_wait_all();
    __syncwarp();
  }
  auto word = [&](int j) -> unsigned {
    if constexpr (kStaged) return staged[j];
    else return __ldg(src + j);
  };
  const int ol = warp_exclusive_sum(d, lane);
  const int p = partition_of(t, f.ps, P);
  const int k = __ldg(f.ks_row + p);
  const int pstart = p == 0 ? f.order : (int)((unsigned)p * (unsigned)f.ps);
  const int res =
      decode_sample(word, sa, d, ol, 0, k, t == pstart, f.pb, f.fl != 0);
  int val = d > 0 ? res : 0;
  if (t < f.order) val = f.warm_at(t, WM);
  out[g * 32 + lane] = val;
}

// K10, a warp a chunk g: stream (W,) words, bases (L, NC), deltas (L, T)
// int8.
template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32) delta_stream_sample_kernel(
    const unsigned* __restrict__ stream, int64_t W,
    const int* __restrict__ bases, const signed char* __restrict__ deltas,
    const int* __restrict__ ks, int64_t KP, int P, const int* __restrict__ ps,
    const int* __restrict__ orders, const int* __restrict__ pbits,
    const int* __restrict__ flags, const int* __restrict__ warm, int64_t WM,
    const int* __restrict__ lengths, int* __restrict__ out, int64_t L,
    int64_t NC, int sa) {
  extern __shared__ __align__(16) unsigned smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n = L * NC;
  const int64_t g = (int64_t)blockIdx.x * kWarps + warp;  // l * NC + c
  if (g >= n) return;  // warp-uniform
  const int64_t l = lane_of(g, n, NC);
  const int c = (int)(g - l * NC);
  const int t = c * 32 + lane;
  const int base = __ldg(bases + g);
  const int raw = deltas[g * 32 + lane];
  SampleLane f;
  f.load(l, ks, KP, ps, orders, pbits, flags, lengths, warm, WM);
  const int64_t wi0 = base >> 5;  // arithmetic, as in JAX
  unsigned* staged = smem + warp * (kStaged ? sa : 0);
  if constexpr (kStaged) {
    for (int j = lane; j < sa; j += 32)
      cp_async4(staged + j, stream + clamp_word(wi0 + j, W));
    cp_async_wait_all();
    __syncwarp();
  }
  auto word = [&](int j) -> unsigned {
    if constexpr (kStaged) return staged[j];
    else return __ldg(stream + clamp_word(wi0 + j, W));
  };
  const bool verb = (f.fl & 1) != 0;
  const int ps_b = max(f.ps, 1);
  const int p = partition_of(t, ps_b, P);
  const int k = __ldg(f.ks_row + p);
  const bool act = t >= f.order && t < f.length && (f.fl & 2) == 0;
  const int d = verb ? (act ? k : 0) : raw;
  const int ol = warp_exclusive_sum(d, lane);
  const int pstart = p == 0 ? f.order : (int)((unsigned)p * (unsigned)ps_b);
  const int res = decode_sample(word, sa, d, ol, base & 31, k, t == pstart,
                                f.pb, verb);
  int val = d > 0 ? res : 0;
  if (t < f.order) val = f.warm_at(t, WM);
  out[g * 32 + lane] = val;
}

// ---- The walk kernels: a thread a chunk, 32 chunks a warp --------------

// A thread's partition index, partition_of(t, ps, P), asked for t0, t0 +
// 1, ... Without wrap (mono) the thresholds rise by ps >= 1, so it moves
// by at most one a sample; else it is recounted each sample. (Calling
// partition_of for both cases here made the walk 3-9% slower on an H100:
// its division and tests, inlined in every sample of the generic walk.)
struct Partition {
  int P, ps, p, next;
  bool mono;

  __device__ __forceinline__ int count(int t) const {
    int q = 0;
    for (int m = 1; m < P; ++m)
      q += t >= (int)((unsigned)m * (unsigned)ps) ? 1 : 0;
    return q;
  }
  __device__ __forceinline__ void start(int t0, int ps_, int P_) {
    P = P_;
    ps = ps_;
    mono = P <= 1 || (ps >= 1 && (int64_t)(P - 1) * ps < ((int64_t)1 << 31));
    if (mono) {
      p = P <= 1 ? 0 : min(t0 / ps, P - 1);
      next = p + 1 < P ? (p + 1) * ps : INT_MAX;  // (P - 1) * ps fits
    } else {
      p = count(t0);
    }
  }
  // Moves to sample t; true when the partition changed.
  __device__ __forceinline__ bool step(int t) {
    if (mono) {
      if (t < next) return false;
      ++p;
      next = p + 1 < P ? next + ps : INT_MAX;
      return true;
    }
    const int q = count(t);
    const bool moved = q != p;
    p = q;
    return moved;
  }
};

// The Rice parameter k of a thread's partition and what a sample needs
// of it, with the XLA shifts folded in: r = shr(win, 32 - k) is the
// window >> rsh under rmask (1 <= k <= 32), shl(q, min(k, 31)) is q <<
// kq under qmask (k >= 0), sbit = shl(1, max(k - 1, 0)).
struct Rice {
  int k, rsh, kq, pstart;
  unsigned kp1, rmask, qmask, sbit;

  __device__ __forceinline__ void set(int k_, int p, int order, int ps) {
    k = k_;
    kp1 = (unsigned)k + 1u;
    rmask = k >= 1 && k <= 32 ? kFull : 0u;
    rsh = (32 - k) & 31;
    const int kmin = k < 31 ? k : 31;
    qmask = kmin >= 0 ? kFull : 0u;
    kq = kmin & 31;
    const int km1 = (int)((unsigned)k - 1u);
    sbit = shl(1u, km1 > 0 ? km1 : 0);
    pstart = p == 0 ? order : (int)((unsigned)p * (unsigned)ps);
  }
};

// Where a warp works: chunks i0 .. i0 + nv - 1 of the flat chunk grid, of
// lanes l0 .. l0 + nl - 1; thread `lane` takes chunk i = i0 + lane of lane
// l, whose first sample is t0.
struct Chunk {
  int64_t i0, i, l, l0;
  int nv, nl, t0;
  bool live;
};

__device__ __forceinline__ bool chunk_of(int lane, int warp, int64_t L,
                                         int64_t NC, Chunk& ch) {
  const int64_t n = L * NC;
  ch.i0 = ((int64_t)blockIdx.x * kWarps + warp) * 32;
  if (ch.i0 >= n) return false;  // warp-uniform
  ch.nv = (int)(n - ch.i0 < 32 ? n - ch.i0 : 32);
  ch.live = lane < ch.nv;
  ch.i = ch.i0 + (ch.live ? lane : 0);
  ch.l = lane_of(ch.i, n, NC);
  ch.l0 = lane_of(ch.i0, n, NC);
  ch.nl = (int)(lane_of(ch.i0 + ch.nv - 1, n, NC) - ch.l0 + 1);
  ch.t0 = (int)(ch.i - ch.l * NC) * 32;
  return true;
}

// Copies an nrows x ncols grid to shared memory by 4-byte cp.async:
// element e = (row e / ncols, column e % ncols) to dst[row * stride +
// column] from src(row, column), (row, column) moved on 32 elements a
// step without a division. Every thread runs the same trip count (src
// may shuffle).
template <class Src>
__device__ __forceinline__ void stage_grid(unsigned* dst, int stride,
                                           int ncols, int nrows, int lane,
                                           const Src& src) {
  const int step_r = 32 / ncols, step_c = 32 % ncols;
  int r = lane / ncols, c = lane % ncols;
  const int total = nrows * ncols;
  for (int e = lane; e < ((total + 31) & ~31); e += 32) {
    const void* g = src(r, c);
    if (e < total) cp_async4(dst + r * stride + c, g);
    r += step_r;
    c += step_c;
    if (c >= ncols) {
      c -= ncols;
      ++r;
    }
  }
}

// The warp's deltas, 32 bytes a chunk, to rows of kDeltaStride words (so
// 32 rows start in 32 banks): 4-byte copies where the tensor is 4-byte
// aligned, else byte by byte.
__device__ __forceinline__ void stage_deltas(unsigned* drows,
                                             const unsigned char* src,
                                             int nv, int lane) {
  if (((uintptr_t)src & 3) == 0) {
    stage_grid(drows, kDeltaStride, 8, nv, lane, [&](int r, int c) {
      return src + r * 32 + c * 4;
    });
  } else {
    unsigned char* d = (unsigned char*)drows;
    for (int e = lane; e < nv * 32; e += 32)
      d[(e >> 5) * kDeltaStride * 4 + (e & 31)] = src[e];
  }
}

// Warm-up samples go straight into the tile (the walk stores only t >=
// order), thread s taking t = t0 + s of each chunk set in `need`: where t
// < limit, warm[l, t] (0 from WM on).
__device__ __forceinline__ void stage_warm(unsigned* tile, unsigned need,
                                           const Chunk& ch, int limit,
                                           const int* warm, int64_t WM,
                                           int lane) {
  while (need) {
    const int r = __ffs(need) - 1;
    need &= need - 1;
    const int o = __shfl_sync(kFull, limit, r);
    const int t = __shfl_sync(kFull, ch.t0, r) + lane;
    const int64_t l = __shfl_sync(kFull, (long long)ch.l, r);
    unsigned* row = tile + r * kTileStride;
    if (t < o) {
      if (t < WM) cp_async4(row + lane, warm + l * WM + t);
      else row[lane] = 0u;
    }
  }
}

// What a thread's walk needs of its lane.
struct LaneArgs {
  int sa, ps, order, pb, active_end;
  bool verb;
};

// The walk over a thread's chunk, the values at t >= order to trow.
// `word(j)` is word j of the chunk's bits, drow its deltas, rbase the bit
// of its first code, krow its lane's Rice parameters. kStream: K10
// (verbatim lanes take delta = k at order <= t < active_end). kFast: no
// partition threshold and no warm-up sample in the chunk (no step, no
// test); kNoVerb: no verbatim lane in the warp.
template <bool kStaged, bool kStream, bool kFast, bool kNoVerb, class Words>
__device__ __forceinline__ void walk(unsigned* trow, const unsigned* drow,
                                     const Words& word, unsigned cur,
                                     const int* krow, int P,
                                     const LaneArgs& a, int t0,
                                     Partition& part, Rice& rice) {
#pragma unroll 1
  for (int g = 0; g < 8; ++g) {
    const unsigned dw = drow[g];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int t = t0 + 4 * g + b;
      if (!kFast && part.step(t))
        rice.set(krow[part.p], part.p, a.order, a.ps);
      const unsigned byte = (dw >> (8 * b)) & 0xffu;
      int d = kStream ? (int)(signed char)byte : (int)byte;
      if (kStream && !kNoVerb && a.verb)
        d = (kFast || t >= a.order) && t < a.active_end ? rice.k : 0;
      const unsigned q =
          (unsigned)d - rice.kp1 - (t == rice.pstart ? a.pb : 0);
      const unsigned rpos = cur + (unsigned)d - (unsigned)rice.k;
      cur += (unsigned)d;
      const int wi = max(0, min((int)rpos >> 5, a.sa - 1));  // arithmetic
      const unsigned w0 = word(wi);
      // Staged rows end in a zero word; else the word after sa - 1 is 0.
      const unsigned w1 = kStaged || wi + 1 <= a.sa - 1 ? word(wi + 1) : 0u;
      const unsigned win = __funnelshift_l(w1, w0, rpos);  // rpos & 31
      const unsigned r = (win >> rice.rsh) & rice.rmask;
      const unsigned v = ((q << rice.kq) & rice.qmask) | r;
      unsigned val = (v >> 1) ^ (0u - (v & 1u));
      if (!kNoVerb && a.verb) val = (r ^ rice.sbit) - rice.sbit;
      val = d > 0 ? val : 0u;
      if (kFast || t >= a.order) trow[4 * g + b] = val;
    }
  }
}

// A thread's chunk, by the fastest walk the whole warp allows.
template <bool kStaged, bool kStream, class Words>
__device__ __forceinline__ void walk_chunk(
    unsigned* trow, const unsigned* drow, const Words& word, int rbase,
    const int* krow, int P, const LaneArgs& a, const Chunk& ch) {
  Partition part;
  Rice rice;
  if (ch.live) {
    part.start(ch.t0, a.ps, P);
    rice.set(krow[part.p], part.p, a.order, a.ps);
  }
  const bool easy = !ch.live || (part.mono && part.next > ch.t0 + 31 &&
                                 ch.t0 >= a.order);
  const bool fast = __all_sync(kFull, easy);
  const bool no_verb = !__any_sync(kFull, ch.live && a.verb);
  if (!ch.live) return;
  const unsigned cur = (unsigned)rbase;
  if (fast && no_verb)
    walk<kStaged, kStream, true, true>(trow, drow, word, cur, krow, P, a,
                                       ch.t0, part, rice);
  else if (fast)
    walk<kStaged, kStream, true, false>(trow, drow, word, cur, krow, P, a,
                                        ch.t0, part, rice);
  else
    walk<kStaged, kStream, false, false>(trow, drow, word, cur, krow, P, a,
                                         ch.t0, part, rice);
}

// The warp's nv * 32 values, contiguous from out + i0 * 32: 16-byte
// stores, item v = (chunk v / 8, values 4 * (v % 8) ...).
__device__ __forceinline__ void store_tile(int* out, const unsigned* tile,
                                           int64_t i0, int nv, int lane) {
  __syncwarp();
  int4* dst = reinterpret_cast<int4*>(out + i0 * 32);
  for (int v = lane; v < nv * 8; v += 32) {
    const unsigned* row = tile + (v >> 3) * kTileStride + 4 * (v & 7);
    dst[v] = make_int4((int)row[0], (int)row[1], (int)row[2], (int)row[3]);
  }
}

// A warp's shared memory (words): the tile and the deltas of its 32
// chunks, then (staged) their word rows and the Rice parameter rows of
// its lanes.
struct Smem {
  unsigned *tile, *drows, *rows, *ks;
};

__host__ __device__ __forceinline__ int warp_words(bool staged, int sp,
                                                   int lanes, int P) {
  return 32 * (kTileStride + kDeltaStride) +
         (staged ? 32 * sp + lanes * P : 0);
}

__device__ __forceinline__ Smem smem_of(unsigned* smem, int warp,
                                        bool staged, int sp, int lanes,
                                        int P) {
  Smem m;
  m.tile = smem + warp * warp_words(staged, sp, lanes, P);
  m.drows = m.tile + 32 * kTileStride;
  m.rows = m.drows + 32 * kDeltaStride;
  m.ks = m.rows + 32 * sp;
  return m;
}

// The lane's Rice parameter row: staged, or in global memory.
template <bool kStaged>
__device__ __forceinline__ const int* k_row(const Smem& m, const Chunk& ch,
                                            const int* ks, int64_t KP,
                                            int P) {
  if constexpr (kStaged) return (const int*)m.ks + (ch.l - ch.l0) * P;
  else return ks + ch.l * KP;
}

// K9, a thread a chunk: slots (L, NC * sa) words, deltas (L, T) uint8.
template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32) delta_slots_kernel(
    const unsigned* __restrict__ slots,
    const unsigned char* __restrict__ deltas,
    const int* __restrict__ ks, int64_t KP, int P, const int* __restrict__ ps,
    const int* __restrict__ orders, const int* __restrict__ pbits,
    const int* __restrict__ vflags, const int* __restrict__ warm, int64_t WM,
    int* __restrict__ out, int64_t L, int64_t NC, int sa) {
  extern __shared__ __align__(16) unsigned smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Chunk ch;
  if (!chunk_of(lane, warp, L, NC, ch)) return;
  const int sp = kStaged ? row_stride(sa) : 0;
  const Smem m = smem_of(smem, warp, kStaged, sp, warp_lanes(NC), P);

  // Every load of the warp, issued before the first is waited for: the
  // lane's fields, the deltas, the words, the Rice parameters, the lanes'
  // first chunks' warm-up samples (the rest once the orders are known).
  LaneArgs a{sa, 0, 0, 0, 0, false};
  if (ch.live) {
    a.order = __ldg(orders + ch.l);
    a.ps = __ldg(ps + ch.l);
    a.pb = __ldg(pbits + ch.l);
    a.verb = __ldg(vflags + ch.l) != 0;
  }
  const unsigned* wsrc = slots + ch.i0 * sa;  // the warp's slots
  stage_deltas(m.drows, deltas + ch.i0 * 32, ch.nv, lane);
  if constexpr (kStaged) {
    stage_grid(m.rows, sp, sa, ch.nv, lane,
               [&](int r, int c) { return wsrc + r * sa + c; });
    if (lane < ch.nv) m.rows[lane * sp + sa] = 0u;
    stage_grid(m.ks, P, P, ch.nl, lane,
               [&](int r, int c) { return ks + (ch.l0 + r) * KP + c; });
  }
  stage_warm(m.tile, __ballot_sync(kFull, ch.live && ch.t0 == 0), ch, 32,
             warm, WM, lane);
  stage_warm(m.tile, __ballot_sync(kFull, ch.live && ch.t0 > 0 &&
                                              ch.t0 < a.order),
             ch, a.order, warm, WM, lane);
  cp_async_wait_all();
  __syncwarp();

  const unsigned* row = m.rows + lane * sp;
  const unsigned* gsrc = wsrc + lane * sa;
  auto word = [&](int j) -> unsigned {
    if constexpr (kStaged) return row[j];
    else return __ldg(gsrc + j);
  };
  walk_chunk<kStaged, false>(m.tile + lane * kTileStride,
                             m.drows + lane * kDeltaStride, word, 0,
                             k_row<kStaged>(m, ch, ks, KP, P), P, a, ch);
  store_tile(out, m.tile, ch.i0, ch.nv, lane);
}

// K10, a thread a chunk: stream (W,) words, bases (L, NC), deltas (L, T)
// int8.
template <bool kStaged>
__global__ void __launch_bounds__(kWarps * 32) delta_stream_kernel(
    const unsigned* __restrict__ stream, int64_t W,
    const int* __restrict__ bases, const signed char* __restrict__ deltas,
    const int* __restrict__ ks, int64_t KP, int P, const int* __restrict__ ps,
    const int* __restrict__ orders, const int* __restrict__ pbits,
    const int* __restrict__ flags, const int* __restrict__ warm, int64_t WM,
    const int* __restrict__ lengths, int* __restrict__ out, int64_t L,
    int64_t NC, int sa) {
  extern __shared__ __align__(16) unsigned smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Chunk ch;
  if (!chunk_of(lane, warp, L, NC, ch)) return;
  const int sp = kStaged ? row_stride(sa) : 0;
  const Smem m = smem_of(smem, warp, kStaged, sp, warp_lanes(NC), P);

  // The bases and the lane's fields first: the windows wait for the
  // bases. Then the deltas, the Rice parameters, the first chunks'
  // warm-up samples and the windows.
  const int base = ch.live ? __ldg(bases + ch.i) : 0;
  const int64_t wi0 = base >> 5;  // arithmetic, as in JAX
  LaneArgs a{sa, 1, 0, 0, 0, false};
  int fl = 2, length = 0;
  if (ch.live) {
    fl = __ldg(flags + ch.l);
    a.order = __ldg(orders + ch.l);
    a.ps = __ldg(ps + ch.l);
    a.pb = __ldg(pbits + ch.l);
    length = __ldg(lengths + ch.l);
  }
  stage_deltas(m.drows, (const unsigned char*)(deltas + ch.i0 * 32), ch.nv,
               lane);
  if constexpr (kStaged)
    stage_grid(m.ks, P, P, ch.nl, lane,
               [&](int r, int c) { return ks + (ch.l0 + r) * KP + c; });
  stage_warm(m.tile, __ballot_sync(kFull, ch.live && ch.t0 == 0), ch, 32,
             warm, WM, lane);
  a.ps = max(a.ps, 1);
  a.verb = (fl & 1) != 0;
  // Lanes without codes (flags bit 1) decode nothing: no active end.
  a.active_end = (fl & 2) ? 0 : length;
  if constexpr (kStaged) {
    stage_grid(m.rows, sp, sa, ch.nv, lane, [&](int r, int c) {
      const int64_t w = __shfl_sync(kFull, base, r & 31) >> 5;
      return stream + clamp_word(w + c, W);
    });
    if (lane < ch.nv) m.rows[lane * sp + sa] = 0u;
  }
  stage_warm(m.tile, __ballot_sync(kFull, ch.live && ch.t0 > 0 &&
                                              ch.t0 < a.order),
             ch, a.order, warm, WM, lane);
  cp_async_wait_all();
  __syncwarp();

  const unsigned* row = m.rows + lane * sp;
  auto word = [&](int j) -> unsigned {
    if constexpr (kStaged) return row[j];
    else return __ldg(stream + clamp_word(wi0 + j, W));
  };
  walk_chunk<kStaged, true>(m.tile + lane * kTileStride,
                            m.drows + lane * kDeltaStride, word, base & 31,
                            k_row<kStaged>(m, ch, ks, KP, P), P, a, ch);
  store_tile(out, m.tile, ch.i0, ch.nv, lane);
}

// A launch: the walk or the sample kernels, staged words (and, for the
// walk, Rice parameters) where they fit; blocks and shared bytes.
struct Shape {
  bool walk, staged;
  unsigned blocks;
  size_t smem;
};

Shape shape_for(int64_t L, int64_t NC, int64_t SA, int64_t P) {
  Shape s;
  const int64_t n = L * NC;
  s.walk = n >= kWalkMinChunks;
  const int lanes = warp_lanes(NC);
  s.staged =
      SA <= kMaxStagedSA && (!s.walk || lanes * P <= kMaxStagedKs);
  const int64_t warps = s.walk ? (n + 31) / 32 : n;
  s.blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  const int words =
      s.walk ? warp_words(s.staged, s.staged ? row_stride((int)SA) : 0,
                          lanes, (int)P)
             : (s.staged ? (int)SA : 0);
  s.smem = (size_t)kWarps * 4 * words;
  return s;
}

// Launches `kernel` with the shape's grid and shared memory, raising the
// shared-memory limit first where a block needs more than 48 KB.
template <class Kernel, class... Args>
int launch(Kernel kernel, const Shape& sh, cudaStream_t s, Args... args) {
  if (sh.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<sh.blocks, kWarps * 32, sh.smem, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cxk_entropy_delta_slots(
    const int* slots, const unsigned char* deltas, const int* ks, int64_t KP,
    int64_t P, const int* ps, const int* orders, const int* pbits,
    const int* vflags, const int* warm, int64_t WM, int* out, int64_t L,
    int64_t NC, int64_t SA, void* cuda_stream) {
  if (L * NC <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  const Shape sh = shape_for(L, NC, SA, P);
  const unsigned* w = (const unsigned*)slots;
  const int sa = (int)(SA > INT32_MAX ? INT32_MAX : SA);
  auto kernel = sh.walk ? (sh.staged ? delta_slots_kernel<true>
                                     : delta_slots_kernel<false>)
                        : (sh.staged ? delta_slots_sample_kernel<true>
                                     : delta_slots_sample_kernel<false>);
  return launch(kernel, sh, s, w, deltas, ks, KP, (int)P, ps, orders, pbits,
                vflags, warm, WM, out, L, NC, sa);
}

extern "C" int cxk_entropy_delta_stream(
    const int* stream, int64_t W, const int* bases, const signed char* deltas,
    const int* ks, int64_t KP, int64_t P, const int* ps, const int* orders,
    const int* pbits, const int* flags, const int* warm, int64_t WM,
    const int* lengths, int* out, int64_t L, int64_t NC, int64_t SA,
    void* cuda_stream) {
  if (L * NC <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)cuda_stream;
  const Shape sh = shape_for(L, NC, SA, P);
  const unsigned* w = (const unsigned*)stream;
  const int sa = (int)(SA > INT32_MAX ? INT32_MAX : SA);
  auto kernel = sh.walk ? (sh.staged ? delta_stream_kernel<true>
                                     : delta_stream_kernel<false>)
                        : (sh.staged ? delta_stream_sample_kernel<true>
                                     : delta_stream_sample_kernel<false>);
  return launch(kernel, sh, s, w, W, bases, deltas, ks, KP, (int)P, ps,
                orders, pbits, flags, warm, WM, lengths, out, L, NC, sa);
}
