// K1: batched FLAC prediction synthesis on Hopper.
//
// Replaces claxon_tpu/ops/pallas_synth.py::synthesize_pallas (the Pallas
// TPU kernel; plain form claxon_tpu/ops/predict.py::synthesize). Per lane:
//
//   out[t] = x[t] + ((sum_k c[k] * out[t-32+k]) >> shift)   for t >= order
//   out[t] = x[t]                                           for t <  order
//   out[t] = 0                                              for t >= length
//
// with an exact sum (|c| < 2^15, 32 taps of int32 samples: < 2^51, so
// int64 holds it; wider garbage wraps as in the plain form), an arithmetic
// shift, and an int32 add that wraps (done in unsigned arithmetic). Column
// 31 of coefs multiplies out[t-1]. One recurrence covers LPC, FIXED,
// CONSTANT and VERBATIM lanes.
//
// What bounds it on this card: time is a true serial dependency (the
// `>> shift` makes each step nonlinear, so steps are not re-associated),
// and lanes are independent. The main-path bucket has L = 6912 lanes: 216
// warps for 132 SMs, far fewer threads than the card keeps in flight. So
// the time is T steps times the latency of one step, unless that falls
// below the memory floor (the bucket's x read and out write: at L 6912, T
// 4096, 226.5 MB / 3.35 TB/s = 0.068 ms). The first design (one serial
// chain of 32 int64 multiply-adds per step, the history shifted by 31
// register moves, a synchronous x tile load every 32 steps) took 1.181 ms
// there, about 570 cycles per step at 1.98 GHz.
//
// This design cuts the step latency and hides the loads:
//
// 1. Taps per warp from the coefficients. Each lane's span is 32 minus
//    the index of its first nonzero column; the warp's maximum
//    (__reduce_max_sync) picks a template instance with NT in {4, 8, 12,
//    16, 24, 32} taps. Columns below 32 - NT are zero in every lane of the
//    warp, so the result is exact for any input the plain form takes (it
//    multiplies all 32 columns). LPC order 8, the headline corpus, runs 8.
// 2. A short dependency chain. The NT - 1 older taps go into four
//    independent partial sums, ready one step early; only the out[t-1]
//    tap, the shift, the add and two selects sit on the critical path.
// 3. The history as a register ring. The 32 steps of a tile are unrolled
//    fully, so the history's register indices are static and the shift
//    register becomes renaming (at most NT moves per tile, at the loop's
//    back edge).
// 4. x tiles prefetched. cp.async copies the next 32 x 32 tile into the
//    other half of a double-buffered shared tile while this one is
//    computed; tiles load and store row by row, 128 contiguous bytes per
//    warp instruction (coalesced).
// 5. Tiles past the warp's longest lane (padding lanes, short frames in a
//    wide bucket) store zeros without loading or computing.
//
// One thread per lane and one warp per block, as before.
//
// K3 fused into the store (Epilogue == true, cxk_synthesize_epilogue).
// Replaces claxon_tpu/ops/epilogue.py:39 apply_epilogue, which XLA fused
// into the synthesis program on the TPU; its plain form is ops/epilogue.py
// ::apply_epilogue. Alone, as ten torch ops, it read and wrote the whole
// (L, T) bucket again. Here it costs no bytes: lanes 2p and 2p + 1 of a
// pair are two rows of one 32 x 32 tile (a block's 32 lanes start at a
// multiple of 32), so each store of rows (2p, 2p + 1) applies the wasted
// bits shift (wrapping; 0 for an amount outside [0, 32)) and the stereo
// mode (1 left/side, 2 right/side, 3 mid/side; every other code passes
// through) to both rows, in unsigned arithmetic that wraps. Each row's
// shift and its pair's mode come by a warp shuffle from the thread that
// owns the lane. Tiles past the warp's longest lane stay zeros: the
// epilogue of two zero rows is zero. Epilogue == false is K1 alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 32;   // ORDER_MAX
constexpr int kLanes = 32;  // lanes per block: one warp
constexpr int kTile = 32;   // time steps per tile
constexpr int kStages = 2;  // x tiles in flight per warp (4 and 8 were
                            // no faster on the H100)

struct Tile {
  int v[kLanes][kTile + 1];  // +1: conflict-free per-lane rows
};

// 4-byte asynchronous copy global -> shared; ok == false fills a zero.
__device__ __forceinline__ void cp_async4(int* dst, const int* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc + a * b in one IMAD.WIDE; PTX integer adds wrap, so garbage beyond
// int64 wraps as in the plain form.
__device__ __forceinline__ long long mad_wide(int a, int b, long long acc) {
  long long d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(acc));
  return d;
}

__device__ __forceinline__ long long add_wrap(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

// v - t0 clamped into [-1, kTile + 1]: the step index j of a tile where
// a per-lane bound at time v falls, so the per-step tests are 32-bit.
__device__ __forceinline__ int tile_rel(int v, int64_t t0) {
  const int64_t r = (int64_t)v - t0;
  return r < -1 ? -1 : (r > kTile + 1 ? kTile + 1 : (int)r);
}

// Queue the x tile at [t0, t0 + 32) of the block's 32 lanes: row r is lane
// lane0 + r, thread tid copies its column.
__device__ __forceinline__ void load_tile(Tile& tile, const int* x,
                                          int64_t lane0, int64_t L,
                                          int64_t T, int64_t t0, int tid) {
  const int64_t tc = t0 + tid;
#pragma unroll 8
  for (int r = 0; r < kLanes; ++r) {
    const int64_t l = lane0 + r;
    const bool ok = l < L && tc < T;
    cp_async4(&tile.v[r][tid], ok ? x + l * T + tc : x, ok);
  }
  cp_async_commit();
}

// K3 on rows (2p, 2p + 1) of a tile: info holds the even row's shift
// (bits 0-5, 32 for "gives 0"), the odd row's (bits 8-13) and the pair's
// mode (bits 16-17, 0 for every code that passes through).
__device__ __forceinline__ void stereo(int a, int b, unsigned info, int& o0,
                                       int& o1) {
  const unsigned e0 = info & 63u, e1 = (info >> 8) & 63u, m = info >> 16;
  const unsigned c0 = e0 < 32u ? (unsigned)a << e0 : 0u;
  const unsigned c1 = e1 < 32u ? (unsigned)b << e1 : 0u;
  const unsigned mid2 = (c0 << 1) | (c1 & 1u);
  o0 = m == 2u ? (int)(c0 + c1)
               : (m == 3u ? ((int)(mid2 + c1) >> 1) : (int)c0);
  o1 = m == 1u ? (int)(c0 - c1)
               : (m == 3u ? ((int)(mid2 - c1) >> 1) : (int)c1);
}

template <int NT, bool Epilogue>
__device__ __forceinline__ void synth_warp(
    const int* __restrict__ x, const int* __restrict__ coefs,
    int* __restrict__ out, Tile* tiles, int64_t lane0, int64_t L, int64_t T,
    int64_t busy, int tid, bool live, int shift, int order, int length,
    unsigned info) {
  const int64_t lane = lane0 + tid;
  int c[NT];
  int h[NT];  // h[k] = out[t - NT + k]
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    c[k] = live ? coefs[lane * kTaps + kTaps - NT + k] : 0;
    h[k] = 0;
  }

  // A ring of kStages tiles: tile i + kStages - 1 loads while tile i is
  // computed. Every iteration commits one group (empty past the end), so
  // waiting until kStages - 1 groups are pending means tile i landed.
  const int64_t n_tiles = (busy + kTile - 1) / kTile;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      load_tile(tiles[s], x, lane0, L, T, (int64_t)s * kTile, tid);
    else
      cp_async_commit();
  }
  for (int64_t i = 0; i < n_tiles; ++i) {
    Tile& cur = tiles[i % kStages];
    const int64_t t0 = i * kTile;
    const int64_t ahead = i + kStages - 1;
    if (ahead < n_tiles)
      load_tile(tiles[ahead % kStages], x, lane0, L, T, ahead * kTile, tid);
    else
      cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int first = tile_rel(order, t0);  // steps j >= first predict
    const int end = tile_rel(length, t0);   // steps j >= end give 0
    int xr[kTile];  // this lane's row: x in, out back in place
#pragma unroll
    for (int j = 0; j < kTile; ++j) xr[j] = cur.v[tid][j];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      // Older taps: four independent sums, each ending with its newest
      // term, so they are ready before out[t-1] is.
      long long s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
      for (int k = 0; k < NT - 1; ++k) {
        if ((k & 3) == 0) s0 = mad_wide(c[k], h[k], s0);
        else if ((k & 3) == 1) s1 = mad_wide(c[k], h[k], s1);
        else if ((k & 3) == 2) s2 = mad_wide(c[k], h[k], s2);
        else s3 = mad_wide(c[k], h[k], s3);
      }
      const long long acc = mad_wide(c[NT - 1], h[NT - 1],
                                     add_wrap(add_wrap(s0, s1),
                                              add_wrap(s2, s3)));
      // The low word of acc >> shift: one funnel shift below 32, the high
      // word's arithmetic shift above (both ready, one select).
      const unsigned lo = (unsigned)acc;
      const int hi = (int)(acc >> 32);
      const unsigned pred = shift < 32 ? __funnelshift_r(lo, (unsigned)hi,
                                                         shift)
                                       : (unsigned)(hi >> (shift - 32));
      const int xt = xr[j];
      int val = j >= first ? (int)((unsigned)xt + pred) : xt;
      if (j >= end) val = 0;
#pragma unroll
      for (int k = 0; k < NT - 1; ++k) h[k] = h[k + 1];
      h[NT - 1] = val;
      xr[j] = val;
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) cur.v[tid][j] = xr[j];
    __syncwarp();
    const int64_t tc = t0 + tid;
    if (Epilogue) {
#pragma unroll 4
      for (int r = 0; r < kLanes; r += 2) {
        const unsigned inf = __shfl_sync(0xffffffffu, info, r);
        int o0, o1;
        stereo(cur.v[r][tid], cur.v[r + 1][tid], inf, o0, o1);
        const int64_t l = lane0 + r;
        if (tc < T) {
          if (l < L) out[l * T + tc] = o0;
          if (l + 1 < L) out[(l + 1) * T + tc] = o1;
        }
      }
    } else {
#pragma unroll 8
      for (int r = 0; r < kLanes; ++r) {
        const int64_t l = lane0 + r;
        if (l < L && tc < T) out[l * T + tc] = cur.v[r][tid];
      }
    }
    __syncwarp();  // the next prefetch overwrites this half
  }
  // Past every lane's length: zeros, nothing to load or compute.
  for (int64_t t0 = n_tiles * kTile; t0 < T; t0 += kTile) {
    const int64_t tc = t0 + tid;
    for (int r = 0; r < kLanes; ++r) {
      const int64_t l = lane0 + r;
      if (l < L && tc < T) out[l * T + tc] = 0;
    }
  }
}

template <bool Epilogue>
__global__ void __launch_bounds__(kLanes)
synth_kernel(const int* __restrict__ x, const int* __restrict__ coefs,
             const int* __restrict__ shifts, const int* __restrict__ orders,
             const int* __restrict__ lengths,
             const int* __restrict__ wasted,
             const int* __restrict__ pair_modes, int* __restrict__ out,
             int64_t L, int64_t T) {
  __shared__ Tile tiles[kStages];
  const int tid = threadIdx.x;
  const int64_t lane0 = (int64_t)blockIdx.x * kLanes;
  const int64_t lane = lane0 + tid;
  const bool live = lane < L;

  unsigned nonzero = 0;  // bit k: column k of this lane's coefs
  if (live) {
    for (int k = 0; k < kTaps; ++k)
      nonzero |= (unsigned)(coefs[lane * kTaps + k] != 0) << k;
  }
  const int span = nonzero ? kTaps - (__ffs(nonzero) - 1) : 0;
  const int nt = __reduce_max_sync(0xffffffffu, span);
  const int shift = live ? (shifts[lane] & 63) : 0;
  const int order = live ? orders[lane] : 0;
  const int length = live ? lengths[lane] : 0;
  int64_t busy = __reduce_max_sync(0xffffffffu, length);
  busy = busy < 0 ? 0 : (busy > T ? T : busy);
  unsigned info = 0;  // this pair's K3 parameters, on its even lane
  if (Epilogue) {
    const int w = live ? wasted[lane] : 0;
    const unsigned e = (unsigned)w < 32u ? (unsigned)w : 32u;
    const unsigned e_odd = __shfl_down_sync(0xffffffffu, e, 1);
    const int m = live ? pair_modes[lane >> 1] : 0;
    info = e | (e_odd << 8) | ((m >= 1 && m <= 3 ? (unsigned)m : 0u) << 16);
  }

  if (nt <= 4)
    synth_warp<4, Epilogue>(x, coefs, out, tiles, lane0, L, T, busy, tid,
                               live, shift, order, length, info);
  else if (nt <= 8)
    synth_warp<8, Epilogue>(x, coefs, out, tiles, lane0, L, T, busy, tid,
                               live, shift, order, length, info);
  else if (nt <= 12)
    synth_warp<12, Epilogue>(x, coefs, out, tiles, lane0, L, T, busy, tid,
                               live, shift, order, length, info);
  else if (nt <= 16)
    synth_warp<16, Epilogue>(x, coefs, out, tiles, lane0, L, T, busy, tid,
                               live, shift, order, length, info);
  else if (nt <= 24)
    synth_warp<24, Epilogue>(x, coefs, out, tiles, lane0, L, T, busy, tid,
                               live, shift, order, length, info);
  else
    synth_warp<32, Epilogue>(x, coefs, out, tiles, lane0, L, T, busy, tid,
                               live, shift, order, length, info);
}

}  // namespace

extern "C" int cxk_synthesize(const int* x, const int* coefs,
                              const int* shifts, const int* orders,
                              const int* lengths, int* out, int64_t L,
                              int64_t T, void* stream) {
  if (L > 0 && T > 0) {
    const int64_t blocks = (L + kLanes - 1) / kLanes;
    synth_kernel<false><<<(unsigned)blocks, kLanes, 0,
                          (cudaStream_t)stream>>>(
        x, coefs, shifts, orders, lengths, nullptr, nullptr, out, L, T);
  }
  return (int)cudaGetLastError();
}

// K1 + K3: wasted (L,) and pair_modes (L / 2,), L even.
extern "C" int cxk_synthesize_epilogue(const int* x, const int* coefs,
                                       const int* shifts, const int* orders,
                                       const int* lengths, const int* wasted,
                                       const int* pair_modes, int* out,
                                       int64_t L, int64_t T, void* stream) {
  if (L > 0 && T > 0) {
    const int64_t blocks = (L + kLanes - 1) / kLanes;
    synth_kernel<true><<<(unsigned)blocks, kLanes, 0,
                         (cudaStream_t)stream>>>(
        x, coefs, shifts, orders, lengths, wasted, pair_modes, out, L, T);
  }
  return (int)cudaGetLastError();
}
