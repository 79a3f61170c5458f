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
// int64 holds it), an arithmetic shift, and an int32 add that wraps
// (done in unsigned arithmetic). Column 31 of coefs multiplies out[t-1].
// One recurrence covers LPC, FIXED, CONSTANT and VERBATIM lanes.
//
// What bounds it on this card: time is a true serial dependency, so each
// lane is a chain of T steps of 32 int64 multiply-adds plus a shift and
// an add; lanes are independent. The main-path bucket has only L = 1792
// to 6912 lanes, far fewer threads than the card can keep in flight, so
// per-lane serial latency bounds the kernel, not bandwidth or ALUs.
//
// First design: one thread per lane and one warp per block (so more
// blocks spread over the 132 SMs); the 32 coefficients and the 32-sample
// history live in registers (fully unrolled, static indices). x is staged
// through shared memory in 32 x 32 tiles so the global loads and stores
// are coalesced (a direct per-lane read of x[l, t] would stride by T).
// Later work: split each lane's 32 taps over several threads, fuse K3
// (the epilogue) into the tile store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 32;   // ORDER_MAX
constexpr int kLanes = 32;  // lanes per block: one warp
constexpr int kTile = 32;   // time steps staged per tile

__global__ void __launch_bounds__(kLanes)
synth_kernel(const int* __restrict__ x, const int* __restrict__ coefs,
             const int* __restrict__ shifts, const int* __restrict__ orders,
             const int* __restrict__ lengths, int* __restrict__ out,
             int64_t L, int64_t T) {
  __shared__ int tile[kLanes][kTile + 1];  // +1: conflict-free columns
  const int tid = threadIdx.x;
  const int64_t lane0 = (int64_t)blockIdx.x * kLanes;
  const int64_t lane = lane0 + tid;
  const bool live = lane < L;

  int c[kTaps];
  int h[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) {
    c[k] = live ? coefs[lane * kTaps + k] : 0;
    h[k] = 0;
  }
  const int shift = live ? (shifts[lane] & 63) : 0;
  const int order = live ? orders[lane] : 0;
  const int length = live ? lengths[lane] : 0;

  for (int64_t t0 = 0; t0 < T; t0 += kTile) {
    const int64_t tc = t0 + tid;
    for (int r = 0; r < kLanes; ++r) {
      const int64_t l = lane0 + r;
      tile[r][tid] = (l < L && tc < T) ? x[l * T + tc] : 0;
    }
    __syncwarp();
    for (int j = 0; j < kTile; ++j) {
      const int64_t t = t0 + j;
      long long acc = 0;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc += (long long)c[k] * h[k];
      const int xt = tile[tid][j];
      const unsigned pred = (unsigned)(unsigned long long)(acc >> shift);
      int val = t >= order ? (int)((unsigned)xt + pred) : xt;
      if (t >= length) val = 0;
#pragma unroll
      for (int k = 0; k < kTaps - 1; ++k) h[k] = h[k + 1];
      h[kTaps - 1] = val;
      tile[tid][j] = val;
    }
    __syncwarp();
    for (int r = 0; r < kLanes; ++r) {
      const int64_t l = lane0 + r;
      if (l < L && tc < T) out[l * T + tc] = tile[r][tid];
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" int cxk_synthesize(const int* x, const int* coefs,
                              const int* shifts, const int* orders,
                              const int* lengths, int* out, int64_t L,
                              int64_t T, void* stream) {
  if (L > 0 && T > 0) {
    const int64_t blocks = (L + kLanes - 1) / kLanes;
    synth_kernel<<<(unsigned)blocks, kLanes, 0, (cudaStream_t)stream>>>(
        x, coefs, shifts, orders, lengths, out, L, T);
  }
  return (int)cudaGetLastError();
}
