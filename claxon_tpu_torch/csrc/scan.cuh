// Block-wide exclusive scan shared by the port's kernels.

#pragma once

// Exclusive scan of one int per thread over the block (blockDim.x must be
// kThreads, a multiple of 32 and at most 1024); *total gets the block's
// sum. Every thread of the block must call it. A caller that scans again
// in a loop separates the calls with __syncthreads().
template <int kThreads>
__device__ __forceinline__ int block_excl_scan(int v, int* total) {
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "block size");
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int s = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  *total = warp_sums[kThreads / 32 - 1];
  return (wid > 0 ? warp_sums[wid - 1] : 0) + x - v;
}
