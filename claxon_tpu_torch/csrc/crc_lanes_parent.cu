// crc16_frames_device, the parent design: kept for timing only.
//
// The first hand-written windows kernel of crc16_frames_device
// (claxon_tpu/ops/crc.py:284), unchanged but for its entry name
// (cxk_crc16_windows_parent); the rows kernel of crc_lanes.cu is not
// copied. No decode route and no wrapper calls it: chip_smoke.py times it
// beside csrc/crc_lanes.cu on the same inputs, and tests/test_torch_cuda.py
// holds the two equal. What it computes, and every exactness rule, is
// written in crc_lanes.cu.
//
// Design: one warp a window, over a grid-stride loop. The message is the
// whole window, padded at its front to whole 128-byte steps; lane t takes
// window word t of each step, built from two scalar clipped loads, with
// four per-byte masks; it carries its state across steps with M_7 (shift
// by 128 zero bytes), and a 5-level warp tree (M_2..M_6) joins the lanes.
// The whole window is read, its zeroed leading bytes included, and no
// step issues its loads ahead of the previous step's table work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlice = 4 * 256;  // T0..T3
constexpr int kMatWords = 512;   // low-byte table, then high-byte table
constexpr int kShLo = 2, kShHi = 7;  // shared copies of M_2..M_7
constexpr int kWarps = 8;        // warps per block
constexpr int kBlocksPerSM = 4;

struct Tables {
  unsigned short slice[4][256];
  unsigned short mat[kShHi - kShLo + 1][kMatWords];
};

__device__ void load_tables(Tables& sh, const int* __restrict__ tables) {
  for (int i = threadIdx.x; i < kSlice; i += blockDim.x)
    sh.slice[i >> 8][i & 255] = (unsigned short)tables[i];
  for (int i = threadIdx.x; i < (kShHi - kShLo + 1) * kMatWords;
       i += blockDim.x)
    sh.mat[i / kMatWords][i % kMatWords] =
        (unsigned short)tables[kSlice + kShLo * kMatWords + i];
  __syncthreads();
}

// shift(c, 2^k bytes) from a table pair (low byte, then high byte).
__device__ __forceinline__ unsigned shift_by(const Tables& sh, int k,
                                             unsigned c) {
  const unsigned short* m = sh.mat[k - kShLo];
  return m[c & 0xFFu] ^ m[256 + (c >> 8)];
}

// The CRC of the message word(0) .. word(n_words - 1), each a big-endian
// 4-byte word, computed by the whole warp; valid in lane 0.
template <class Word>
__device__ unsigned warp_crc(const Tables& sh, int64_t n_words,
                             const Word& word) {
  const int lane = threadIdx.x & 31;
  const int64_t n_steps = (n_words + 31) / 32;
  const int64_t pad = n_steps * 32 - n_words;  // leading zero words
  unsigned acc = 0;
  for (int64_t m = 0; m < n_steps; ++m) {
    const int64_t s = m * 32 + lane - pad;
    const unsigned x = s >= 0 ? word(s) : 0u;
    acc = shift_by(sh, 7, acc) ^ sh.slice[3][x >> 24] ^
          sh.slice[2][(x >> 16) & 255] ^ sh.slice[1][(x >> 8) & 255] ^
          sh.slice[0][x & 255];
  }
  // Lane t's words are followed by 4 (31 - t) bytes of each step.
#pragma unroll
  for (int d = 0; d < 5; ++d) {
    const unsigned other = __shfl_down_sync(0xffffffffu, acc, 1 << d);
    acc = shift_by(sh, 2 + d, acc) ^ other;
  }
  return acc;
}

// Word s of range f's window (crc16_frames_device's formula).
struct WindowWord {
  const unsigned* stream;
  int S;
  int q0;      // floor((ends - 4 n_words) / 4)
  int r8;      // 8 (ends mod 4)
  int end;     // ends[f]
  int start;   // starts[f]
  int n_words;
  __device__ unsigned load(int64_t i) const {
    return __ldg(stream + (i < 0 ? 0 : (i > S - 1 ? S - 1 : i)));
  }
  __device__ unsigned operator()(int64_t s) const {
    const unsigned g0 = load(q0 + s);
    unsigned w = g0;
    if (r8) w = (g0 << r8) | (load(q0 + s + 1) >> (32 - r8));
    // Byte j (MSB first) sits at p0 + j, p0 = ends - 4 (n_words - s).
    const unsigned p0 = (unsigned)end - 4u * (unsigned)(n_words - s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = (int)(p0 + (unsigned)j);
      if (!(p >= start && p < end)) w &= ~(0xFFu << (8 * (3 - j)));
    }
    return w;
  }
};

__global__ void __launch_bounds__(kWarps * 32)
crc16_windows_kernel(const unsigned* __restrict__ stream, int S,
                     const int* __restrict__ starts,
                     const int* __restrict__ ends, int64_t F, int n_words,
                     const int* __restrict__ tables, int* __restrict__ out) {
  __shared__ Tables sh;
  load_tables(sh, tables);
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  for (int64_t f = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       f < F; f += n_warps) {
    const int e = ends[f], st = starts[f];
    const int a = (int)((unsigned)e - 4u * (unsigned)n_words);
    const WindowWord word{stream, S, a >> 2, 8 * (e & 3), e, st, n_words};
    const unsigned crc = warp_crc(sh, n_words, word);
    if ((threadIdx.x & 31) == 0) out[f] = (int)crc;
  }
}

int grid_for(int64_t rows) {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    n = 132;
  const int64_t need = (rows + kWarps - 1) / kWarps;
  const int64_t cap = (int64_t)kBlocksPerSM * n;
  return (int)(need < cap ? need : cap);
}

}  // namespace

// stream (S,) with S >= 1; n_words a power of two.
extern "C" int cxk_crc16_windows_parent(const int* stream, int64_t S,
                                        const int* starts, const int* ends,
                                        int64_t F, int64_t n_words,
                                        const int* tables, int* out,
                                        void* cuda_stream) {
  if (F > 0)
    crc16_windows_kernel<<<grid_for(F), kWarps * 32, 0,
                           (cudaStream_t)cuda_stream>>>(
        (const unsigned*)stream, (int)S, starts, ends, F, (int)n_words,
        tables, out);
  return (int)cudaGetLastError();
}
