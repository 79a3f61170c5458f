// crc16_device and crc16_frames_device on Hopper: the CRC-16 (polynomial
// 0x8005, init 0, MSB-first; claxon src/crc.rs) of each row of a byte
// matrix, and of each right-aligned window of the stream upload.
//
// Replaces claxon_tpu/ops/crc.py:33 crc16_device (a scan over byte
// columns) and :284 crc16_frames_device (word CRCs joined by a GF(2)
// tree), XLA programs on the TPU. No decode route runs either, in either
// package; their callers are their tests and chip_smoke.py.
//
// crc16_rows: row l of data (L, B) int32 gives the low byte of each of
// its first n = clamp(lengths[l], 0, B) elements (the JAX scan takes
// ((state >> 8) ^ col) & 0xFF, so only the low byte counts).
// crc16_windows: range f gives the 4 n_words bytes of a window that ends
// at ends[f], built as the JAX function builds it: word s of the window is
// an unaligned big-endian load from stream words q0 + s and q0 + s + 1,
// q0 = floor((ends - 4 n_words) / 4), each index clipped to [0, S-1], and
// a byte at position p is zeroed unless starts <= p < ends (int32
// arithmetic that wraps, as there). So a range longer than the window
// gives the CRC of its last 4 n_words bytes, starts > ends gives 0, and
// positions outside the upload read the clipped words. This is not K4's
// rule (csrc/crc.cu clamps ranges to the upload).
//
// Both are one CRC of a message of whole big-endian words a warp. With
// init 0 and no final xor, leading zero bytes do not change a CRC, so the
// message is padded at its front to whole 128-byte steps; lane t takes
// word t of each step, carries its state across steps with M_7 (shift by
// 128 zero bytes) and a 5-level warp tree (M_2..M_6) joins the lanes, as
// K4 joins its 16-byte lane pieces. The tables are ops/crc.py::
// kernel_tables, K4's: the slice-by-4 tables T0..T3, then the shift by
// 2^k zero bytes as two 256-entry tables (low byte, high byte) a level.
//
// What bounds them on this card: the bytes read once, each row's first
// n elements for the rows and the upload for the windows (chip_smoke.py
// prints both bounds). Rows and ranges are independent: a warp each,
// over a grid-stride loop. A window is read whole, its zeroed bytes
// included: the simple form, one code path.

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

// The low bytes of a row's first n elements, padded at the front to
// whole words.
struct RowWord {
  const int* row;
  int64_t lead;  // 4 ceil(n / 4) - n
  __device__ unsigned operator()(int64_t s) const {
    unsigned x = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t i = 4 * s + j - lead;
      x = (x << 8) | (i >= 0 ? ((unsigned)__ldg(row + i) & 0xFFu) : 0u);
    }
    return x;
  }
};

__global__ void __launch_bounds__(kWarps * 32)
crc16_rows_kernel(const int* __restrict__ data, int64_t L, int64_t B,
                  const int* __restrict__ lengths,
                  const int* __restrict__ tables, int* __restrict__ out) {
  __shared__ Tables sh;
  load_tables(sh, tables);
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  for (int64_t l = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       l < L; l += n_warps) {
    const int len = lengths[l];
    const int64_t n = len < 0 ? 0 : (len > B ? B : len);
    const int64_t nw = (n + 3) / 4;
    const unsigned crc = warp_crc(sh, nw, RowWord{data + l * B, 4 * nw - n});
    if ((threadIdx.x & 31) == 0) out[l] = (int)crc;
  }
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

// tables: ops/crc.py::kernel_tables (K4's layout).
extern "C" int cxk_crc16_rows(const int* data, int64_t L, int64_t B,
                              const int* lengths, const int* tables,
                              int* out, void* cuda_stream) {
  if (L > 0)
    crc16_rows_kernel<<<grid_for(L), kWarps * 32, 0,
                        (cudaStream_t)cuda_stream>>>(data, L, B, lengths,
                                                     tables, out);
  return (int)cudaGetLastError();
}

// stream (S,) with S >= 1; n_words a power of two.
extern "C" int cxk_crc16_windows(const int* stream, int64_t S,
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
