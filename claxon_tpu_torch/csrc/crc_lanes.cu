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
// The tables are ops/crc.py::kernel_tables, K4's: the slice-by-4 tables
// T0..T3, then the shift by 2^k zero bytes as two 256-entry tables (low
// byte, high byte) a level. With init 0 and no final xor, leading zero
// bytes do not change a CRC, and crc(a ++ b) = shift(crc(a), |b|) ^
// crc(b).
//
// crc16_rows_kernel: one CRC of a message of whole big-endian words a
// warp, padded at its front to whole 128-byte steps; lane t takes word t
// of each step, carries its state across steps with M_7 (shift by 128
// zero bytes) and a 5-level warp tree (M_2..M_6) joins the lanes. It is
// bound by the bytes read once, each row's first n elements (chip_smoke.py
// prints the bound); rows are independent, a warp each, over a
// grid-stride loop.
//
// crc16_windows_kernel. What bounds it on this card: the bytes of the
// ranges, read once (at the headline x4 upload, 35.6 MB: 0.0107 ms at 3.35
// TB/s). The first design (in git history; PERF.md §6, row
// crc16_frames_device) read each whole
// window, about 1.6 times the frame bytes, two scalar loads a word, and
// issued no step's loads ahead of the previous step's table work.
// - Only the kept bytes are read. The window's byte i (0 <= i < 4 n) sits
//   at P = ends - 4 n + i, taken without wrapping; its int32 position is
//   P, or P + 2^32 where P < -2^31. Where P >= -2^31 the position is below
//   ends, and the byte is kept iff P >= starts. Where P < -2^31 the
//   position is at least 2^30 (4 n <= 2^30) while ends < -2^31 + 4 n <=
//   -2^30, so the byte is not kept, and P < starts too. So the kept bytes
//   are those with P >= starts, wrap or not: the window's last m =
//   clamp(ends - starts, 0, 4 n) bytes (64-bit arithmetic), a suffix. The
//   bytes before them are leading zeros: the CRC is that of the message,
//   window words s_lo = n - ceil(m / 4) .. n - 1, the first one's leading
//   4 ceil(m / 4) - m bytes zeroed. Its words are still the clipped
//   window words (q0 comes from the wrapped ends - 4 n).
// - The message is cut into items of 4 KB (kItemWords words) aligned to
//   its end, as K4 cuts its ranges; item j of range f is one warp's work,
//   and a range has at most J = ceil(n / kItemWords) of them, so the warps
//   walk the (F, J) grid without a plan pass, skipping the empty items.
//   Lane t takes 16 bytes (4 window words) of each 512-byte step, with
//   the step end-aligned to the item. Window words s .. s + 3 need stream
//   words q0 + s .. q0 + s + 4: the lane reads the aligned 16-byte group
//   of stream words that holds q0 + s (four 4-byte clipped loads where
//   the group would leave [0, S-1] or the view is not 16-byte aligned),
//   all steps of the item before its first table lookup, and takes the
//   next group from lane t + 1 by shuffles (lane 31 from lane 0 of the
//   next step; after the item's last step, from one more group that
//   lane 0 reads). The window words come with a funnel shift by 8 (ends
//   mod 4) after a word select by (q0 + n) mod 4 (one code path each,
//   picked once an item).
// - Each lane runs slice-by-4 over its 16 bytes and carries its state
//   across steps with M_9 (512 bytes); a 5-level warp tree (M_4..M_8)
//   joins the lanes; lane 0 shifts the item's CRC across the 4096 j
//   bytes after it (M_12 and up, one per set bit of j) and xors it into
//   out[f] with an atomic. The entry point zeroes out first, so a range
//   with no kept byte gives 0.
// Launch shape: 8 warps a block, 4 blocks an SM (64 registers), a
// grid-stride loop over the (F, J) items. Two forms measured slower on an
// H100 (PERF.md): each lane loading the next group itself (2 blocks an
// SM at 100 registers), and the next item's loads issued before this
// item's table work (115 registers). What holds it (PERF.md): each item
// waits for two dependent round trips (its range, then its words), and
// the slice-by-4 lookups in shared memory.

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


// crc16_frames_device's windows kernel.
constexpr int kItemWords = 1024;  // window words of one item (4 KB)
constexpr int kStepWords = 128;   // window words of one warp-wide step
constexpr int kItemSteps = kItemWords / kStepWords;
constexpr int kWinLo = 4, kWinHi = 9;  // shared copies of M_4..M_9
constexpr int kWinWarps = 8;           // warps per block
constexpr int kWinBlocksPerSM = 4;

struct WinTables {
  unsigned short slice[4][256];
  unsigned short mat[kWinHi - kWinLo + 1][kMatWords];
};

__device__ __forceinline__ unsigned win_shift(const WinTables& sh, int k,
                                              unsigned c) {
  const unsigned short* m = sh.mat[k - kWinLo];
  return m[c & 0xFFu] ^ m[256 + (c >> 8)];
}

// Stream words 4 g .. 4 g + 3, each index clipped to [0, S - 1].
__device__ __forceinline__ uint4 group_at(const unsigned* __restrict__ s,
                                          int64_t S, int64_t g, bool vec) {
  const int64_t i = 4 * g;
  if (vec && i >= 0 && i + 3 < S)
    return __ldg(reinterpret_cast<const uint4*>(s + i));
  auto at = [&](int64_t x) {
    return __ldg(s + (x < 0 ? 0 : (x > S - 1 ? S - 1 : x)));
  };
  return make_uint4(at(i), at(i + 1), at(i + 2), at(i + 3));
}

// The item's CRC in this lane's share, its stream words loaded: step i's
// window words are z[kD + k], k = 0..3, of z = X[i] ++ Y[i], shifted by r8
// bits over the next one. first: the first step's window word (this
// lane's) minus s_lo.
template <int kD>
__device__ __forceinline__ unsigned item_crc(const WinTables& sh,
                                             const uint4 (&X)[kItemSteps],
                                             const uint4& Z,
                                             int n_steps, int r8,
                                             int64_t first,
                                             unsigned lead_mask) {
  const int lane = threadIdx.x & 31;
  unsigned acc = 0;
#pragma unroll
  for (int i = 0; i < kItemSteps; ++i) {
    if (i < n_steps) {
      const uint4 nx = i + 1 < kItemSteps && i + 1 < n_steps
                           ? X[i + 1 < kItemSteps ? i + 1 : i] : Z;
      const unsigned cur[4] = {X[i].x, X[i].y, X[i].z, X[i].w};
      const unsigned nxt[4] = {nx.x, nx.y, nx.z, nx.w};
      unsigned z[8] = {cur[0], cur[1], cur[2], cur[3], 0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k <= kD; ++k)
        z[4 + k] = __shfl_sync(0xffffffffu, lane == 0 ? nxt[k] : cur[k],
                               (lane + 1) & 31);
      // Word k is the message's word c + k: 0 before its first, the
      // first one masked (c is clamped to -4..1).
      const int64_t d = first + (int64_t)kStepWords * i;
      const int c = d < -4 ? -4 : (d > 0 ? 1 : (int)d);
      unsigned st = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        unsigned w = __funnelshift_l(z[kD + k + 1], z[kD + k], r8);
        w = c + k < 0 ? 0u : (c + k == 0 ? w & lead_mask : w);
        const unsigned x = w ^ (st << 16);
        st = sh.slice[3][x >> 24] ^ sh.slice[2][(x >> 16) & 255] ^
             sh.slice[1][(x >> 8) & 255] ^ sh.slice[0][x & 255];
      }
      acc = win_shift(sh, 9, acc) ^ st;
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kWinWarps * 32, kWinBlocksPerSM)
crc16_windows_kernel(const unsigned* __restrict__ stream, int64_t S,
                     bool vec, const int* __restrict__ starts,
                     const int* __restrict__ ends, int64_t F, int n_words,
                     const int* __restrict__ tables, int* __restrict__ out) {
  __shared__ WinTables sh;
  for (int i = threadIdx.x; i < kSlice; i += blockDim.x)
    sh.slice[i >> 8][i & 255] = (unsigned short)tables[i];
  for (int i = threadIdx.x; i < (kWinHi - kWinLo + 1) * kMatWords;
       i += blockDim.x)
    sh.mat[i / kMatWords][i % kMatWords] =
        (unsigned short)tables[kSlice + kWinLo * kMatWords + i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t n = n_words;
  const int64_t J = (n + kItemWords - 1) / kItemWords;
  const int64_t total = F * J;
  const int64_t n_warps = (int64_t)gridDim.x * kWinWarps;
  for (int64_t v = (int64_t)blockIdx.x * kWinWarps + (threadIdx.x >> 5);
       v < total; v += n_warps) {
    const int64_t f = v / J, j = v - f * J;
    const int e = ends[f];
    int64_t m = (int64_t)e - starts[f];  // the kept bytes
    m = m < 0 ? 0 : (m > 4 * n ? 4 * n : m);
    const int64_t nm = (m + 3) >> 2;  // message words
    if ((int64_t)kItemWords * j >= nm) continue;  // an empty item
    const int64_t s_lo = n - nm;
    const unsigned lead_mask = 0xFFFFFFFFu >> (8 * (int)(4 * nm - m));
    const int64_t item_end = n - (int64_t)kItemWords * j;
    const int64_t item_start = item_end - kItemWords > s_lo
                                   ? item_end - kItemWords : s_lo;
    const int n_steps =
        (int)((item_end - item_start + kStepWords - 1) / kStepWords);
    const int64_t q0 = (int)((unsigned)e - 4u * (unsigned)n_words) >> 2;
    const int r8 = 8 * (e & 3);
    const int64_t sb0 = item_end - (int64_t)kStepWords * n_steps + 4 * lane;
    const int delta = (int)((q0 + sb0) & 3);  // the same in every lane
    uint4 X[kItemSteps];
#pragma unroll
    for (int i = 0; i < kItemSteps; ++i) {
      X[i] = make_uint4(0u, 0u, 0u, 0u);
      const int64_t sb = sb0 + (int64_t)kStepWords * i;
      if (i < n_steps && sb + 3 >= s_lo)  // a message word of this lane
        X[i] = group_at(stream, S, (q0 + sb) >> 2, vec);
    }
    uint4 Z = make_uint4(0u, 0u, 0u, 0u);
    if (lane == 0) Z = group_at(stream, S, (q0 + item_end) >> 2, vec);
    const int64_t first = sb0 - s_lo;
    unsigned acc;
    switch (delta) {
      case 0:
        acc = item_crc<0>(sh, X, Z, n_steps, r8, first, lead_mask);
        break;
      case 1:
        acc = item_crc<1>(sh, X, Z, n_steps, r8, first, lead_mask);
        break;
      case 2:
        acc = item_crc<2>(sh, X, Z, n_steps, r8, first, lead_mask);
        break;
      default:
        acc = item_crc<3>(sh, X, Z, n_steps, r8, first, lead_mask);
        break;
    }
    // Join the lanes: lane t's bytes are followed by 16 (31 - t) bytes
    // of each step.
#pragma unroll
    for (int d = 0; d < 5; ++d) {
      const unsigned other = __shfl_down_sync(0xffffffffu, acc, 1 << d);
      acc = win_shift(sh, kWinLo + d, acc) ^ other;
    }
    if (lane == 0) {
      // Across the 4096 j bytes after the item: M_12 and up.
      for (int b = 0; (j >> b) != 0; ++b)
        if ((j >> b) & 1) {
          const int* mt = tables + kSlice + (12 + b) * kMatWords;
          acc = (unsigned)(__ldg(mt + (acc & 0xFFu)) ^
                           __ldg(mt + 256 + (acc >> 8)));
        }
      if (acc) atomicXor(out + f, (int)acc);
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    n = 132;
  return n;
}

int grid_for(int64_t rows) {
  const int n = sm_count();
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

// stream (S,) with S >= 1; n_words a power of two, at most 2^28.
extern "C" int cxk_crc16_windows(const int* stream, int64_t S,
                                 const int* starts, const int* ends,
                                 int64_t F, int64_t n_words,
                                 const int* tables, int* out,
                                 void* cuda_stream) {
  if (F > 0) {
    cudaStream_t st = (cudaStream_t)cuda_stream;
    const cudaError_t err = cudaMemsetAsync(out, 0, F * sizeof(int), st);
    if (err != cudaSuccess) return (int)err;
    const int64_t items = F * ((n_words + kItemWords - 1) / kItemWords);
    const int64_t need = (items + kWinWarps - 1) / kWinWarps;
    const int64_t cap = (int64_t)kWinBlocksPerSM * sm_count();
    const bool vec = ((uintptr_t)stream & 15) == 0;
    crc16_windows_kernel<<<(unsigned)(need < cap ? need : cap),
                           kWinWarps * 32, 0, st>>>(
        (const unsigned*)stream, S, vec, starts, ends, F, (int)n_words,
        tables, out);
  }
  return (int)cudaGetLastError();
}
