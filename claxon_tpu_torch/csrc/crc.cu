// K4: frame CRC-16 over byte ranges of the stream upload, on Hopper.
//
// Replaces claxon_tpu/ops/crc.py::crc16_ranges_device (an XLA program on
// the TPU). For each range f: the CRC-16 (polynomial 0x8005, init 0,
// MSB-first; claxon src/crc.rs) of bytes [starts[f], ends[f]) of the
// stream, whose int32 words hold their bytes big-endian. A frame checked
// together with its stored CRC gives 0 iff the CRC matches.
//
// What bounds it on this card: the table CRC is byte-serial within a
// frame, so each range is a chain of (end - start) dependent table
// lookups; frames are independent.
//
// First design: one thread per frame, the 256-entry table built once per
// block in shared memory. Ranges are clamped to the upload, so no read
// leaves it. The TPU form's GF(2) prefix scan existed because gathers were
// slow there and is not carried over. Later work: split long frames over
// a warp and combine the partial CRCs with zero-byte shift matrices.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void crc16_ranges_kernel(const unsigned* __restrict__ stream,
                                    int64_t W,
                                    const int* __restrict__ starts,
                                    const int* __restrict__ ends,
                                    int* __restrict__ out, int64_t F) {
  __shared__ unsigned short table[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    unsigned c = (unsigned)i << 8;
    for (int b = 0; b < 8; ++b)
      c = (c & 0x8000u) ? ((c << 1) ^ 0x8005u) : (c << 1);
    table[i] = (unsigned short)(c & 0xFFFFu);
  }
  __syncthreads();
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const int64_t nbytes = 4 * W;
  int64_t s = starts[f], e = ends[f];
  s = s < 0 ? 0 : (s > nbytes ? nbytes : s);
  e = e < s ? s : (e > nbytes ? nbytes : e);
  unsigned crc = 0;
  for (int64_t i = s; i < e; ++i) {
    const unsigned b = (stream[i >> 2] >> (8 * (3 - (int)(i & 3)))) & 0xFFu;
    crc = table[((crc >> 8) ^ b) & 0xFFu] ^ ((crc << 8) & 0xFFFFu);
  }
  out[f] = (int)crc;
}

}  // namespace

extern "C" int cxk_crc16_ranges(const int* stream, int64_t W,
                                const int* starts, const int* ends, int* out,
                                int64_t F, void* cuda_stream) {
  if (F > 0) {
    const int threads = 128;
    const int64_t blocks = (F + threads - 1) / threads;
    crc16_ranges_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)cuda_stream>>>(
        (const unsigned*)stream, W, starts, ends, out, F);
  }
  return (int)cudaGetLastError();
}
