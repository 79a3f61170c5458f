// K8: the segmented decode's values gather, on Hopper.
//
// Replaces the values-mode body of claxon_tpu/pipeline_seg.py::
// _seg_decode_program_impl (part of an XLA program on the TPU). The walk
// (K7) already decoded every residual of every walk lane; a decode
// dispatch only gathers its lanes' rows and puts the warm-up samples in
// front:
//
//   x[l, t] = t < order[r] ? warm[r, t] : values[r, t],  r = rows[l],
//
// for t < Tb32 (the dispatch bucket's chunk count times 32, at most the
// walk's row width). Rows are clamped into [0, R) so a bad plan cannot
// read outside the walk arrays. Synthesis (K1) and the epilogue (K3)
// follow in the wrapper's caller.
//
// What bounds it on this card: device-memory bandwidth, one read and one
// write of every output word. Each thread moves four consecutive samples
// as one 16-byte load and one 16-byte store (both row widths are
// multiples of 32 words, so every int4 is aligned).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_kernel(const int* __restrict__ values,
                              const int* __restrict__ warm,
                              const int* __restrict__ order,
                              const int* __restrict__ rows, int64_t R,
                              int64_t row_words, int64_t L, int64_t Tb32,
                              int* __restrict__ out) {
  const int64_t q_per_lane = Tb32 / 4;
  const int64_t n = L * q_per_lane;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t l = i / q_per_lane, q = i - l * q_per_lane;
    int64_t r = rows[l];
    r = r < 0 ? 0 : (r >= R ? R - 1 : r);
    int4 v = reinterpret_cast<const int4*>(values + r * row_words)[q];
    const int64_t t0 = 4 * q;
    const int ord = order[r];
    if (t0 < ord) {  // warm-up slots past the 32 stored ones read as zero
      const int* w = warm + r * 32;
      if (t0 + 0 < ord) v.x = t0 + 0 < 32 ? w[t0 + 0] : 0;
      if (t0 + 1 < ord) v.y = t0 + 1 < 32 ? w[t0 + 1] : 0;
      if (t0 + 2 < ord) v.z = t0 + 2 < 32 ? w[t0 + 2] : 0;
      if (t0 + 3 < ord) v.w = t0 + 3 < 32 ? w[t0 + 3] : 0;
    }
    reinterpret_cast<int4*>(out)[i] = v;
  }
}

}  // namespace

extern "C" int cxk_seg_gather(const int* values, const int* warm,
                              const int* order, const int* rows, int64_t R,
                              int64_t row_words, int64_t L, int64_t Tb32,
                              int* out, void* cuda_stream) {
  const int64_t n = L * (Tb32 / 4);
  if (n > 0 && R > 0) {
    const int threads = 256;
    const int64_t want = (n + threads - 1) / threads;
    gather_kernel<<<(unsigned)(want < 65536 ? want : 65536), threads, 0,
                    (cudaStream_t)cuda_stream>>>(values, warm, order, rows, R,
                                                 row_words, L, Tb32, out);
  }
  return (int)cudaGetLastError();
}
