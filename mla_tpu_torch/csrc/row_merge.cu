// The row-merge probe's two kernels for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of scripts/probe_mosaic_reshape.py:
//   control_kernel  o = x * 2 (an elementwise control the TPU compiler was
//                   known to accept), here scale2_kernel;
//   kernel          the in-kernel row-merge reshape [960, 160] -> [320, 480]
//                   (3 rows -> 1) that Mosaic rejected, the capability whose
//                   absence made the TPU front-end build residue-class copies
//                   of the waveform; here row_merge_kernel, generic over the
//                   merge factor `rows` and the shape [R, C].
//
// What bounds them on this card: bytes. Each reads its input once and
// writes its output once (1.2288 MB at [960, 160] f32) and does at most one
// multiply per element, so the bound is bytes / 3.35 TB/s. At the probe's
// shape that is 0.37 us, well under a launch's own cost; the kernels are
// here to show the capability and to be right, not to be fast.
//
// What the design does about it: a grid-stride loop with one element per
// thread per pass, neighbouring threads on neighbouring output addresses,
// so both the reads and the writes are coalesced. row_merge computes the
// source of each output element from its (r, j, c) coordinates,
//   out[r, j * C + c] = x[rows * r + j, c],
// rather than copying the buffer: for a contiguous input the bytes are the
// same, but the index arithmetic is the row-merge the TPU kernel could not
// express.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM; the loop covers the rest

int blocks_for(int64_t n) {
  const int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

__global__ void scale2_kernel(const float* __restrict__ x, float* __restrict__ out,
                              int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = x[i] * 2.0f;
}

// x [R, C] -> out [R / rows, rows * C]
__global__ void row_merge_kernel(const float* __restrict__ x, float* __restrict__ out,
                                 int64_t out_rows, int64_t c_in, int64_t rows) {
  const int64_t out_cols = rows * c_in;
  const int64_t n = out_rows * out_cols;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; o < n;
       o += stride) {
    const int64_t r = o / out_cols;
    const int64_t k = o - r * out_cols;
    const int64_t j = k / c_in;
    const int64_t c = k - j * c_in;
    out[o] = x[(rows * r + j) * c_in + c];
  }
}

}  // namespace

// C entry points, bound with ctypes. Each returns a cudaError_t (0 = launched).
extern "C" int mla_scale2(const float* x, float* out, int64_t n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  scale2_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mla_row_merge(const float* x, float* out, int64_t r_in, int64_t c_in,
                             int64_t rows, void* stream) {
  if (r_in < 1 || c_in < 1 || rows < 1 || r_in % rows != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  row_merge_kernel<<<blocks_for(r_in * c_in), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, r_in / rows, c_in, rows);
  return static_cast<int>(cudaGetLastError());
}
