// Fused log-mel front-end for Hopper (sm_90a): waveform -> log-mel frames
// in one kernel, with no frame, spectrogram or magnitude array in device
// memory.
//
// Replaces the TPU kernel mla_tpu/ops/pallas_frontend.py::fused_log_mel_patches
// (Pallas body _make_kernel.kernel). Same function: frames of `window`
// samples every `hop` samples, the Hann-folded real DFT over the mel-active
// bins as two products (re, im), sqrt(re^2 + im^2), the bins x mel product
// in f32, log(x + log_offset).
//
// What bounds it on this card. At the serving shape [8, 77120] (8 streams,
// 5 patches of 96 frames = 480 frames each, window 400, 241 mel-active bins,
// 64 mel bins) the DFT is 2 * 2 * 3840 * 400 * 241 = 1.48 GFLOP and the mel
// product 2 * 3840 * 241 * 64 = 0.118 GFLOP, done as f32 FMAs on the CUDA
// cores, against ~3.5 MB of traffic (waveform in once, log-mel out once;
// the bases add 0.83 MB and stay in L2). That is operations, not bytes, at
// the peak of each mode's operand type: f32 for "highest", bf16 tensor-core
// products for the DFT of "default" (one pass) and "bf16x3" (three), the
// mel product at f32 in every mode. This kernel does all of it as f32 FMAs
// on the CUDA cores, so in the bf16 modes it sits well above its bound.
//
// What the design does about it:
//   - Framing comes straight from the waveform: a block owns one clip and
//     kTileFrames consecutive frames and stages those frames in shared
//     memory, rounded once to the precision mode's operands. The TPU kernel
//     built g = ceil(window / hop) residue-class copies of the waveform in
//     device memory because Mosaic has no in-kernel row-merge reshape; a
//     CUDA block indexes the waveform by stride, so that traffic is gone.
//   - Each thread owns one DFT bin for all kTileFrames frames, so one pair
//     of basis loads (coalesced across the warp, L1/L2 resident) feeds
//     2 * kTileFrames FMAs, and the frame operand is a float4 shared-memory
//     load that every lane of the warp reads at the same address
//     (a broadcast, no bank conflict).
//   - The magnitude tile stays in shared memory for the mel product; only
//     the [kTileFrames, n_mel] log-mel rows are written out.
// No tensor cores yet: "highest" must not round to TF32, and the other modes
// are defined by their operand rounding, which the FMA path reproduces
// exactly. A wgmma version is later work.
//
// Precision modes (one templated operand-rounding step):
//   kF32     "highest" / "high": f32 operands, f32 FMA.
//   kBf16    "default": both operands rounded to bf16 (nearest even),
//            products summed in f32 (one bf16 pass).
//   kBf16x3  "bf16x3": hi*hi + hi*lo + lo*hi with hi = bf16(a),
//            lo = bf16(a - hi) (mla_tpu/ops/frontend.py split_bf16).
// The mel product is f32 in every mode.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileFrames = 16;
constexpr int kThreads = 256;

enum Mode { kF32 = 0, kBf16 = 1, kBf16x3 = 2 };

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Accumulate one basis column against the tile's frames over 4 taps.
template <int MODE>
__device__ __forceinline__ void accumulate(const float* __restrict__ xa,
                                           const float* __restrict__ xb,
                                           int kp, int k, const float c[4],
                                           const float s[4], float re[kTileFrames],
                                           float im[kTileFrames]) {
  if (MODE == kBf16x3) {
    float ch[4], cl[4], sh[4], sl[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      ch[u] = bf16_round(c[u]);
      cl[u] = bf16_round(c[u] - ch[u]);
      sh[u] = bf16_round(s[u]);
      sl[u] = bf16_round(s[u] - sh[u]);
    }
#pragma unroll
    for (int f = 0; f < kTileFrames; ++f) {
      const float4 h4 = *reinterpret_cast<const float4*>(xa + f * kp + k);
      const float4 l4 = *reinterpret_cast<const float4*>(xb + f * kp + k);
      const float h[4] = {h4.x, h4.y, h4.z, h4.w};
      const float l[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        re[f] = fmaf(h[u], ch[u], re[f]);
        re[f] = fmaf(h[u], cl[u], re[f]);
        re[f] = fmaf(l[u], ch[u], re[f]);
        im[f] = fmaf(h[u], sh[u], im[f]);
        im[f] = fmaf(h[u], sl[u], im[f]);
        im[f] = fmaf(l[u], sh[u], im[f]);
      }
    }
  } else {
    float cr[4], sr[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      cr[u] = MODE == kBf16 ? bf16_round(c[u]) : c[u];
      sr[u] = MODE == kBf16 ? bf16_round(s[u]) : s[u];
    }
#pragma unroll
    for (int f = 0; f < kTileFrames; ++f) {
      const float4 x4 = *reinterpret_cast<const float4*>(xa + f * kp + k);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        re[f] = fmaf(x[u], cr[u], re[f]);
        im[f] = fmaf(x[u], sr[u], im[f]);
      }
    }
  }
}

// grid (ceil(used_frames / kTileFrames), batch); block kThreads.
// wav [batch, n_samples]; cos_b, sin_b [kp, n_bins] with rows >= window zero;
// mel_w [n_bins, n_mel]; out [batch, used_frames, n_mel].
template <int MODE>
__global__ void __launch_bounds__(kThreads)
    fused_log_mel_kernel(const float* __restrict__ wav,
                         const float* __restrict__ cos_b,
                         const float* __restrict__ sin_b,
                         const float* __restrict__ mel_w,
                         float* __restrict__ out, int n_samples,
                         int used_frames, int window, int kp, int hop,
                         int n_bins, int n_mel, float log_offset) {
  extern __shared__ float4 smem4[];
  float* xa = reinterpret_cast<float*>(smem4);  // frames (hi part for bf16x3)
  float* xb = xa + kTileFrames * kp;            // lo part, bf16x3 only
  float* mag = xa + (MODE == kBf16x3 ? 2 : 1) * kTileFrames * kp;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTileFrames;
  const float* x = wav + static_cast<int64_t>(b) * n_samples;

  // 1. Stage frames t0 .. t0 + kTileFrames - 1 from the waveform, rounded
  //    to the mode's operand. Frames past used_frames and taps past the
  //    window are zero.
  for (int i = threadIdx.x; i < kTileFrames * kp; i += blockDim.x) {
    const int f = i / kp;
    const int k = i - f * kp;
    const int t = t0 + f;
    float v = 0.f;
    if (t < used_frames && k < window) v = x[static_cast<int64_t>(t) * hop + k];
    if (MODE == kF32) {
      xa[i] = v;
    } else if (MODE == kBf16) {
      xa[i] = bf16_round(v);
    } else {
      const float hi = bf16_round(v);
      xa[i] = hi;
      xb[i] = bf16_round(v - hi);
    }
  }
  __syncthreads();

  // 2. DFT: one bin per thread, all frames of the tile, then the magnitude.
  for (int j = threadIdx.x; j < n_bins; j += blockDim.x) {
    float re[kTileFrames], im[kTileFrames];
#pragma unroll
    for (int f = 0; f < kTileFrames; ++f) re[f] = im[f] = 0.f;
    for (int k = 0; k < kp; k += 4) {
      float c[4], s[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        c[u] = __ldg(cos_b + static_cast<int64_t>(k + u) * n_bins + j);
        s[u] = __ldg(sin_b + static_cast<int64_t>(k + u) * n_bins + j);
      }
      accumulate<MODE>(xa, xb, kp, k, c, s, re, im);
    }
#pragma unroll
    for (int f = 0; f < kTileFrames; ++f)
      mag[f * n_bins + j] = sqrtf(re[f] * re[f] + im[f] * im[f]);
  }
  __syncthreads();

  // 3. Mel product in f32 and the log; a warp shares one frame, so the
  //    magnitude read is a broadcast and the filterbank read is coalesced.
  for (int i = threadIdx.x; i < kTileFrames * n_mel; i += blockDim.x) {
    const int f = i / n_mel;
    const int m = i - f * n_mel;
    const int t = t0 + f;
    if (t >= used_frames) continue;
    const float* row = mag + f * n_bins;
    float acc = 0.f;
    for (int j = 0; j < n_bins; ++j) acc = fmaf(row[j], __ldg(mel_w + j * n_mel + m), acc);
    out[(static_cast<int64_t>(b) * used_frames + t) * n_mel + m] = logf(acc + log_offset);
  }
}

template <int MODE>
cudaError_t launch(const float* wav, const float* cos_b, const float* sin_b,
                   const float* mel_w, float* out, int batch, int n_samples,
                   int used_frames, int window, int kp, int hop, int n_bins,
                   int n_mel, float log_offset, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((MODE == kBf16x3 ? 2 : 1) * kTileFrames * kp + kTileFrames * n_bins);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(fused_log_mel_kernel<MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((used_frames + kTileFrames - 1) / kTileFrames, batch);
  fused_log_mel_kernel<MODE><<<grid, kThreads, smem, stream>>>(
      wav, cos_b, sin_b, mel_w, out, n_samples, used_frames, window, kp, hop,
      n_bins, n_mel, log_offset);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. Returns a cudaError_t (0 = launched).
// kp is the window rounded up to a multiple of 4 (the bases' row count);
// mode is 0 = f32, 1 = bf16, 2 = bf16x3.
extern "C" int mla_fused_log_mel(const float* wav, const float* cos_b,
                                 const float* sin_b, const float* mel_w,
                                 float* out, int batch, int n_samples,
                                 int used_frames, int window, int kp, int hop,
                                 int n_bins, int n_mel, float log_offset,
                                 int mode, void* stream) {
  if (kp % 4 != 0 || kp < window || batch < 1 || used_frames < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32:
      return launch<kF32>(wav, cos_b, sin_b, mel_w, out, batch, n_samples, used_frames,
                          window, kp, hop, n_bins, n_mel, log_offset, s);
    case kBf16:
      return launch<kBf16>(wav, cos_b, sin_b, mel_w, out, batch, n_samples, used_frames,
                           window, kp, hop, n_bins, n_mel, log_offset, s);
    case kBf16x3:
      return launch<kBf16x3>(wav, cos_b, sin_b, mel_w, out, batch, n_samples, used_frames,
                             window, kp, hop, n_bins, n_mel, log_offset, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
