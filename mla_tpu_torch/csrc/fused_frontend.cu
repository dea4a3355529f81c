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
// One kernel, one C entry point (mla_fused_log_mel_mma): the DFT on the
// tensor cores with mma.sync (below). The first design, every product as
// f32 FMAs on the CUDA cores, lost every measurement to it and is gone
// (PERF.md, section 6).
//
// What bounds the work. At the serving shape [8, 77120] (3840 frames, window
// 400, 240 mel-active bins, 64 mel bins) the DFT is 2 * 2 * 3840 * 400 * 240
// = 1.47 GFLOP and the mel product 0.118 GFLOP against ~3.5 MB of waveform in
// and log-mel out; at the training shape [64, 64000] (24576 frames) 9.44 and
// 0.755 GFLOP against ~23 MB. Operations, then, at the peak of each mode's
// route: one bf16 pass ("default") or three ("bf16x3") at the bf16 tensor-core
// rate, three TF32 passes ("highest") at the TF32 rate, the mel product at
// the f32 CUDA-core rate in every mode. Past the operations, what a block
// pays most for is the bases: every block reads all of them from L2 (per
// block 2 * 400 * 240 * 2 B = 0.38 MB in "default", 0.77 MB in "bf16x3",
// 1.54 MB in "highest"), so a larger frame tile where the grid is large
// cuts L2 traffic per frame.
//
// The tensor-core design (mma.sync, the warp-level tensor-core instruction;
// wgmma, TMA staging of the waveform and cluster multicast of the bases are
// later work):
//   - The DFT is a GEMM: M = BM frames of one clip (the block's tile),
//     N = bins zero-padded to np (a multiple of 16), K = taps zero-padded to
//     kp (a multiple of 16). A block is 8 warps; warp w takes the groups of
//     kNT = 2 n-tiles (8 bins each) w, w + 8, ... and all BM / 16 m-tiles,
//     so a B fragment fetched from L2 feeds BM / 16 products and an A
//     fragment from shared memory feeds 2 * kNT (cos and sin share it).
//     The cos and sin accumulators line up element for element, so
//     sqrt(re^2 + im^2) is taken in registers and stored straight into the
//     shared magnitude tile; re and im never leave the registers.
//   - Precision modes:
//       "default"  one m16n8k16 bf16 pass, both operands rounded to bf16
//                  (nearest even), f32 accumulation;
//       "bf16x3"   the same instruction three times, lo*hi + hi*lo + hi*hi
//                  with hi = bf16(a), lo = bf16(a - hi) (mla_tpu/ops/frontend.py
//                  split_bf16);
//       "highest"  3xTF32 on m16n8k8 TF32: big = tf32(a), small =
//                  tf32(a - big), each by cvt.rna.tf32.f32 (round to nearest,
//                  ties away; the unit would truncate an unconverted f32),
//                  small*big + big*small + big*big. About 21 mantissa bits,
//                  where a bf16 hi/lo split keeps about 16 (the TPU kernel's
//                  six-pass "highest" is f32-accurate; three bf16 passes are
//                  its "bf16x3").
//   - Bases: the wrapper pre-rounds and pre-splits them once per (config,
//     device, mode) and lays them out in fragment order, so a lane's B
//     fragments for one k-step and one n-tile are one 16-byte copy ("default":
//     cos and sin; otherwise two: cos hi/lo or big/small, then sin). Each
//     lane copies its own fragments with cp.async into a ring in shared
//     memory, 5 ("default") or 2 k-steps ahead of the products, so the L2
//     latency hides behind them without holding registers.
//   - Frames: the block stages its BM frames from the waveform by stride
//     into a padded f32 tile (row stride kp + 8 for the bf16 modes, kp + 4
//     for TF32: conflict-free fragment loads), so every geometry, whatever
//     hop * 4 bytes is aligned to, takes one code path. The A operand is
//     rounded or split at fragment load, not at staging: one f32 tile serves
//     every mode at the smallest shared-memory cost, and each A fragment's
//     split is paid once for 2 * kNT (x3) products.
//   - Mel product and log: f32 FMAs on the CUDA cores, summed over bins in
//     order. A thread owns one mel bin (so at most 64 mel bins) for BM / 4
//     frames, so one filterbank load feeds BM / 4 FMAs and the magnitudes
//     are 16-byte shared loads that a warp broadcasts. The filterbank is first copied into the shared memory the
//     frames and rings no longer need: with the tile's shared memory the L1
//     cannot hold it, and reading it from L2 stalled every bin.
//   - Frames are staged 16 frames per pass, so each thread keeps 16 loads
//     in flight.
//   - Shared memory per block: frames BM * (kp + 8 or + 4) * 4 B plus
//     magnitudes BM * (np + 8) * 4 B, kept apart because a warp stores its
//     magnitudes while others still read frames, plus 48 KB of B rings. At
//     16 kHz (kp 400, np 240): BM 64 -> 212 KB (bf16) / 211 KB (TF32),
//     BM 32 -> 130 KB, BM 16 -> 89 KB. At 22.05 kHz (kp 560, np 352): BM 32
//     -> 164 KB; BM 64 does not fit in 227 KB. The wrapper picks BM
//     (ops/fused_frontend.py::tile_frames).
//   - Registers per thread (ptxas -v, sm_90a, CUDA 12.8; the report is kept
//     beside the library as <library>.log and chip_smoke.py prints it), at
//     BM 64 / 32 / 16: "default" 104 / 80 / 64, "bf16x3" 127 / 80 / 64,
//     "highest" 123 / 87 / 64. No spills, but for 4 bytes in "default" at
//     BM 32 and 16.
//   - Where the time goes (PERF.md, section 6; timed phase by phase on an
//     H100): at [64, 64000] "highest", BM 64, the DFT takes ~3/4 of the
//     kernel, at about a third of the TF32 rate; a block of 8 warps fills an
//     SM's shared memory, so 2 warps per scheduler issue the products, the
//     operand splits and the shared loads (which of these stalls, the
//     timing cannot say). The mel product takes most of the rest: a shared
//     load for every 3 FMAs.
//     wgmma, warp specialisation and smaller tiles per block are the next
//     steps (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // a block's shared memory on sm_90

enum Mode { kF32 = 0, kBf16 = 1, kBf16x3 = 2 };

template <typename Kernel>
cudaError_t set_smem(Kernel* kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

constexpr int kNT = 2;  // n-tiles of 8 bins per warp group

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 -> one register of two bf16 (nearest even); `lo` in the low half,
// which an mma fragment holds at the lower k index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

// f32 -> TF32 by cvt.rna (nearest, ties away from zero), as an f32 bit
// pattern whose low 13 bits are zero (the mask makes that explicit).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// One k-step's B fragments of one n-tile: "default" uses w[0] (cos b0 b1,
// sin b0 b1); the others w[0] (cos hi/big b0 b1, lo/small b0 b1) and w[1]
// (the same for sin).
template <int MODE>
struct BFrag {
  uint4 w[MODE == kBf16 ? 1 : 2];
};

// The B ring: each lane copies its own fragments into shared memory with
// cp.async, kStages - 1 k-steps ahead of the products, and reads back only
// what it copied, so a wait_group orders it and no barrier is needed.
template <int MODE>
__host__ __device__ constexpr int ring_stages() {
  return MODE == kBf16 ? 6 : 3;  // 48 KB a block either way
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// grid (ceil(used_frames / BM), batch); block kThreads.
// wav [batch, n_samples]; basis: the packed B operand, [kp / KS, np / 8, 32
// lanes, V uint4] (ops/fused_frontend.py::pack_dft_bases); mel_w [np, n_mel]
// with rows >= n_bins zero; out [batch, used_frames, n_mel].
// Shared memory: magnitudes [BM][ms] f32, frames [BM][fs] f32, then each
// warp's B ring [kStages][kNT][V][32 lanes] uint4; after the DFT the frames
// and rings hold the mel filterbank, a chunk of bins at a time.
// Needs 4 * n_mel <= kThreads (n_mel <= 64).
template <int MODE, int MF>
__global__ void __launch_bounds__(kThreads)
    fused_log_mel_mma_kernel(const float* __restrict__ wav, const uint4* __restrict__ basis,
                             const float* __restrict__ mel_w, float* __restrict__ out,
                             int n_samples, int used_frames, int window, int kp, int hop,
                             int np_, int n_mel, float log_offset) {
  constexpr int BM = 16 * MF;
  constexpr int KS = MODE == kF32 ? 8 : 16;  // k per mma
  constexpr int V = MODE == kBf16 ? 1 : 2;   // uint4 per lane per (k-step, n-tile)
  constexpr int R = BM / 4;                  // frames per thread in the mel product
  constexpr int S = ring_stages<MODE>();
  constexpr int U = 16;                      // frames staged per pass: loads in flight
  extern __shared__ float4 smem4[];
  const int fs = kp + (MODE == kF32 ? 4 : 8);  // frame row stride, floats
  const int ms = np_ + 8;                      // magnitude row stride, floats
  float* mag = reinterpret_cast<float*>(smem4);
  float* xs = mag + BM * ms;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint4* ring = reinterpret_cast<uint4*>(xs + BM * fs) + warp * (S * kNT * V * 32) + lane;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * BM;
  const float* x = wav + static_cast<int64_t>(b) * n_samples;

  // 1. Stage frames t0 .. t0 + BM - 1 as f32, U frames per pass so that U
  //    loads are in flight per thread; frames past used_frames and taps
  //    past the window are zero.
  for (int f0 = 0; f0 < BM; f0 += U)
    for (int k = threadIdx.x; k < kp; k += kThreads) {
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + f0 + u;
        v[u] = (t < used_frames && k < window) ? __ldg(x + static_cast<int64_t>(t) * hop + k)
                                               : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) xs[(f0 + u) * fs + k] = v[u];
    }
  __syncthreads();

  // 2. DFT on the tensor cores, then the magnitude into shared memory.
  const int g = lane >> 2, tq = lane & 3;
  const int n8 = np_ / 8, steps = kp / KS;
  const int64_t step_stride = static_cast<int64_t>(n8) * 32 * V;  // uint4 per k-step
  for (int grp = warp; grp < n8 / kNT; grp += kWarps) {
    float re[MF][kNT][4], im[MF][kNT][4];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) re[mf][nt][e] = im[mf][nt][e] = 0.f;

    const uint4* bp = basis + (static_cast<int64_t>(grp) * kNT * 32 + lane) * V;
    // k-step s's fragments go to ring slot s % S: [nt][v] at stride 32 uint4
    auto issue = [&](int s) {
      uint4* dst = ring + (s % S) * (kNT * V * 32);
      const uint4* src = bp + s * step_stride;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int v = 0; v < V; ++v) cp_async16(dst + (nt * V + v) * 32, src + nt * 32 * V + v);
    };
#pragma unroll
    for (int p = 0; p < S - 1; ++p) {
      if (p < steps) issue(p);
      cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<S - 2>();  // k-step s has landed
      BFrag<MODE> bc[kNT];
      const uint4* slot = ring + (s % S) * (kNT * V * 32);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int v = 0; v < V; ++v) bc[nt].w[v] = slot[(nt * V + v) * 32];
      if (s + S - 1 < steps) issue(s + S - 1);  // into the slot read at step s - 1
      cp_async_commit();
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        const float* r0 = xs + (mf * 16 + g) * fs;
        const float* r1 = r0 + 8 * fs;
        if (MODE == kF32) {
          const int c0 = s * KS + tq;
          const float v[4] = {r0[c0], r1[c0], r0[c0 + 4], r1[c0 + 4]};
          uint32_t big[4], small[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            big[e] = tf32_rna(v[e]);
            small[e] = tf32_rna(v[e] - __uint_as_float(big[e]));
          }
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const uint4 c = bc[nt].w[0], sn = bc[nt].w[1];
            mma_tf32(re[mf][nt], small, c.x, c.y);
            mma_tf32(re[mf][nt], big, c.z, c.w);
            mma_tf32(re[mf][nt], big, c.x, c.y);
            mma_tf32(im[mf][nt], small, sn.x, sn.y);
            mma_tf32(im[mf][nt], big, sn.z, sn.w);
            mma_tf32(im[mf][nt], big, sn.x, sn.y);
          }
        } else {
          const int c0 = s * KS + 2 * tq;
          const float2 v[4] = {*reinterpret_cast<const float2*>(r0 + c0),
                               *reinterpret_cast<const float2*>(r1 + c0),
                               *reinterpret_cast<const float2*>(r0 + c0 + 8),
                               *reinterpret_cast<const float2*>(r1 + c0 + 8)};
          uint32_t hi[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) hi[e] = pack_bf16(v[e].x, v[e].y);
          if (MODE == kBf16) {
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              const uint4 w = bc[nt].w[0];
              mma_bf16(re[mf][nt], hi, w.x, w.y);
              mma_bf16(im[mf][nt], hi, w.z, w.w);
            }
          } else {
            uint32_t lo[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 h = unpack_bf16(hi[e]);
              lo[e] = pack_bf16(v[e].x - h.x, v[e].y - h.y);
            }
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              const uint4 c = bc[nt].w[0], sn = bc[nt].w[1];
              mma_bf16(re[mf][nt], lo, c.x, c.y);
              mma_bf16(re[mf][nt], hi, c.z, c.w);
              mma_bf16(re[mf][nt], hi, c.x, c.y);
              mma_bf16(im[mf][nt], lo, sn.x, sn.y);
              mma_bf16(im[mf][nt], hi, sn.z, sn.w);
              mma_bf16(im[mf][nt], hi, sn.x, sn.y);
            }
          }
        }
      }
    }
    // C fragment: (row g, cols 2tq, 2tq + 1) and (row g + 8, the same cols)
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float* a = re[mf][nt];
        const float* c = im[mf][nt];
        float* dst = mag + (mf * 16 + g) * ms + (grp * kNT + nt) * 8 + 2 * tq;
        *reinterpret_cast<float2*>(dst) =
            make_float2(sqrtf(a[0] * a[0] + c[0] * c[0]), sqrtf(a[1] * a[1] + c[1] * c[1]));
        *reinterpret_cast<float2*>(dst + 8 * ms) =
            make_float2(sqrtf(a[2] * a[2] + c[2] * c[2]), sqrtf(a[3] * a[3] + c[3] * c[3]));
      }
  }
  __syncthreads();

  // 3. Mel product in f32 on the CUDA cores and the log: a thread owns mel
  //    bin m for R consecutive frames; the padded bins have zero magnitude
  //    and zero weight. The filterbank is copied into the space the frames
  //    and the rings held, jc bins at a time (all of it at 16 kHz), so its
  //    reads are shared loads, not L2 round trips.
  float* wsm = xs;
  const int jc = min(np_, (BM * fs + kWarps * S * kNT * V * 32 * 4) / n_mel / 4 * 4);
  const bool active = threadIdx.x < 4 * n_mel;
  const int m = threadIdx.x % n_mel;
  const int f0 = (threadIdx.x / n_mel) * R;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int j0 = 0; j0 < np_; j0 += jc) {
    const int rows = min(jc, np_ - j0);
    if (j0 > 0) __syncthreads();  // the last chunk's reads are done
    {
      // rows is a multiple of 4, so the chunk is whole float4s
      const float4* src = reinterpret_cast<const float4*>(mel_w + j0 * n_mel);
      float4* dst = reinterpret_cast<float4*>(wsm);
      const int n4 = rows * n_mel / 4;
      for (int q = threadIdx.x; q < n4; q += 4 * kThreads) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (q + u * kThreads < n4) v[u] = __ldg(src + q + u * kThreads);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (q + u * kThreads < n4) dst[q + u * kThreads] = v[u];
      }
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < rows; j += 4) {
        const float w0 = wsm[(j + 0) * n_mel + m];
        const float w1 = wsm[(j + 1) * n_mel + m];
        const float w2 = wsm[(j + 2) * n_mel + m];
        const float w3 = wsm[(j + 3) * n_mel + m];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(mag + (f0 + r) * ms + j0 + j);
          acc[r] = fmaf(v.x, w0, acc[r]);
          acc[r] = fmaf(v.y, w1, acc[r]);
          acc[r] = fmaf(v.z, w2, acc[r]);
          acc[r] = fmaf(v.w, w3, acc[r]);
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = t0 + f0 + r;
      if (t < used_frames)
        out[(static_cast<int64_t>(b) * used_frames + t) * n_mel + m] =
            logf(acc[r] + log_offset);
    }
  }
}

template <int MODE, int MF>
cudaError_t launch_mma(const float* wav, const void* basis, const float* mel_w, float* out,
                       int batch, int n_samples, int used_frames, int window, int kp, int hop,
                       int np_, int n_mel, float log_offset, cudaStream_t stream) {
  constexpr int BM = 16 * MF;
  constexpr int V = MODE == kBf16 ? 1 : 2;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(BM) * (kp + (MODE == kF32 ? 4 : 8) + np_ + 8) +
      sizeof(uint4) * kWarps * ring_stages<MODE>() * kNT * V * 32;
  cudaError_t err = set_smem(fused_log_mel_mma_kernel<MODE, MF>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((used_frames + BM - 1) / BM, batch);
  fused_log_mel_mma_kernel<MODE, MF><<<grid, kThreads, smem, stream>>>(
      wav, static_cast<const uint4*>(basis), mel_w, out, n_samples, used_frames, window, kp,
      hop, np_, n_mel, log_offset);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mma_bm(int bm, const float* wav, const void* basis, const float* mel_w,
                          float* out, int batch, int n_samples, int used_frames, int window,
                          int kp, int hop, int np_, int n_mel, float log_offset,
                          cudaStream_t s) {
  switch (bm) {
    case 16:
      return launch_mma<MODE, 1>(wav, basis, mel_w, out, batch, n_samples, used_frames,
                                 window, kp, hop, np_, n_mel, log_offset, s);
    case 32:
      return launch_mma<MODE, 2>(wav, basis, mel_w, out, batch, n_samples, used_frames,
                                 window, kp, hop, np_, n_mel, log_offset, s);
    case 64:
      return launch_mma<MODE, 4>(wav, basis, mel_w, out, batch, n_samples, used_frames,
                                 window, kp, hop, np_, n_mel, log_offset, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes. Returns a cudaError_t (0 = launched).
// mode is 0 = "highest" (f32 / 3xTF32), 1 = "default" (one bf16 pass),
// 2 = "bf16x3". kp (taps) and np (bins) are the packed basis's padded sizes,
// multiples of 16; bm is the frame tile, 16, 32 or 64.
extern "C" int mla_fused_log_mel_mma(const float* wav, const void* basis, const float* mel_w,
                                     float* out, int batch, int n_samples, int used_frames,
                                     int window, int kp, int hop, int np_, int n_mel,
                                     float log_offset, int mode, int bm, void* stream) {
  if (kp % 16 != 0 || np_ % 16 != 0 || kp < window || n_mel < 1 || 4 * n_mel > kThreads ||
      batch < 1 ||
      used_frames < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32:
      return launch_mma_bm<kF32>(bm, wav, basis, mel_w, out, batch, n_samples, used_frames,
                                 window, kp, hop, np_, n_mel, log_offset, s);
    case kBf16:
      return launch_mma_bm<kBf16>(bm, wav, basis, mel_w, out, batch, n_samples, used_frames,
                                  window, kp, hop, np_, n_mel, log_offset, s);
    case kBf16x3:
      return launch_mma_bm<kBf16x3>(bm, wav, basis, mel_w, out, batch, n_samples,
                                    used_frames, window, kp, hop, np_, n_mel, log_offset, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
