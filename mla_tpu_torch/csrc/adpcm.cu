// ADPCM wire decode for Hopper (sm_90a): the adpcm4 and adpcm2 block wires
// (mla_tpu_torch/data/adpcm.py has the layout) -> float32 samples.
//
// Replaces no Pallas kernel. The JAX package decodes these wires on its
// device with a lax.scan over the samples of a block (mla_tpu/data/adpcm.py:
// _decode_jnp for 4-bit codes, _decode2_jnp for 2-bit); written as eager
// torch ops that scan would be several hundred small launches per serving
// tick, so the port decodes in this one kernel. It computes the same
// function: each block's (pred, index) state is carried through its codes in
// exact int32 arithmetic, and every output is pred / 32768, exact in f32, so
// the kernel, its plain torch version (ops/adpcm.py) and the JAX decoders
// agree bit for bit.
//
// What bounds it on this card: the bytes, and in practice the integer
// issue rate. Each wire byte is read once and each sample written once as
// f32:
//   serving  [8, 77120], block 64:   337,400 wire bytes in + 2,467,840 out,
//            0.84 us at 3.35 TB/s;
//   training [64, 64000], block 256: 2,096,000 + 16,384,000 bytes, 5.5 us.
// Two kernels compute the same function. The wrapper picks one from the
// codes' width and the block (ops/adpcm.py::decode_variant), by what each
// measured on an H100 (PERF.md): the scan kernel for 4-bit codes in blocks
// of 256 (the training staging), where it beat the serial one by 8%; the
// serial kernel for every other wire, the serving wires among them (block
// 64, 4-bit: within 1% of the scan from device memory, 7% faster from the
// L2 cache, where a tick's just-uploaded wire is; 2-bit: 12% faster).
//
// adpcm_decode_scan. Both state updates are
// clamped adds, maps x -> min(max(x + a, lo), hi), and those are closed under
// composition: (a1, l1, h1) then (a2, l2, h2) is exactly (a1 + a2,
// clamp(l1 + a2, l2, h2), clamp(h1 + a2, l2, h2)) in int32. So a block's
// index chain and then its predictor chain are each a prefix scan. A block
// is decoded by `width` lanes of one warp (a power of two >= block / kK, at
// most 32), each owning kK consecutive samples: a lane composes its kK maps,
// a segmented __shfl_up scan joins the lanes in log2(width) rounds, and the
// lane walks its kK samples from the state its left neighbour ends in. The
// index scan runs first (it needs the codes alone), then each sample's
// signed delta comes from a shared [step index][code] table, then the
// predictor scan. The sample order of the integer function is unchanged,
// so the decode stays bit-exact. At kK 16 (the fastest of 4, 8 and 16 at
// both sites, PERF.md) a serving block takes 4 lanes, 8 blocks a warp, 1,205 warps; a training block 16
// lanes, 2 blocks a warp, 8,000 warps; against one lane per block in the
// serial kernel (302 and 500 warps, 4 of 64 warp slots per SM). The grid is
// what the SMs hold at once; each warp walks its blocks through a ring of
// shared-memory slots that per-lane 16-byte cp.async copies of the wire's
// aligned span fill four steps ahead. A lane's samples are 64 contiguous
// bytes, so its own float4 stores would scatter a warp's store over 2 KB;
// where every sample of the step is kept, the warp passes them through a
// swizzled shared tile and each segment's lanes store consecutive float4s.
// A block longer than 32 kK samples is decoded in passes of 32 kK, the state
// carried from pass to pass.
// What holds it back (measured on an H100 by launching it without its scans
// or its stores and stamping its clock; PERF.md has the figures): composing
// two clamped maps per sample and the scan rounds are about twice the serial
// decode's integer operations, which issue at half the FP32 rate, so the
// training site is bound by integer issue, not by bytes; each launch also
// waits ~1 us on its first global load (the step table) before its barrier,
// which at the serving site is a large share of a few-us kernel.
//
// adpcm_decode, the serial kernel: one thread per self-contained wire block
// (the blocks are independent by construction), a chain of `block`
// dependent steps that no parallelism over blocks hides, a warp per 32 consecutive
// blocks, which are one contiguous span of the wire. The step table sits in
// shared memory (the lookup's index differs per lane, which would serialise
// a __constant__ read). A warp goes through its blocks in chunks of 32
// samples:
// - it stages the chunk's code bytes of all its blocks in shared memory;
//   neighbouring lanes load neighbouring bytes, all of a chunk's loads are in
//   flight at once, and the next chunk's are issued before this one decodes;
// - each lane decodes its block's 32 samples into a shared tile in two
//   chains: the step index depends on the codes alone, so the index chain
//   and its table lookups run first, and the predictor's chain that follows
//   is an add and a clamp per sample, with no memory access in it;
// - the warp writes the tile out one block at a time, 32 consecutive floats
//   per store, so every store is coalesced although each lane owns a block.
// Both pitches are chosen so that no two lanes of a warp hit the same
// shared-memory bank. One template parameter selects 4- or 2-bit codes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                // warps per thread block
constexpr int kChunk = 32;               // samples a lane decodes between two stores
constexpr int kTilePitch = kChunk + 1;   // floats per staged row of samples
constexpr int kCodePitch = 20;           // bytes per staged row of codes: 5 words, odd
constexpr int kTable = 256;              // the header's index is a byte

// IMA/DVI step sizes; a header index past 88 reads 0, as the JAX decoders'
// one-hot lookup gives (valid wires never carry one). In global memory: the
// copy into shared memory reads it with consecutive lanes on consecutive
// words, which a __constant__ read would serialise.
__device__ const int kStepTable[89] = {
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767};

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) { return min(max(v, lo), hi); }

// One chunk's code bytes of the warp's `count` blocks into registers: lane l
// holds bytes t * 32 + l of the [count, kChunkBytes] slice, all loads issued
// before any is used, so a chunk costs one memory latency, not kChunkBytes.
template <int kBits>
__device__ __forceinline__ void load_chunk(const uint8_t* src, int64_t wb, int count, int off,
                                           int nbytes, int lane,
                                           uint32_t (&v)[kChunk * kBits / 8]) {
  constexpr int kChunkBytes = kChunk * kBits / 8;
#pragma unroll
  for (int t = 0; t < kChunkBytes; ++t) {
    const int k = t * 32 + lane, b = k / kChunkBytes, byte = k % kChunkBytes;
    v[t] = b < count && byte < nbytes ? src[b * wb + off + byte] : 0u;
  }
}

// wire: `units` blocks of `block` samples, each unit [codes | pred0 lo, hi |
// index0]; the units of a row follow each other, and the rows too, so unit u
// starts at byte u * wb. out: [units / nb, n], the first n samples of each
// row's nb * block.
template <int kBits>
__global__ void __launch_bounds__(kWarps * 32) adpcm_decode(
    const uint8_t* __restrict__ wire, float* __restrict__ out, int64_t units, int nb,
    int block, int n) {
  constexpr int kChunkBytes = kChunk * kBits / 8;  // code bytes of one chunk of a block
  constexpr int kMask = (1 << kBits) - 1;
  __shared__ int s_step[kTable];
  __shared__ uint8_t s_codes[kWarps][32 * kCodePitch];
  __shared__ float s_tile[kWarps][32 * kTilePitch];

  for (int i = threadIdx.x; i < kTable; i += blockDim.x) s_step[i] = i < 89 ? kStepTable[i] : 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * 32;
  if (first >= units) return;  // no block-wide barrier follows
  const int count = units - first < 32 ? static_cast<int>(units - first) : 32;
  const int cb = block * kBits / 8;  // code bytes per unit
  const int64_t wb = cb + 3;
  const uint8_t* src = wire + first * wb;

  uint32_t v[kChunkBytes];  // the next chunk's code bytes, in flight
  load_chunk<kBits>(src, wb, count, 0, (block < kChunk ? block : kChunk) * kBits / 8, lane, v);
  // this lane's block: the start state from its header, the int16 predictor
  // rebuilt from its little-endian byte pair with the sign taken explicitly
  int pred = 0, index = 0;
  if (lane < count) {
    const uint8_t* h = src + lane * wb + cb;
    pred = h[0] | (h[1] << 8);
    pred -= (pred >= 32768) * 65536;
    index = h[2];
  }

  // where this lane's block lands in out, and how many of its samples are
  // kept (the last block of a row may run past n); the warp's stores read
  // both for each block by shuffle
  const int64_t unit = first + lane, row = unit / nb;
  const int j = static_cast<int>(unit - row * nb);
  const int64_t my_base = row * n + static_cast<int64_t>(j) * block;
  const int my_keep = n - j * block;
  uint8_t* codes = s_codes[warp];
  float* tile = s_tile[warp];
  for (int c0 = 0; c0 < block; c0 += kChunk) {
    const int cn = block - c0 < kChunk ? block - c0 : kChunk;
#pragma unroll
    for (int t = 0; t < kChunkBytes; ++t) {
      const int k = t * 32 + lane;
      codes[k / kChunkBytes * kCodePitch + k % kChunkBytes] = static_cast<uint8_t>(v[t]);
    }
    __syncwarp();
    const int c1 = c0 + kChunk;
    if (c1 < block)
      load_chunk<kBits>(src, wb, count, c1 * kBits / 8,
                        (block - c1 < kChunk ? block - c1 : kChunk) * kBits / 8, lane, v);
    if (lane < count) {
      // Past cn (a block's last, partial chunk) the codes are stale bytes and
      // the state runs on, but nothing reads it: the stores stop at cn.
      const uint8_t* mine = codes + lane * kCodePitch;
      int code[kChunk], step[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i)
        code[i] = (mine[i * kBits / 8] >> ((i * kBits) & 7)) & kMask;
      // the step index follows the codes alone, so its chain and the table
      // lookups run ahead of the predictor's
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        step[i] = s_step[index];
        const int m = code[i] & (kBits == 4 ? 7 : 1);
        const int adapt = kBits == 4 ? (m < 4 ? -1 : 2 * m - 6) : (m ? 2 : -1);
        index = clamp_int(index + adapt, 0, 88);
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int c = code[i], st = step[i];
        int delta;
        if (kBits == 4)
          delta = (st >> 3) + (c & 4 ? st : 0) + (c & 2 ? st >> 1 : 0) + (c & 1 ? st >> 2 : 0);
        else
          delta = (st >> 1) + (c & 1 ? st : 0);
        const bool negative = kBits == 4 ? (c & 8) : (c & 2);
        pred = clamp_int(pred + (negative ? -delta : delta), -32768, 32767);
        tile[lane * kTilePitch + i] = __int2float_rn(pred) * (1.0f / 32768.0f);
      }
    }
    __syncwarp();
    // unrolled, so the 32 shared loads and global stores are all in flight
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const int64_t base = __shfl_sync(0xffffffffu, static_cast<long long>(my_base), b);
      const int keep = __shfl_sync(0xffffffffu, my_keep, b);
      if (b < count && lane < cn && c0 + lane < keep)
        out[base + c0 + lane] = tile[b * kTilePitch + lane];
    }
    __syncwarp();
  }
}

// ---- the scan kernel ----

constexpr int kScanWarps = 8;  // warps per thread block
constexpr int kK = 16;         // samples per lane
constexpr int kRing = 4;       // steps a warp has in flight: its slots of shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnbounded = 1 << 30;  // the identity map's bounds: finite, so l + a cannot overflow

// x -> min(max(x + a, lo), hi), lo <= hi
struct ClampAdd {
  int a, lo, hi;
};

__device__ __forceinline__ ClampAdd identity_map() { return {0, -kUnbounded, kUnbounded}; }

// min(max(x + a, lo), hi) in two instructions: Hopper's DPX add-and-max
__device__ __forceinline__ int clamp_add(int x, int a, int lo, int hi) {
  return min(__viaddmax_s32(x, a, lo), hi);
}

// f, then g
__device__ __forceinline__ ClampAdd then(ClampAdd f, ClampAdd g) {
  return {f.a + g.a, clamp_add(f.lo, g.a, g.lo, g.hi), clamp_add(f.hi, g.a, g.lo, g.hi)};
}

__device__ __forceinline__ int apply(ClampAdd f, int x) { return clamp_add(x, f.a, f.lo, f.hi); }

// Inclusive scan over the `width` lanes of each segment (Hillis-Steele):
// lane i ends with the maps of lanes 0..i of its segment, in order.
__device__ __forceinline__ ClampAdd segment_scan(ClampAdd f, int seg_lane, int width) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d < width) {  // the same for the whole warp
      const ClampAdd g = {__shfl_up_sync(kFull, f.a, d, width),
                          __shfl_up_sync(kFull, f.lo, d, width),
                          __shfl_up_sync(kFull, f.hi, d, width)};
      if (seg_lane >= d) f = then(g, f);
    }
  }
  return f;
}

// The state entering this lane's samples, given the segment's start state x0
// and the lane's inclusive map: its left neighbour's end state.
__device__ __forceinline__ int lane_start(ClampAdd inclusive, int x0, int seg_lane, int width) {
  const int left = __shfl_up_sync(kFull, apply(inclusive, x0), 1, width);
  return seg_lane == 0 ? x0 : left;
}

// Where wire byte `off` lands in its slot: its offset in its 16-byte word.
__device__ __forceinline__ int slot_shift(const uint8_t* wire, int64_t off) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(wire) + static_cast<uintptr_t>(off)) & 15);
}

// Wire bytes [off, off + len) into a ring slot: lane l copies the 16-byte
// words l, l + 32, ... of their aligned cover with asynchronous copies, and
// every lane closes a commit group, copies or not. The cover may take up to 15
// bytes on either side of the wire's own, never more than the 16-byte words
// that hold its first and last byte: those words lie in the pages that hold
// the wire, so no copy can fault, and the bytes outside the wire are never
// read from the slot.
__device__ __forceinline__ void stage(const uint8_t* wire, int64_t off, int len, uint8_t* slot,
                                      int lane) {
  const int shift = slot_shift(wire, off), words = (shift + len + 15) >> 4;
  for (int w = lane; w < words; w += 32) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(slot + 16 * w));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(wire + off - shift + 16 * w)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This lane's kK codes, from `codes` (byte 0 of its block's codes in the
// pass, in shared memory) at sample s0. kGuard: the lane may hold fewer
// than kK samples (`valid`); the rest read as 0. Else its code bytes are
// read as aligned words joined by a funnel shift.
template <int kBits, bool kGuard>
__device__ __forceinline__ void read_codes(const uint8_t* codes, int s0, int valid,
                                           int (&code)[kK]) {
  constexpr int kMask = (1 << kBits) - 1;
  if (kGuard) {
#pragma unroll
    for (int t = 0; t < kK; ++t) {
      code[t] = 0;
      if (t < valid) {
        const int bit = (s0 + t) * kBits;
        code[t] = (codes[bit >> 3] >> (bit & 7)) & kMask;
      }
    }
  } else {
    constexpr int kPacked = (kK * kBits + 31) / 32;  // words of this lane's codes
    const uintptr_t at = reinterpret_cast<uintptr_t>(codes) + (s0 * kBits >> 3);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(at & ~static_cast<uintptr_t>(3));
    const int sh = static_cast<int>(at & 3) * 8;
    uint32_t raw[kPacked + 1];
#pragma unroll
    for (int q = 0; q <= kPacked; ++q) raw[q] = w[q];
#pragma unroll
    for (int t = 0; t < kK; ++t) {
      const uint32_t packed = __funnelshift_r(raw[t * kBits / 32], raw[t * kBits / 32 + 1], sh);
      code[t] = static_cast<int>(packed >> ((t * kBits) & 31)) & kMask;
    }
  }
}

// One pass of this lane's kK samples: the two scans and walks, the stores,
// and, for a block of several passes, the block's state after the pass
// into (index, pred). s_delta[x * kStride + code]: the signed delta of a
// code at step index x; s_adapt[code]: its step-index change. kGuard as for
// read_codes. coalesce (the same for the whole warp): every lane keeps all
// its kK samples at a 16-byte-aligned dst, so the warp's samples go out
// through `tile` (its kK floats per lane in shared memory) as float4 stores
// that a segment's lanes make to consecutive addresses.
template <int kBits, bool kGuard>
__device__ __forceinline__ void decode_pass(const int (&code)[kK], int valid, const int* s_delta,
                                            const int* s_adapt, int seg_lane, int width,
                                            bool carry, int& index, int& pred, float* dst,
                                            int count, bool coalesce, float* tile) {
  constexpr int kStride = kBits == 4 ? 17 : 5;  // words per row of s_delta
  // 1. the index scan: adapt(code) clamped to 0..88
  int adapt[kK];
  ClampAdd f = identity_map();
#pragma unroll
  for (int t = 0; t < kK; ++t) {
    adapt[t] = s_adapt[code[t]];
    if (!kGuard || t < valid) f = then(f, {adapt[t], 0, 88});
  }
  f = segment_scan(f, seg_lane, width);
  // 2. the walk: each sample's step index gives its signed delta
  int x = lane_start(f, index, seg_lane, width);
  int delta[kK];
  ClampAdd g = identity_map();
#pragma unroll
  for (int t = 0; t < kK; ++t) {
    delta[t] = s_delta[x * kStride + code[t]];
    x = clamp_add(x, adapt[t], 0, 88);
    if (!kGuard || t < valid) g = then(g, {delta[t], -32768, 32767});
  }
  // 3. the predictor scan, then the walk that gives each output: p / 32768
  // on the FP32 pipe, exactly (12582912 + p is exact in f32's 24 bits)
  g = segment_scan(g, seg_lane, width);
  int p = lane_start(g, pred, seg_lane, width);
  float v[kK];
#pragma unroll
  for (int t = 0; t < kK; ++t) {
    p = clamp_add(p, delta[t], -32768, 32767);
    v[t] = fmaf(__int_as_float(0x4B400000 + p), 1.0f / 32768.0f, -384.0f);
  }
  // the samples that out keeps: whole vectors where it can
  if (!kGuard && coalesce) {
    // lane l's float4 p sits in slot p ^ (l / kLanes128 % kParts) of its
    // row: the 8 lanes of each quarter-warp hit 8 distinct 16-byte bank
    // groups when they write a slot, and when they read a segment's
    // consecutive float4s back
    constexpr int kParts = kK / 4, kLanes128 = 8 / kParts;
    float4* t4 = reinterpret_cast<float4*>(tile);
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int p = 0; p < kParts; ++p)
      t4[lane * kParts + (p ^ (lane / kLanes128 % kParts))] =
          make_float4(v[4 * p], v[4 * p + 1], v[4 * p + 2], v[4 * p + 3]);
    __syncwarp();
    float4* seg_out = reinterpret_cast<float4*>(dst - seg_lane * kK);
#pragma unroll
    for (int q = 0; q < kParts; ++q) {
      const int m = q * width + seg_lane;  // the segment's float4 this lane stores
      const int src = lane - seg_lane + m / kParts, part = m % kParts;
      seg_out[m] = t4[src * kParts + (part ^ (src / kLanes128 % kParts))];
    }
    __syncwarp();  // the tile is written again next step
  } else if (count >= kK && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
    for (int t = 0; t < kK; t += 4)
      *reinterpret_cast<float4*>(dst + t) = make_float4(v[t], v[t + 1], v[t + 2], v[t + 3]);
  } else if (count >= kK && (reinterpret_cast<uintptr_t>(dst) & 7) == 0) {
#pragma unroll
    for (int t = 0; t < kK; t += 2)
      *reinterpret_cast<float2*>(dst + t) = make_float2(v[t], v[t + 1]);
  } else {
#pragma unroll
    for (int t = 0; t < kK; ++t)
      if (t < count) dst[t] = v[t];
  }
  // the block's state after the pass: the segment's last lane ends in it
  // (lanes past the block's end hold the identity map)
  if (carry) {
    index = __shfl_sync(kFull, apply(f, index), width - 1, width);
    pred = __shfl_sync(kFull, apply(g, pred), width - 1, width);
  }
}

// wire, out, units, nb, block, n: as adpcm_decode. A block is decoded by
// `width` lanes (a power of two, at most 32, at least block / kK unless the
// block takes several 32 * kK-sample passes), 32 / width blocks per warp: a
// warp's task. The grid is at most what the SMs hold at once; each warp
// walks its tasks (and a long block's passes) in steps, through a ring of
// kRing slots that asynchronous copies fill kRing steps ahead.
template <int kBits>
__global__ void __launch_bounds__(kScanWarps * 32, 3) adpcm_decode_scan(
    const uint8_t* __restrict__ wire, float* __restrict__ out, int64_t units, int nb,
    int block, int n, int width) {
  constexpr int kStride = kBits == 4 ? 17 : 5;  // words per row of s_delta: odd, over all banks
  constexpr int kCodes = 1 << kBits;
  constexpr int kPassBytes = 32 * kK * kBits / 8;  // code bytes of one 32-lane pass
  // a step's bytes: its blocks' code bytes (at most one pass), their headers
  // (at most 32 x 3), the offset into the first word and the last word's tail
  constexpr int kSlot = (kPassBytes + 96 + 32 + 15) / 16 * 16;
  static_assert(kScanWarps * 32 == kTable, "one thread per row of s_delta");
  __shared__ int s_delta[kTable * kStride];
  __shared__ int s_adapt[kCodes];  // a code's step-index change
  __shared__ __align__(16) float s_tile[kScanWarps][32 * kK];  // a warp's samples, for its stores
  __shared__ __align__(128) uint8_t s_ring[kScanWarps][kRing][kSlot];

  // thread x builds row x of the delta table from step size x: one
  // coalesced load, issued first
  const int st = threadIdx.x < 89 ? kStepTable[threadIdx.x] : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = 32 / width, seg = lane / width, seg_lane = lane % width;
  const int cb = block * kBits / 8;
  const int64_t wb = cb + 3;
  const int pass = width * kK;  // samples per pass
  const int passes = (block + pass - 1) / pass;
  const bool one_pass = passes == 1;
  const int64_t tasks = (units + per_warp - 1) / per_warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kScanWarps;
  // task t goes to warp t % stride, thread block fastest: the tasks that
  // do not divide evenly land on every SM alike, not on the first few
  const int64_t task0 = static_cast<int64_t>(warp) * gridDim.x + blockIdx.x;

  // step i of this warp: pass i % passes of task task0 + (i / passes) *
  // stride, in slot i % kRing. Its bytes: in one pass the task's blocks,
  // headers included; else the block's codes of the pass.
  auto step_bytes = [&](int i, int64_t& off, int& len) {
    const int q = one_pass ? i : i / passes;
    const int64_t t = task0 + q * stride;
    if (t >= tasks) return;
    if (one_pass) {
      const int64_t u0 = t * per_warp;
      off = u0 * wb;
      len = static_cast<int>((units - u0 < per_warp ? units - u0 : per_warp) * wb);
    } else {
      const int c0 = (i - q * passes) * pass;
      off = t * wb + c0 * kBits / 8;
      len = (block - c0 < pass ? block - c0 : pass) * kBits / 8;
    }
  };
  auto fetch = [&](int i) {
    int64_t off = 0;
    int len = 0;
    step_bytes(i, off, len);  // len 0 past the warp's last step: an empty group
    stage(wire, off, len, s_ring[warp][i % kRing], lane);
  };

#pragma unroll
  for (int r = 0; r < kRing; ++r) fetch(r);  // in flight while the table is built
  {  // row x: every code's signed delta at step index x, 0 past 88 (as the
     // JAX decoders' one-hot lookup gives); each magnitude's delta is an
     // earlier one's plus one term
    const int x = threadIdx.x;
    constexpr int kHalf = kCodes / 2;  // the magnitudes; the sign bit is kHalf
    int d[kHalf];
    if (kBits == 4) {
      d[0] = st >> 3;
      d[1] = d[0] + (st >> 2);
      d[2] = d[0] + (st >> 1);
      d[3] = d[1] + (st >> 1);
#pragma unroll
      for (int m = 4; m < kHalf; ++m) d[m] = d[m - 4] + st;
    } else {
      d[0] = st >> 1;
      d[1 % kHalf] = d[0] + st;
    }
    int* row = s_delta + x * kStride;
#pragma unroll
    for (int m = 0; m < kHalf; ++m) {
      row[m] = d[m];
      row[kHalf + m] = -d[m];
    }
  }
  if (threadIdx.x < kCodes) {
    const int m = threadIdx.x & (kCodes / 2 - 1);  // the magnitude
    s_adapt[threadIdx.x] = kBits == 4 ? (m < 4 ? -1 : 2 * m - 6) : 3 * m - 1;
  }
  __syncthreads();  // the last block-wide barrier: a warp may leave once its tasks are done

  // this lane's block is block j of row `row` of out, and moves on by
  // `stride` tasks, (step_rows, step_j), from one task to the next
  const int s0 = seg_lane * kK;  // this lane's first sample within a pass
  const int64_t unit0 = task0 * per_warp + seg, step_units = stride * per_warp;
  const bool small = unit0 <= 0x7fffffff && step_units <= 0x7fffffff;  // 32-bit divisions
  int64_t row = small ? static_cast<uint32_t>(unit0) / static_cast<uint32_t>(nb) : unit0 / nb;
  int j = static_cast<int>(unit0 - row * nb);
  const int64_t step_rows =
      small ? static_cast<uint32_t>(step_units) / static_cast<uint32_t>(nb) : step_units / nb;
  const int step_j = static_cast<int>(step_units - step_rows * nb);
  int i = 0;  // this warp's step
  for (int64_t task = task0; task < tasks; task += stride) {
    const int64_t unit = task * per_warp + seg;
    const bool live = unit < units;  // a segment past the last block computes and stores nothing
    // where this block lands in out; the last block of a row may run past n
    const int64_t base = row * n + static_cast<int64_t>(j) * block;
    const int keep = n - j * block;
    int pred = 0, index = 0;  // the block's state entering the pass

    for (int c0 = 0; c0 < block; c0 += pass, ++i) {
      const int r = i % kRing;
      // step i's group is done once no more than the kRing - 1 after it are
      // pending, for this lane's copies; the __syncwarp, for every lane's
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
      __syncwarp();
      const uint8_t* codes =
          one_pass ? s_ring[warp][r] + slot_shift(wire, task * per_warp * wb) + seg * wb
                   : s_ring[warp][r] + slot_shift(wire, task * wb + c0 * kBits / 8);
      if (c0 == 0 && live) {
        // the start state from the header, the int16 predictor rebuilt from
        // its little-endian byte pair with the sign taken explicitly
        const uint8_t* h = one_pass ? codes + cb : wire + unit * wb + cb;
        pred = h[0] | (h[1] << 8);
        pred -= (pred >= 32768) * 65536;
        index = h[2];
      }
      const int valid = live ? block - c0 - s0 : 0;  // this lane's samples in the block (if < kK)
      const bool whole = __all_sync(kFull, valid >= kK);  // no lane of the warp needs a guard
      int code[kK];
      if (whole)
        read_codes<kBits, false>(codes, s0, valid, code);
      else
        read_codes<kBits, true>(codes, s0, valid, code);
      __syncwarp();  // every lane has read slot r: refill it kRing steps ahead
      fetch(i + kRing);

      const int room = keep - c0 - s0, count = valid < room ? valid : room;
      float* dst = out + base + c0 + s0;
      const bool coalesce =
          __all_sync(kFull, count >= kK && (reinterpret_cast<uintptr_t>(dst) & 15) == 0);
      if (whole)
        decode_pass<kBits, false>(code, valid, s_delta, s_adapt, seg_lane, width, !one_pass,
                                  index, pred, dst, count, coalesce, s_tile[warp]);
      else
        decode_pass<kBits, true>(code, valid, s_delta, s_adapt, seg_lane, width, !one_pass,
                                 index, pred, dst, count, coalesce, s_tile[warp]);
    }
    row += step_rows;
    j += step_j;
    if (j >= nb) j -= nb, ++row;
  }
}

// The thread blocks one launch of a scan kernel takes: one per group of
// kScanWarps tasks, at most as many as the card's SMs hold at once.
template <int kBits>
int launch_scan(const uint8_t* wire, float* out, int64_t units, int nb, int block, int n,
                int width, int64_t groups, cudaStream_t s) {
  static int resident = 0;  // per instance: thread blocks the whole card holds at once
  if (resident == 0) {
    int per_sm = 0, sms = 0, dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, adpcm_decode_scan<kBits>, kScanWarps * 32, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm * sms <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident = per_sm * sms;
  }
  const int grid = static_cast<int>(groups < resident ? groups : resident);
  adpcm_decode_scan<kBits><<<grid, kScanWarps * 32, 0, s>>>(wire, out, units, nb, block, n,
                                                            width);
  return static_cast<int>(cudaGetLastError());
}

// The scan kernel's checks (those of mla_adpcm_decode), geometry and launch.
int decode_scan(const uint8_t* wire, float* out, int64_t units, int nb, int block, int n,
                int bits, void* stream) {
  if ((bits != 4 && bits != 2) || block <= 0 || block % (8 / bits) || nb <= 0 || units <= 0 ||
      units % nb || n <= 0 || static_cast<int64_t>(n) > static_cast<int64_t>(nb) * block)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = (block + kK - 1) / kK;
  int width = 1;
  while (width < lanes && width < 32) width <<= 1;
  const int per_warp = 32 / width;
  const int64_t groups = ((units + per_warp - 1) / per_warp + kScanWarps - 1) / kScanWarps;
  auto s = static_cast<cudaStream_t>(stream);
  return bits == 4 ? launch_scan<4>(wire, out, units, nb, block, n, width, groups, s)
                   : launch_scan<2>(wire, out, units, nb, block, n, width, groups, s);
}

}  // namespace

// wire [rows, nb * (block * bits / 8 + 3)] uint8 -> out [rows, n] float32,
// with units = rows * nb. Returns a cudaError_t: the launch's, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int mla_adpcm_decode(const uint8_t* wire, float* out, int64_t units, int nb,
                                int block, int n, int bits, void* stream) {
  if ((bits != 4 && bits != 2) || block <= 0 || block % (8 / bits) || nb <= 0 || units <= 0 ||
      units % nb || n <= 0 || static_cast<int64_t>(n) > static_cast<int64_t>(nb) * block)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t grid = ((units + 31) / 32 + kWarps - 1) / kWarps;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    adpcm_decode<4><<<static_cast<int>(grid), kWarps * 32, 0, s>>>(wire, out, units, nb, block, n);
  else
    adpcm_decode<2><<<static_cast<int>(grid), kWarps * 32, 0, s>>>(wire, out, units, nb, block, n);
  return static_cast<int>(cudaGetLastError());
}

// The scan kernel, with the same arguments and checks.
extern "C" int mla_adpcm_decode_scan(const uint8_t* wire, float* out, int64_t units, int nb,
                                     int block, int n, int bits, void* stream) {
  return decode_scan(wire, out, units, nb, block, n, bits, stream);
}
