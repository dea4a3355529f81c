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
// What bounds it on this card: bytes, and the serial chain. Each wire byte
// is read once and each sample written once as f32:
//   serving  [8, 77120], block 64:   337,400 wire bytes in + 2,467,840 out,
//            0.84 us at 3.35 TB/s;
//   training [64, 64000], block 256: 2,096,000 + 16,384,000 bytes, 5.5 us.
// The arithmetic (~15 integer operations per sample) is negligible. Beside
// the bytes, every block is a chain of 64 (serving) or 256 (training)
// dependent steps, which no amount of parallelism over blocks hides.
//
// What the design does about it: one thread per self-contained wire block
// (the blocks are independent by construction), a warp per 32 consecutive
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
