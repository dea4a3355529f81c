// The row-merge probe's kernels for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of scripts/probe_mosaic_reshape.py:
//   control_kernel  o = x * 2 (an elementwise control the TPU compiler was
//                   known to accept), here scale2_kernel;
//   kernel          the in-kernel row-merge reshape [960, 160] -> [320, 480]
//                   (3 rows -> 1) that Mosaic rejected, the capability whose
//                   absence made the TPU front-end build residue-class copies
//                   of the waveform; here row_merge_bulk (TMA bulk copies) where
//                   every copy can be 16-byte aligned, else row_merge_generic
//                   (one element per thread), both generic over the merge
//                   factor `rows` and the shape [R, C]:
//                     out[r, j * C + c] = x[rows * r + j, c].
//
// What bounds them on this card: bytes. Each reads its input once and writes
// its output once and does at most one multiply per element, so the bound is
// 2 * 4 * R * C / 3.35 TB/s: 0.367 us at [960, 160], 10.0 us at [4096, 1024],
// 160.3 us at [16384, 4096]. At the first shape the launch and one memory
// round trip are the time (~2.7 us for any kernel); at the second they are
// still a sixth of it; only the third shows the streaming rate. The first
// design (one 4-byte element per thread per pass, 64-bit index arithmetic,
// up to 132 x 16 blocks) lost to PyTorch's elementwise and copy kernels at
// both smaller shapes; it stays as row_merge_generic.
//
// What the design does about it (times: H100 80GB HBM3 at 700 W,
// chip_smoke.py and a launch-shape sweep; PERF.md has them all):
// - scale2: 16-byte evict-first accesses (__ldcs / __stcs on float4), kVecs
//   per thread, all loaded before any is stored. A scalar head brings x to a
//   16-byte boundary and a scalar tail finishes the last < 4 elements; where
//   out does not share x's alignment, each float4 is stored as four floats.
//   The sweep over threads (128-512) x vectors (1-4) x grid (capped at the
//   resident blocks, SM count x occupancy, or one pass) x hints chose 256
//   threads, one vector each, one pass: a capped grid walking the buffer
//   held every pair at ~0.83 of bound at [16384, 4096] against ~0.89 for
//   one pass, more vectors per thread only added time, and the evict-first
//   hint saved ~0.3 us at [960, 160] and ~0.8 us at [4096, 1024]. Then 2.7,
//   10.9 and 179.5 us, below torch.mul(x, 2) at all three shapes.
// - row_merge_bulk: the copy engine (TMA) moves source rows, one elected
//   thread per block issues the copies, and no register holds an element. A
//   work unit is a contiguous span of the output: whole output rows when they
//   fit in a stage, else one stage-sized piece of an output row. The unit is
//   filled by one cp.async.bulk load per source-row piece it covers, whose
//   source address and shared-memory offset come from (r, j, c): that is the
//   row merge. It is written back by one cp.async.bulk store. A block takes
//   consecutive units through a ring of kStages stages, so the loads of the
//   next units overlap the store of this one; how many units a block takes
//   follows the shape (launch_row_merge_bulk). The elected thread's control
//   path is the latency chain, so it divides nothing per copy (64-bit
//   divisions there cost ~0.8 us at [960, 160]). At [960, 160] a block's
//   launch and barrier setup (2.1 us), its TMA load round trip (0.8 us) and
//   its store (0.1 us) already exceed the library copy's whole 2.85 us, so
//   the kernel stays ~14% behind it there, ~2% at [4096, 1024] and at
//   [16384, 4096], where it reaches ~0.88 of bound.
//   Bulk copies need 16-byte-aligned addresses and sizes, so the kernel takes
//   C * 4 % 16 == 0 with both pointers 16-byte aligned; the Python wrapper
//   chooses the variant by shape (row_merge_variant), never on failure.
// - row_merge_generic: the first element kernel, for every other case (an
//   odd C, a view that starts inside a 16-byte word).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// scale2: threads per block, float4s per thread and grid cap in waves of
// resident blocks (0: none), from the launch-shape sweep (PERF.md)
constexpr int kScale2Threads = 256;
constexpr int kScale2Vecs = 1;
constexpr int kScale2Waves = 0;
// row_merge_bulk: ring depth and stage size (swept over 4-8 stages x 8-32 KB)
constexpr int kStages = 4;
constexpr int kStageBytes = 16 * 1024;
constexpr int kGenericThreads = 256;
constexpr int kGenericMaxBlocks = 132 * 16;

int sm_count() {
  static int sms = 0;  // read once
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// ---------------------------------------------------------------- scale2

// 16-byte loads and stores, with the evict-first hint (kStream) or without
template <bool kStream>
__device__ __forceinline__ float4 load4(const float4* p) {
  return kStream ? __ldcs(p) : *p;
}
template <bool kStream>
__device__ __forceinline__ void store1(float* p, float v) {
  if (kStream) __stcs(p, v); else *p = v;
}
template <bool kStream>
__device__ __forceinline__ void store4(float4* p, float4 v) {
  if (kStream) __stcs(p, v); else *p = v;
}

template <int kThreads, int kVecs, bool kVecStore, bool kStream>
__global__ void __launch_bounds__(kThreads)
scale2_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t n, int head,
              int64_t nvec) {
  if (blockIdx.x == 0) {  // the scalar head (< 4) and tail (< 4)
    if (static_cast<int>(threadIdx.x) < head)
      store1<kStream>(out + threadIdx.x, x[threadIdx.x] * 2.0f);
    const int64_t t = head + 4 * nvec + threadIdx.x;
    if (threadIdx.x < 4 && t < n) store1<kStream>(out + t, x[t] * 2.0f);
  }
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  float* o = out + head;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; base < nvec;
       base += stride * kVecs) {
    float4 v[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k)
      if (base + k * stride < nvec) v[k] = load4<kStream>(xv + base + k * stride);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int64_t i = base + k * stride;
      if (i >= nvec) break;
      const float4 y = make_float4(v[k].x * 2.0f, v[k].y * 2.0f, v[k].z * 2.0f, v[k].w * 2.0f);
      if (kVecStore) {
        store4<kStream>(reinterpret_cast<float4*>(o) + i, y);
      } else {
        store1<kStream>(o + 4 * i, y.x);
        store1<kStream>(o + 4 * i + 1, y.y);
        store1<kStream>(o + 4 * i + 2, y.z);
        store1<kStream>(o + 4 * i + 3, y.w);
      }
    }
  }
}

// waves: at most waves x the resident blocks of the card (0: no cap, one
// pass of kThreads x kVecs vectors per block)
template <int kThreads, int kVecs, bool kStream>
int launch_scale2(const float* x, float* out, int64_t n, int waves, cudaStream_t stream) {
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if (n < 1 || xa % 4 || reinterpret_cast<uintptr_t>(out) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t to_boundary = static_cast<int64_t>((16 - xa % 16) % 16 / 4);
  const int head = static_cast<int>(to_boundary < n ? to_boundary : n);
  const int64_t nvec = (n - head) / 4;
  const bool vec_store = reinterpret_cast<uintptr_t>(out + head) % 16 == 0;
  int64_t blocks = (nvec + kThreads * kVecs - 1) / (kThreads * kVecs);
  if (waves > 0) {
    static int per_sm = 0;  // resident blocks per SM, read once
    if (per_sm == 0) {
      cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, scale2_kernel<kThreads, kVecs, true, kStream>, kThreads, 0);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int64_t cap = static_cast<int64_t>(sm_count()) * per_sm * waves;
    if (blocks > cap) blocks = cap;
  }
  if (blocks < 1) blocks = 1;
  if (vec_store)
    scale2_kernel<kThreads, kVecs, true, kStream>
        <<<static_cast<int>(blocks), kThreads, 0, stream>>>(x, out, n, head, nvec);
  else
    scale2_kernel<kThreads, kVecs, false, kStream>
        <<<static_cast<int>(blocks), kThreads, 0, stream>>>(x, out, n, head, nvec);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- row_merge_bulk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// x [R, C] -> out [R / rows, rows * C], all in bytes below: rb = one output
// row, cb = one source row. With pieces == 1, unit u is output rows
// [u * unit_rows, ...) (at most unit_rows, within one stage); otherwise it is
// piece u % pieces, one stage long or the row's rest, of output row
// u / pieces. Block b takes units [b * per_block, ...) in order, through a
// ring of kRing stages.
template <int kRing>
__global__ void __launch_bounds__(32)
row_merge_bulk(const char* __restrict__ x, char* __restrict__ out, int64_t out_rows, int64_t cb,
               int64_t rows, int64_t unit_rows, int64_t pieces, int64_t n_units,
               int64_t per_block, int stage) {
  static_assert(kRing >= 2, "a stage is refilled while the next one is stored");
  extern __shared__ __align__(128) char ring[];
  __shared__ __align__(8) uint64_t full[kRing];
  if (threadIdx.x != 0) return;  // one elected thread drives the copy engine
  const int64_t rb = rows * cb;
  const uint32_t ring0 = smem_u32(ring);
#pragma unroll
  for (int s = 0; s < kRing; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  // unit i of this block: output bytes [u0, u1), from byte cbyte of part j
  // of output row r0 (part j of output row r is source row rows * r + j)
  struct Unit { int64_t r0, j, cbyte, u0, u1; };
  const int64_t first = blockIdx.x * per_block;
  auto unit = [&](int64_t i) {
    const int64_t u = first + i;
    Unit t;
    if (pieces == 1) {
      t.r0 = u * unit_rows;
      t.j = t.cbyte = 0;
      t.u0 = t.r0 * rb;
      t.u1 = (t.r0 + unit_rows < out_rows ? t.r0 + unit_rows : out_rows) * rb;
    } else {  // a piece starts inside a row: two divisions per unit of a stage's bytes
      t.r0 = u / pieces;
      const int64_t b0 = (u - t.r0 * pieces) * stage;
      t.j = b0 / cb;
      t.cbyte = b0 - t.j * cb;
      t.u0 = t.r0 * rb + b0;
      t.u1 = t.u0 + stage < (t.r0 + 1) * rb ? t.u0 + stage : (t.r0 + 1) * rb;
    }
    return t;
  };
  auto load = [&](int64_t i, int s) {
    const Unit t = unit(i);
    const uint32_t bar = smem_u32(&full[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(static_cast<uint32_t>(t.u1 - t.u0))
                 : "memory");
    // one bulk copy per source-row piece; (r, j, cbyte) step forward with
    // the output byte o, so the loop divides nothing
    int64_t r = t.r0, j = t.j, cbyte = t.cbyte;
    for (int64_t o = t.u0; o < t.u1;) {
      const int64_t len = cb - cbyte < t.u1 - o ? cb - cbyte : t.u1 - o;
      const char* src = x + (rows * r + j) * cb + cbyte;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(ring0 + static_cast<uint32_t>(s * stage + (o - t.u0))),
          "l"(reinterpret_cast<uint64_t>(src)), "r"(static_cast<uint32_t>(len)), "r"(bar)
          : "memory");
      o += len;
      cbyte = 0;
      if (++j == rows) j = 0, ++r;
    }
  };

  const int64_t mine = n_units - first < per_block ? n_units - first : per_block;
  for (int64_t i = 0; i < mine && i < kRing; ++i) load(i, static_cast<int>(i));
  for (int64_t i = 0; i < mine; ++i) {
    const int s = static_cast<int>(i % kRing);
    mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>((i / kRing) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const Unit t = unit(i);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                     reinterpret_cast<uint64_t>(out + t.u0)),
                 "r"(ring0 + static_cast<uint32_t>(s * stage)),
                 "r"(static_cast<uint32_t>(t.u1 - t.u0))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // refill the previous unit's stage once its store has read it (the store
    // just issued may still be reading this one)
    if (i >= 1 && i - 1 + kRing < mine) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(i - 1 + kRing, static_cast<int>((i - 1) % kRing));
    }
  }
  // no store may still be reading shared memory when the block exits
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// per_block: units per block, or 0 for the rule swept on an H100: one unit
// per block while the units fit one wave of resident blocks (the time is one
// load-then-store round trip); else one block per SM while that is at most
// two turns of the ring (one wave, each SM streaming through its ring); else
// one ring's worth per block (short blocks, started in address order, keep
// the addresses in flight close together). A block that takes fewer units
// than kRing gets only their stages.
template <int kRing>
int launch_row_merge_bulk(const float* x, float* out, int64_t r_in, int64_t c_in, int64_t rows,
                          int stage, int64_t per_block, cudaStream_t stream) {
  const int64_t cb = 4 * c_in, rb = rows * cb, out_rows = r_in / rows;
  if (cb % 16 || stage % 16 || stage < 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  static int set_stage = 0, per_sm = 0;  // resident blocks per SM, for the last stage size
  if (set_stage != stage) {
    cudaError_t err = cudaFuncSetAttribute(
        row_merge_bulk<kRing>, cudaFuncAttributeMaxDynamicSharedMemorySize, kRing * stage);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_merge_bulk<kRing>, 32,
                                                          kRing * stage);
    if (err != cudaSuccess) return static_cast<int>(err);
    set_stage = stage;
  }
  const int64_t resident = static_cast<int64_t>(sm_count()) * per_sm;
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int64_t unit_rows = 1, pieces = 1;
  if (rb <= stage) {  // whole rows per unit: enough units to fill the card, each within a stage
    unit_rows = (out_rows + resident - 1) / resident;
    if (unit_rows > stage / rb) unit_rows = stage / rb;
  } else {  // stage-sized pieces of one output row
    pieces = (rb + stage - 1) / stage;
  }
  const int64_t n_units = (out_rows + unit_rows - 1) / unit_rows * pieces;
  if (per_block < 1) {
    const int64_t one_per_sm = (n_units + sm_count() - 1) / sm_count();
    per_block = n_units <= resident ? 1 : one_per_sm <= 2 * kRing ? one_per_sm : kRing;
  }
  const int64_t blocks = (n_units + per_block - 1) / per_block;
  const int smem = static_cast<int>(per_block < kRing ? per_block : kRing) * stage;
  row_merge_bulk<kRing><<<static_cast<int>(blocks), 32, smem, stream>>>(
      reinterpret_cast<const char*>(x), reinterpret_cast<char*>(out), out_rows, cb, rows,
      unit_rows, pieces, n_units, per_block, stage);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------- row_merge_generic

// x [R, C] -> out [R / rows, rows * C], one element per thread per pass
__global__ void row_merge_generic(const float* __restrict__ x, float* __restrict__ out,
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

bool bad_merge(int64_t r_in, int64_t c_in, int64_t rows) {
  return r_in < 1 || c_in < 1 || rows < 1 || r_in % rows != 0;
}

}  // namespace

// C entry points, bound with ctypes. Each returns a cudaError_t (0 = launched).
extern "C" int mla_scale2(const float* x, float* out, int64_t n, void* stream) {
  return launch_scale2<kScale2Threads, kScale2Vecs, true>(x, out, n, kScale2Waves,
                                                          static_cast<cudaStream_t>(stream));
}

extern "C" int mla_row_merge_bulk(const float* x, float* out, int64_t r_in, int64_t c_in,
                                  int64_t rows, void* stream) {
  if (bad_merge(r_in, c_in, rows)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_row_merge_bulk<kStages>(x, out, r_in, c_in, rows, kStageBytes, 0,
                                        static_cast<cudaStream_t>(stream));
}

extern "C" int mla_row_merge_generic(const float* x, float* out, int64_t r_in, int64_t c_in,
                                     int64_t rows, void* stream) {
  if (bad_merge(r_in, c_in, rows)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t b = (r_in * c_in + kGenericThreads - 1) / kGenericThreads;
  row_merge_generic<<<static_cast<int>(b < kGenericMaxBlocks ? b : kGenericMaxBlocks),
                      kGenericThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, r_in / rows, c_in, rows);
  return static_cast<int>(cudaGetLastError());
}
