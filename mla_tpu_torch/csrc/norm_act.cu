// Batch norm + ReLU for Hopper (sm_90a): a CompactCNN block's norm and
// activation in as few passes over the activation as the arithmetic allows.
//
// Replaces no Pallas kernel. The JAX package leaves flax's nn.BatchNorm and
// the ReLU after it to XLA (mla_tpu/models/trunk.py); the port ran them as
// eager torch ops, which read and write the whole activation about ten
// times in f32 per block in eval mode and more in train mode, with
// autograd's f32 backward of each op on top. The arithmetic is flax's,
// unchanged (ops/norm_act.py has the plain torch version of every kernel
// here, which the CPU runs under the same backward):
//   y = relu(T((x - mean) * scale + shift)),  scale = gamma * rsqrt(var + eps),
// computed in f32 from the input type T (bf16 or f32), each of the three ops
// rounded as PyTorch's separate eager ops round it (no FMA contraction), so
// the elementwise kernels equal their plain versions bit for bit given the
// same [C] vectors.
//
// What bounds it on this card: bytes. Each kernel streams the activation
// and does a handful of flops per element, far below the ~295 flops a byte
// where the H100 stops being memory-bound. Per element of type T:
//   apply            (eval forward; train forward's second pass): read x, write y: 2 sizeof(T)
//   reduce, forward  (train statistics): read x: sizeof(T)
//   reduce, backward (per-channel sums of g and g * xhat): read dy and x: 2 sizeof(T)
//   elementwise, dx  (train backward): read dy and x, write dx: 3 sizeof(T)
// and for a stage's last block, whose 2x2 max pool (floor mode, as
// F.max_pool2d) each pooled kernel takes in, so the full-size post-ReLU map
// is never written, read back or saved, and no pool index is either:
//   apply_pool       read x, write the pooled y: 1.25 sizeof(T)
//   reduce_pool      (backward) read x and the pooled dy: 1.25 sizeof(T)
//   dx_pool          read x and the pooled dy, write dx: 2.25 sizeof(T)
// One block's activation at the flagship's train size is up to 2 GB, far
// beyond the 50 MB L2, so the statistics and the normalisation cannot share
// a pass: two passes forward and two backward is the floor. At the flagship
// tag size (1,280 patches, 1.887e9 elements over the eight blocks, bf16) the
// apply passes move 7.55 GB, 2.25 ms at 3.35 TB/s.
//
// Design. Activations are channels-last (the cuDNN convolutions' layout),
// viewed as rows [M = N*H*W, C]. A thread moves 16 bytes a load (8 bf16 or 4
// f32 channels) and always the same channels: the grid-stride is a
// multiple of the C / V threads a row takes, so a thread's per-channel
// vectors (mean, scale, shift, ...) sit in registers for the whole kernel.
// The grid is what the SMs hold at once (occupancy-sized, persistent), and
// each thread keeps kUnroll loads in flight before it computes. A
// contiguous NCHW input also works: the elementwise kernels find the
// channel of each vector from its index, (i / HW) % C, and the reductions
// take one warp per (n, c) plane.
// The reductions write one partial [2, C] per block (or per sample, NCHW)
// through registers and a shared-memory table summed in a fixed order, and
// a finalize kernel sums the partials in a fixed order: no float atomics, so
// a run repeats bit for bit on the same card and shape.
// Backward: g = dy * [y > 0], the mask recomputed from x by the forward's
// own arithmetic (bit-identical), xhat = (x - mean) * rstd; the reduce gives
// [sum g, sum g * xhat] and the dx kernel computes
//   dx = scale * ((g - b) - xhat * c),   b = sum g / M,  c = [var unclamped] sum g xhat / M,
// the derivative of the fast-variance formula (ops/norm_act.py derives it).
// Pooled: a thread owns whole 2x2 windows (channels-last: V channels of one
// window, four 16-byte loads; NCHW: V windows side by side, 2V columns of
// two rows) and recomputes each window's four relu(T(y)) by the same
// arithmetic. The forward writes their max; the backward routes the pooled
// dy to the one F.max_pool2d picks (the first strict maximum in row-major
// window order, or the last NaN, as its kernels compare), gates it by
// [y > 0], and gives every other element g = 0, an odd trailing row or
// column included. The recompute costs no bytes: the backward reads x anyway.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;      // threads a block
constexpr int kUnroll = 4;         // loads a thread keeps in flight
constexpr int kPlanesPerBlock = kThreads / 32;  // NCHW reductions: a warp a plane
constexpr int kFinalCols = 32;     // finalize: columns of [2, C] a block, x 8 slices over partials
constexpr int kFinalSlices = kThreads / kFinalCols;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive elements of T, one load or store (16 bytes when V * sizeof(T) == 16)
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// the per-channel [C] vectors; b and c only for dx
struct Params {
  const float* mean;
  const float* rstd;
  const float* scale;
  const float* shift;
  const float* b;
  const float* c;
};

struct Chan {
  float mean, rstd, scale, shift, b, c;
};

// mean, scale and shift; rstd for a backward kernel; b and c for dx
template <bool kBwd, bool kDx = kBwd>
__device__ __forceinline__ Chan load_chan(const Params& p, int c) {
  Chan ch;
  ch.mean = __ldg(p.mean + c);
  ch.scale = __ldg(p.scale + c);
  ch.shift = __ldg(p.shift + c);
  ch.rstd = kBwd ? __ldg(p.rstd + c) : 0.f;
  ch.b = kDx ? __ldg(p.b + c) : 0.f;
  ch.c = kDx ? __ldg(p.c + c) : 0.f;
  return ch;
}

// x - mean, then T((x - mean) * scale + shift): the forward's value before
// the ReLU, each op rounded on its own as PyTorch's eager ops round
template <typename T>
__device__ __forceinline__ T pre_relu(float d, const Chan& ch) {
  return from_f<T>(__fadd_rn(__fmul_rn(d, ch.scale), ch.shift));
}

// apply: relu(T(y)); dx: scale * ((g - b) - xhat * c) in T
template <typename T, bool kBwd>
__device__ __forceinline__ T elementwise_one(T xv, T dyv, const Chan& ch) {
  const float d = __fsub_rn(to_f(xv), ch.mean);
  const T y = pre_relu<T>(d, ch);
  if (!kBwd) return to_f(y) < 0.f ? from_f<T>(0.f) : y;
  const float g = to_f(y) > 0.f ? to_f(dyv) : 0.f;
  const float xhat = __fmul_rn(d, ch.rstd);
  return from_f<T>(__fmul_rn(ch.scale, __fsub_rn(__fsub_rn(g, ch.b), __fmul_rn(xhat, ch.c))));
}

// apply (kBwd false: out = relu(y)) or dx (kBwd true) over n_vec vectors of
// V elements; channels-last (kNchw false) or contiguous NCHW
template <typename T, int V, bool kBwd, bool kNchw>
__global__ void __launch_bounds__(kThreads, 2)
    norm_act_elementwise(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ out,
                         Params p, int64_t n_vec, int C, int64_t hw) {
  using P = Pack<T, V>;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  Chan fixed[kNchw ? 1 : V];
  if (!kNchw) {
    // the launch makes stride a multiple of C / V: every vector of this
    // thread starts at channel c0
    const int c0 = static_cast<int>((i * V) % C);
#pragma unroll
    for (int k = 0; k < V; ++k) fixed[k] = load_chan<kBwd>(p, c0 + k);
  }
  const P* xp = reinterpret_cast<const P*>(x);
  const P* dp = reinterpret_cast<const P*>(dy);
  P* op = reinterpret_cast<P*>(out);
  for (; i < n_vec; i += kUnroll * stride) {
    P xs[kUnroll], ds[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = i + u * stride;
      if (j < n_vec) {
        xs[u] = xp[j];
        if (kBwd) ds[u] = dp[j];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = i + u * stride;
      if (j >= n_vec) break;
      P r;
      if (kNchw) {
        // hw % V == 0: the whole vector lies in one channel's plane
        const Chan ch = load_chan<kBwd>(p, static_cast<int>((j * V / hw) % C));
#pragma unroll
        for (int k = 0; k < V; ++k) r.v[k] = elementwise_one<T, kBwd>(xs[u].v[k], ds[u].v[k], ch);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k)
          r.v[k] = elementwise_one<T, kBwd>(xs[u].v[k], ds[u].v[k], fixed[k]);
      }
      op[j] = r;
    }
  }
}

// the two per-element terms a reduction sums: (x, x^2) forward, (g, g * xhat) backward
template <typename T, bool kBwd>
__device__ __forceinline__ void accumulate(T xv, T dyv, const Chan& ch, float& s0, float& s1) {
  const float xf = to_f(xv);
  if (!kBwd) {
    s0 += xf;
    s1 = fmaf(xf, xf, s1);
    return;
  }
  const float d = __fsub_rn(xf, ch.mean);
  const float g = to_f(pre_relu<T>(d, ch)) > 0.f ? to_f(dyv) : 0.f;
  s0 += g;
  s1 = fmaf(g, __fmul_rn(d, ch.rstd), s1);
}

// ---- the pooled kernels: a stage's last block with its 2x2 max pool ----

// q / d, and q % d into r, for d > 0: in 32 bits where q fits
__device__ __forceinline__ int64_t divmod(int64_t q, int d, int& r) {
  if ((q >> 31) == 0) {
    const unsigned a = static_cast<unsigned>(q), b = static_cast<unsigned>(d), t = a / b;
    r = static_cast<int>(a - t * b);
    return t;
  }
  const int64_t t = q / d;
  r = static_cast<int>(q - t * d);
  return t;
}

// An activation [n, C, H, W] and the 2x2 windows a kernel walks: the pooled
// grid [Hp, Wp] = [H / 2, W / 2], or for dx [Hg, Wg] = [ceil(H / 2),
// ceil(W / 2)], which covers every element; its windows past the pooled
// ones (an odd trailing row or column) take no gradient.
struct Grid {
  int C, H, W, Hp, Wp, Hg, Wg;
};

// One unit of work: V channels of one window (channels-last) or V windows
// side by side in one plane (NCHW). Load q (0-3: top left, top right,
// bottom left, bottom right; NCHW: the top row's two V-column halves, then
// the bottom row's) sits at base + (q / 2) * row + (q % 2) * col; out is the
// pooled offset, -1 for a window that is not pooled.
struct Unit {
  int64_t base, out;
  int c;               // NCHW: the plane's channel
  bool right, bottom;  // the window's right column and bottom row exist
};

template <int V, bool kNchw>
__device__ __forceinline__ Unit locate(const Grid& g, int64_t u, int c0) {
  Unit w;
  int r, h, col;
  if (kNchw) {
    const int per_row = g.Wg / V;
    const int64_t plane = divmod(u, g.Hg * per_row, r);
    h = r / per_row;
    col = (r - h * per_row) * V;
    divmod(plane, g.C, w.c);
    w.base = (plane * g.H + 2 * h) * g.W + 2 * col;
    w.out = (plane * g.Hp + h) * g.Wp + col;
  } else {
    const int64_t n = divmod(u, g.Hg * g.Wg, r);
    h = r / g.Wg;
    col = r - h * g.Wg;
    w.c = c0;
    w.base = ((n * g.H + 2 * h) * g.W + 2 * col) * g.C + c0;
    w.out = ((n * g.Hp + h) * g.Wp + col) * g.C + c0;
  }
  w.right = 2 * col + 1 < g.W;
  w.bottom = 2 * h + 1 < g.H;
  if (h >= g.Hp || col >= g.Wp) w.out = -1;
  return w;
}

template <int V, bool kNchw>
__device__ __forceinline__ int64_t load_at(const Grid& g, const Unit& w, int q) {
  const int64_t row = kNchw ? g.W : static_cast<int64_t>(g.W) * g.C;
  return w.base + (q >> 1) * row + (q & 1) * (kNchw ? V : g.C);
}

__device__ __forceinline__ bool present(const Unit& w, int q) {
  return (q < 2 || w.bottom) && ((q & 1) == 0 || w.right);
}

// element q of window k in the unit's four loads
template <typename T, int V, bool kNchw>
__device__ __forceinline__ T& elem(Pack<T, V> (&p)[4], int k, int q) {
  if (!kNchw) return p[q].v[k];
  const int i = 2 * k + (q & 1);
  return p[2 * (q >> 1) + i / V].v[i % V];
}

template <typename T>
__device__ __forceinline__ T relu(T y) {
  return to_f(y) < 0.f ? from_f<T>(0.f) : y;
}

// the window's four values before the ReLU -> the slot F.max_pool2d picks
// from relu(y): the first strict maximum in row-major order, or the last NaN
template <typename T>
__device__ __forceinline__ int window_pick(const T (&y)[4]) {
  int at = 0;
  float m = to_f(relu(y[0]));
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    const float v = to_f(relu(y[q]));
    if (v > m || isnan(v)) {
      m = v;
      at = q;
    }
  }
  return at;
}

// the value F.max_pool2d gives for the window: relu(y) of its pick
template <typename T>
__device__ __forceinline__ T window_max(const T (&y)[4]) {
  T m = relu(y[0]);
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    const T v = relu(y[q]);
    if (to_f(v) > to_f(m) || isnan(to_f(v))) m = v;
  }
  return m;
}

template <typename A>
__device__ __forceinline__ A slot(const A (&a)[4], int at) {
  A v = a[0];
#pragma unroll
  for (int q = 1; q < 4; ++q) v = at == q ? a[q] : v;
  return v;
}

// apply_pool (kBwd false: the pooled max of relu(y) over the pooled grid) or
// dx_pool (kBwd true: dx of every element, over the grid that covers them).
// A thread takes one unit at a time: its four loads (five with dy) keep
// enough bytes in flight, and a second unit in flight measured slower
// (apply_pool) or spilled registers (dx_pool) on an H100.
template <typename T, int V, bool kBwd, bool kNchw>
__global__ void __launch_bounds__(kThreads, 2)
    norm_act_pool_elementwise(const T* __restrict__ x, const T* __restrict__ dy,
                              T* __restrict__ out, Params p, Grid g, int64_t units) {
  using P = Pack<T, V>;
  const int per_unit = kNchw ? 1 : g.C / V;  // threads a unit's channels take
  int lane;
  const int64_t first = divmod(static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
                               per_unit, lane);
  // the launch makes the thread stride a multiple of per_unit: every unit of
  // this thread starts at channel c0
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x / per_unit;
  const int c0 = lane * V;
  Chan fixed[kNchw ? 1 : V];
  if (!kNchw) {
#pragma unroll
    for (int k = 0; k < V; ++k) fixed[k] = load_chan<kBwd>(p, c0 + k);
  }
  for (int64_t u = first; u < units; u += stride) {
    const Unit w = locate<V, kNchw>(g, u, c0);
    P xs[4] = {}, ds = {};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (!kBwd || present(w, q))
        xs[q] = *reinterpret_cast<const P*>(x + load_at<V, kNchw>(g, w, q));
    if (kBwd && w.out >= 0) ds = *reinterpret_cast<const P*>(dy + w.out);
    const Chan plane = kNchw ? load_chan<kBwd>(p, w.c) : Chan{};
    P r, o[4];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const Chan& ch = kNchw ? plane : fixed[k];
      float d[4];
      T y[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        d[q] = __fsub_rn(to_f(elem<T, V, kNchw>(xs, k, q)), ch.mean);
        y[q] = pre_relu<T>(d[q], ch);
      }
      if (!kBwd) {
        r.v[k] = window_max(y);
        continue;
      }
      int at = -1;
      float gv = 0.f;
      if (w.out >= 0) {
        at = window_pick(y);
        gv = to_f(slot(y, at)) > 0.f ? to_f(ds.v[k]) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float gq = q == at ? gv : 0.f;
        elem<T, V, kNchw>(o, k, q) = from_f<T>(__fmul_rn(
            ch.scale, __fsub_rn(__fsub_rn(gq, ch.b), __fmul_rn(__fmul_rn(d[q], ch.rstd), ch.c))));
      }
    }
    if (!kBwd) {
      *reinterpret_cast<P*>(out + w.out) = r;
      continue;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (present(w, q)) *reinterpret_cast<P*>(out + load_at<V, kNchw>(g, w, q)) = o[q];
  }
}

// the backward's two sums of one pooled window's element: only the element
// the pool picked carries g, so (g, g * xhat) of that one
template <typename T>
__device__ __forceinline__ void accumulate_window(const T (&xv)[4], T dyv, const Chan& ch,
                                                  float& s0, float& s1) {
  float d[4];
  T y[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    d[q] = __fsub_rn(to_f(xv[q]), ch.mean);
    y[q] = pre_relu<T>(d[q], ch);
  }
  const int at = window_pick(y);
  const float g = to_f(slot(y, at)) > 0.f ? to_f(dyv) : 0.f;
  s0 += g;
  s1 = fmaf(g, __fmul_rn(slot(d, at), ch.rstd), s1);
}

// channels-last rows [M, C] -> partial [gridDim.x, 2, C]. blockIdx.y picks
// a window of `cols` vectors of the row (all of it where C / V <= kThreads);
// a thread owns V channels of one row group; the block's groups meet in
// shared memory ([groups, 2, cols * V]) and are summed in group order.
// Pooled (backward only): a row is a pooled window, its four x vectors read
// at the window's pixels of g, its dy at the row; one window in flight (with
// two, the kernel spilled registers on an H100).
template <typename T, int V, bool kBwd, bool kPool>
__global__ void __launch_bounds__(kThreads, 2)
    norm_act_reduce_rows(const T* __restrict__ x, const T* __restrict__ dy, Params p,
                         float* __restrict__ partial, int64_t M, int C, int cols, Grid g) {
  using P = Pack<T, V>;
  constexpr int U = kPool ? 1 : kUnroll, L = kPool ? 4 : 1;
  extern __shared__ float table[];
  const int groups = blockDim.x / cols, width = cols * V;
  const int lane = threadIdx.x % cols, grp = threadIdx.x / cols;
  const int c0 = (blockIdx.y * cols + lane) * V;
  const bool live = c0 < C;
  Chan ch[V];
#pragma unroll
  for (int k = 0; k < V; ++k) ch[k] = kBwd && live ? load_chan<true, false>(p, c0 + k) : Chan{};
  float s0[V], s1[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s0[k] = s1[k] = 0.f;
  const int64_t rstride = static_cast<int64_t>(gridDim.x) * groups;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * groups + grp; live && r < M;
       r += U * rstride) {
    P xs[U][L], ds[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t row = r + u * rstride;
      if (row < M) {
        if constexpr (kPool) {
          const Unit w = locate<V, false>(g, row, c0);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            xs[u][q] = *reinterpret_cast<const P*>(x + load_at<V, false>(g, w, q));
        } else {
          xs[u][0] = *reinterpret_cast<const P*>(x + row * C + c0);
        }
        if (kBwd) ds[u] = *reinterpret_cast<const P*>(dy + row * C + c0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * rstride >= M) break;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if constexpr (kPool) {
          const T xv[4] = {xs[u][0].v[k], xs[u][1].v[k], xs[u][2].v[k], xs[u][3].v[k]};
          accumulate_window<T>(xv, ds[u].v[k], ch[k], s0[k], s1[k]);
        } else {
          accumulate<T, kBwd>(xs[u][0].v[k], ds[u].v[k], ch[k], s0[k], s1[k]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    table[(grp * 2) * width + lane * V + k] = s0[k];
    table[(grp * 2 + 1) * width + lane * V + k] = s1[k];
  }
  __syncthreads();
  const int base = blockIdx.y * width;
  for (int j = threadIdx.x; j < 2 * width; j += blockDim.x) {
    const int k = j / width, col = base + j % width;
    if (col >= C) continue;
    float a = 0.f;
    for (int gr = 0; gr < groups; ++gr) a += table[gr * 2 * width + j];
    partial[(static_cast<int64_t>(blockIdx.x) * 2 + k) * C + col] = a;
  }
}

// contiguous NCHW -> partial [N, 2, C]: one warp per (n, c) plane of H x W
// elements, its lanes' sums joined by a fixed xor tree. Pooled (backward
// only): the lanes walk the pooled plane [Hp, Wp], V windows a step, each
// from 2V columns of two rows of x.
template <typename T, int V, bool kBwd, bool kPool>
__global__ void __launch_bounds__(kThreads)
    norm_act_reduce_planes(const T* __restrict__ x, const T* __restrict__ dy, Params p,
                           float* __restrict__ partial, int64_t planes, Grid g) {
  using P = Pack<T, V>;
  const int64_t plane = static_cast<int64_t>(blockIdx.x) * kPlanesPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32, C = g.C;
  if (plane >= planes) return;
  const int c = static_cast<int>(plane % C);
  const Chan ch = kBwd ? load_chan<true, false>(p, c) : Chan{};
  const int64_t hw = static_cast<int64_t>(g.H) * g.W, pooled = static_cast<int64_t>(g.Hp) * g.Wp;
  const T* xp = x + plane * hw;
  const P* dp = reinterpret_cast<const P*>(dy + (kBwd ? plane * (kPool ? pooled : hw) : 0));
  float s0 = 0.f, s1 = 0.f;
  for (int64_t i = lane; i < (kPool ? pooled : hw) / V; i += 32) {
    P ds;
    if (kBwd) ds = dp[i];
    if constexpr (kPool) {
      const int e = static_cast<int>(i) * V, h = e / g.Wp, col = e - h * g.Wp;
      const T* base = xp + static_cast<int64_t>(2 * h) * g.W + 2 * col;
      P xs[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xs[q] = *reinterpret_cast<const P*>(base + (q >> 1) * g.W + (q & 1) * V);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const T xv[4] = {elem<T, V, true>(xs, k, 0), elem<T, V, true>(xs, k, 1),
                         elem<T, V, true>(xs, k, 2), elem<T, V, true>(xs, k, 3)};
        accumulate_window<T>(xv, ds.v[k], ch, s0, s1);
      }
    } else {
      const P xs = reinterpret_cast<const P*>(xp)[i];
#pragma unroll
      for (int k = 0; k < V; ++k) accumulate<T, kBwd>(xs.v[k], ds.v[k], ch, s0, s1);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
  }
  if (lane == 0) {
    const int64_t n = plane / C;
    partial[n * 2 * C + c] = s0;
    partial[n * 2 * C + C + c] = s1;
  }
}

// partial [P, width] -> out [width]: each block sums kFinalCols columns, its
// kFinalSlices slices striding over the partials, then the slices in order
__global__ void __launch_bounds__(kThreads)
    norm_act_finalize(const float* __restrict__ partial, float* __restrict__ out, int64_t n_part,
                      int width) {
  __shared__ float slices[kFinalSlices][kFinalCols];
  const int col = blockIdx.x * kFinalCols + threadIdx.x % kFinalCols;
  const int slice = threadIdx.x / kFinalCols;
  float a = 0.f;
  if (col < width)
    for (int64_t q = slice; q < n_part; q += kFinalSlices) a += partial[q * width + col];
  slices[slice][threadIdx.x % kFinalCols] = a;
  __syncthreads();
  if (slice == 0 && col < width) {
    float t = 0.f;
#pragma unroll
    for (int s = 0; s < kFinalSlices; ++s) t += slices[s][threadIdx.x];
    out[col] = t;
  }
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// blocks of `kernel` at `block` threads (and smem bytes) the SMs hold at once
template <typename K>
cudaError_t resident_blocks(K kernel, int block, size_t smem, int64_t* out) {
  int sms = 0, per_sm = 0;
  cudaError_t e = sm_count(&sms);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block, smem);
  *out = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  return e;
}

int64_t gcd64(int64_t a, int64_t b) { return b ? gcd64(b, a % b) : a; }

template <typename T, int V, bool kBwd, bool kNchw>
cudaError_t launch_elementwise(const void* x, const void* dy, void* out, const Params& p,
                               int64_t n, int64_t hw, int C, cudaStream_t s) {
  const int64_t n_vec = n * hw * C / V;
  auto kernel = norm_act_elementwise<T, V, kBwd, kNchw>;
  int64_t grid = 0;
  cudaError_t e = resident_blocks(kernel, kThreads, 0, &grid);
  if (e != cudaSuccess) return e;
  grid = std::min(grid, (n_vec + kThreads - 1) / kThreads);
  if (!kNchw) {
    // a whole number of rows' threads in the grid-stride, so each thread
    // keeps its channels
    const int64_t unit = (C / V) / gcd64(C / V, kThreads);
    grid = std::max(unit, grid / unit * unit);
  }
  kernel<<<static_cast<int>(grid), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(out), p, n_vec, C, hw);
  return cudaGetLastError();
}

// apply_pool or dx_pool over g's window grid
template <typename T, int V, bool kBwd, bool kNchw>
cudaError_t launch_pool_elementwise(const void* x, const void* dy, void* out, const Params& p,
                                    int64_t n, const Grid& g, cudaStream_t s) {
  const int per_unit = kNchw ? 1 : g.C / V;
  const int64_t units = kNchw ? n * g.C * g.Hg * (g.Wg / V) : n * g.Hg * g.Wg;
  auto kernel = norm_act_pool_elementwise<T, V, kBwd, kNchw>;
  int64_t grid = 0;
  cudaError_t e = resident_blocks(kernel, kThreads, 0, &grid);
  if (e != cudaSuccess) return e;
  grid = std::min(grid, (units * per_unit + kThreads - 1) / kThreads);
  // a whole number of units' threads in the grid-stride, so each thread
  // keeps its channels
  const int64_t unit = per_unit / gcd64(per_unit, kThreads);
  grid = std::max(unit, grid / unit * unit);
  kernel<<<static_cast<int>(grid), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(out), p, g, units);
  return cudaGetLastError();
}

template <typename T, int V, bool kBwd, bool kPool>
cudaError_t launch_reduce(const void* x, const void* dy, const Params& p, float* partial,
                          int64_t max_partials, float* out, int64_t n, const Grid& g, bool nchw,
                          cudaStream_t s) {
  const int C = g.C;
  int64_t n_part = 0;
  if (nchw) {
    const int64_t planes = n * C;
    if (max_partials < n) return cudaErrorInvalidValue;
    const int64_t grid = (planes + kPlanesPerBlock - 1) / kPlanesPerBlock;
    if (grid > 0x7fffffff) return cudaErrorInvalidValue;
    norm_act_reduce_planes<T, V, kBwd, kPool><<<static_cast<int>(grid), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), p, partial, planes, g);
    n_part = n;
  } else {
    const int tpr = C / V, cols = std::min(tpr, kThreads), windows = (tpr + cols - 1) / cols;
    const int block = kThreads / cols * cols, groups = block / cols;
    const int64_t rows = n * (kPool ? static_cast<int64_t>(g.Hp) * g.Wp
                                    : static_cast<int64_t>(g.H) * g.W);
    const size_t smem = static_cast<size_t>(block) * V * 2 * sizeof(float);
    auto kernel = norm_act_reduce_rows<T, V, kBwd, kPool>;
    int64_t grid = 0;
    cudaError_t e = resident_blocks(kernel, block, smem, &grid);
    if (e != cudaSuccess) return e;
    grid = std::min({(grid + windows - 1) / windows, (rows + groups - 1) / groups, max_partials});
    kernel<<<dim3(static_cast<unsigned>(grid), windows), block, smem, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(dy), p, partial, rows, C, cols, g);
    n_part = grid;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int width = 2 * C;
  norm_act_finalize<<<(width + kFinalCols - 1) / kFinalCols, kThreads, 0, s>>>(partial, out,
                                                                              n_part, width);
  return cudaGetLastError();
}

// the V and layout the caller asked for, checked against what the kernels
// take: a pooled map at least 2 x 2, and in NCHW 2V columns a load pair
bool shape_ok(int64_t n, int64_t h, int64_t w, int C, int vec, int elem, bool nchw, bool pool) {
  if (n <= 0 || h <= 0 || w <= 0 || C <= 0 || h * w > 0x7fffffff ||
      (vec != 1 && vec * elem != 16) || (pool && (h < 2 || w < 2)))
    return false;
  if (!nchw) return C % vec == 0;
  return pool ? vec == 1 || w % (2 * vec) == 0 : h * w % vec == 0;
}

// the activation's window grid: the pooled one, or (cover) one that holds every element
Grid grid_of(int64_t h, int64_t w, int C, bool cover) {
  const int H = static_cast<int>(h), W = static_cast<int>(w);
  return Grid{C, H, W, H / 2, W / 2, cover ? (H + 1) / 2 : H / 2, cover ? (W + 1) / 2 : W / 2};
}

}  // namespace

// The apply kernel (dy null: out = relu(y)) or the dx kernel (dy given:
// out = dx, with b and c), on an activation of n samples x h x w positions
// x C channels, bf16 (bf16 = 1) or f32, channels-last (nchw = 0) or
// contiguous NCHW (nchw = 1), vec elements a load (16 bytes' worth, or 1
// where the pointers or the shape do not allow it). With pool = 1 the
// block's 2x2 max pool is taken in: apply writes the pooled map [n, C, h /
// 2, w / 2] (out), dx reads the pooled dy and writes dx for every element
// of x. Returns a cudaError_t.
extern "C" int mla_norm_act_elementwise(const void* x, const void* dy, void* out,
                                        const float* mean, const float* rstd, const float* scale,
                                        const float* shift, const float* b, const float* c,
                                        int64_t n, int64_t h, int64_t w, int C, int bf16,
                                        int nchw, int pool, int vec, void* stream) {
  const int elem = bf16 ? 2 : 4;
  if (!shape_ok(n, h, w, C, vec, elem, nchw, pool) || !mean || !scale || !shift ||
      (dy && (!rstd || !b || !c)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{mean, rstd, scale, shift, b, c};
  auto s = static_cast<cudaStream_t>(stream);
  const bool bwd = dy != nullptr, v1 = vec == 1;
  const Grid g = grid_of(h, w, C, bwd);
  const int64_t hw = h * w;
  cudaError_t e;
#define MLA_LAUNCH(T, V, B, N)                                                     \
  (pool ? launch_pool_elementwise<T, V, B, N>(x, dy, out, p, n, g, s)              \
        : launch_elementwise<T, V, B, N>(x, dy, out, p, n, hw, C, s))
#define MLA_ELEMENTWISE(T, V)                                                    \
  (bwd ? (nchw ? MLA_LAUNCH(T, V, true, true) : MLA_LAUNCH(T, V, true, false))   \
       : (nchw ? MLA_LAUNCH(T, V, false, true) : MLA_LAUNCH(T, V, false, false)))
  if (bf16)
    e = v1 ? MLA_ELEMENTWISE(__nv_bfloat16, 1) : MLA_ELEMENTWISE(__nv_bfloat16, 8);
  else
    e = v1 ? MLA_ELEMENTWISE(float, 1) : MLA_ELEMENTWISE(float, 4);
#undef MLA_ELEMENTWISE
#undef MLA_LAUNCH
  return static_cast<int>(e);
}

// The statistics (dy null: out = [sum x, sum x^2]) or the backward's reduce
// (dy given: out = [sum g, sum g * xhat]) into out [2, C] f32, through
// partial [max_partials, 2, C] f32 scratch (channels-last: at most
// max_partials blocks; NCHW: one partial a sample, max_partials >= n).
// With pool = 1 (the backward's only) dy is the pooled gradient, routed to
// each window's pick. Arguments otherwise as mla_norm_act_elementwise's.
extern "C" int mla_norm_act_reduce(const void* x, const void* dy, const float* mean,
                                   const float* rstd, const float* scale, const float* shift,
                                   float* partial, int64_t max_partials, float* out, int64_t n,
                                   int64_t h, int64_t w, int C, int bf16, int nchw, int pool,
                                   int vec, void* stream) {
  const int elem = bf16 ? 2 : 4;
  if (!shape_ok(n, h, w, C, vec, elem, nchw, pool) || max_partials < 1 || (pool && !dy) ||
      (dy && (!mean || !rstd || !scale || !shift)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{mean, rstd, scale, shift, nullptr, nullptr};
  auto s = static_cast<cudaStream_t>(stream);
  const bool bwd = dy != nullptr, v1 = vec == 1;
  const Grid g = grid_of(h, w, C, false);
  cudaError_t e;
#define MLA_REDUCE(T, V)                                                                         \
  (pool ? launch_reduce<T, V, true, true>(x, dy, p, partial, max_partials, out, n, g, nchw, s)  \
   : bwd ? launch_reduce<T, V, true, false>(x, dy, p, partial, max_partials, out, n, g, nchw, s) \
         : launch_reduce<T, V, false, false>(x, dy, p, partial, max_partials, out, n, g, nchw, s))
  if (bf16)
    e = v1 ? MLA_REDUCE(__nv_bfloat16, 1) : MLA_REDUCE(__nv_bfloat16, 8);
  else
    e = v1 ? MLA_REDUCE(float, 1) : MLA_REDUCE(float, 4);
#undef MLA_REDUCE
  return static_cast<int>(e);
}
