"""Batch norm + ReLU on the card (``csrc/norm_act.cu``): a CompactCNN
block's norm and activation with flax's arithmetic,
``relu(T((x - mean) * scale + shift))``, ``scale = gamma * rsqrt(var +
eps)``, computed in f32 from the activation's type T (bf16 or f32).

The JAX package leaves flax's ``nn.BatchNorm`` and the ReLU to XLA; no
Pallas kernel is involved. On a CUDA tensor the port runs them in four
kernels (``LAUNCHES`` counts each):

- ``apply``: one pass, x in and relu(y) out (eval; the train forward's
  second pass);
- ``stats``: the train forward's first pass, per-channel [sum x, sum x^2]
  in f32 (a partial per block, summed in a fixed order: no float atomics);
- ``backward_reduce``: per-channel [sum g, sum g * xhat] from dy and x, with
  g = dy * [y > 0] (the mask recomputed by the forward's own arithmetic) and
  xhat = (x - mean) * rstd;
- ``backward_dx``: dx = scale * ((g - b) - xhat * c) with b = sum g / M and
  c = [var unclamped] * sum (g * xhat) / M;

and for a stage's last block, which also takes the stage's 2x2 stride-2 max
pool (floor mode, as ``F.max_pool2d(y, 2, 2)``), three pooled versions, so
that no full-size post-ReLU map is written, read back or saved, and no pool
index either:

- ``apply_pool``: x in, the 2x2 max of relu(y) out;
- ``backward_reduce_pool`` and ``backward_dx_pool``: dy at the pooled size,
  routed to each window's element that ``F.max_pool2d`` picks (the first
  strict maximum in row-major window order, or the last NaN), recomputed
  from x by the forward's arithmetic, then gated by [y > 0]; every other
  element has g = 0 (an odd trailing row or column too). The sums run over
  all M elements, so M, the DP all-reduce and dx's formula are unchanged.

That dx is the derivative of the fast-variance formula the forward uses.
With d = x - mean, var = max(0, E[x^2] - mean^2), r = rsqrt(var + eps), y =
d * gamma * r + beta: dbeta = sum g, dgamma = sum g * d * r = sum g * xhat,
and through mean and E[x^2] (the clamp passes the gradient where E[x^2] -
mean^2 >= 0, as ``clamp_min``'s does)
dx = gamma r g - gamma r sum g / M - gamma r^3 sum(g d) d / M
   = scale * (g - sum g / M - xhat * sum(g xhat) / M).
With a data-parallel ``group`` the [2, C] sums of both reductions are
all-reduced over it and M is the global count, which gives the global
batch's statistics and gradient, as the reference's ``pjit`` does; dgamma
and dbeta stay each rank's own.

Each kernel is a registered op (``torch.ops.mla_tpu_torch.norm_act_*``,
``torch.library.define``): its CUDA implementation launches the kernel
on the tensor's device's current stream (or raises), its CPU
implementation is the plain torch version (``*_reference``), and its fake
implementation gives a trace the output's shape, so ``torch.export`` records
the eval block as one node and a loaded program finds it after importing
this module. The trunk's ``_BatchNormReLU`` calls ``norm_relu_eval`` and
``norm_relu_train`` on every device: on the CPU the plain versions under
the same hand-derived backward, which the CPU tests hold against the JAX
package's autograd. The activation is channels-last (rows [N*H*W, C]) or
contiguous NCHW, read from its strides; anything else raises, with no
hidden copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from mla_tpu_torch.ops import _build

LAUNCHES = {"apply": 0, "stats": 0, "backward_reduce": 0, "backward_dx": 0,
            "apply_pool": 0, "backward_reduce_pool": 0, "backward_dx_pool": 0}

_P, _L, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {"mla_norm_act_elementwise": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _I,
                                            _I, _I, _I, _I, _P],
               "mla_norm_act_reduce": [_P, _P, _P, _P, _P, _P, _P, _L, _P, _L, _L, _L, _I, _I,
                                       _I, _I, _I, _P]}
_DTYPES = (torch.bfloat16, torch.float32)
_BLOCKS_PER_SM = 8  # at most, for a 256-thread block: the partials a reduction may write
_S = (1, -1, 1, 1)


# ---- the plain versions: the CPU implementation of each op ----

def apply_reference(x: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
                    shift: torch.Tensor) -> torch.Tensor:
    """relu(T((x - mean) * scale + shift)), each op in f32, as flax's batch
    norm computes and casts back, then the ReLU."""
    y = (x.float() - mean.view(_S)) * scale.view(_S) + shift.view(_S)
    return torch.relu(y.to(x.dtype))


def stats_reference(x: torch.Tensor) -> torch.Tensor:
    """[2, C] f32: per channel, sum x and sum x^2 over (N, H, W)."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))])


def _gate_and_xhat(dy, x, mean, rstd, scale, shift):
    d = x.float() - mean.view(_S)
    y = (d * scale.view(_S) + shift.view(_S)).to(x.dtype)
    return torch.where(y > 0, dy.float(), 0.0), d * rstd.view(_S)


def backward_reduce_reference(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                              rstd: torch.Tensor, scale: torch.Tensor,
                              shift: torch.Tensor) -> torch.Tensor:
    """[2, C] f32: per channel, sum g and sum g * xhat, g = dy * [y > 0]."""
    g, xhat = _gate_and_xhat(dy, x, mean, rstd, scale, shift)
    return torch.stack([g.sum(dim=(0, 2, 3)), (g * xhat).sum(dim=(0, 2, 3))])


def backward_dx_reference(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                          rstd: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                          coef_b: torch.Tensor, coef_c: torch.Tensor) -> torch.Tensor:
    """dx = scale * ((g - b) - xhat * c) in f32, cast to x's type."""
    g, xhat = _gate_and_xhat(dy, x, mean, rstd, scale, shift)
    return (scale.view(_S) * (g - coef_b.view(_S) - xhat * coef_c.view(_S))).to(x.dtype)


def apply_pool_reference(x: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
                         shift: torch.Tensor) -> torch.Tensor:
    """The 2x2 stride-2 max pool of apply_reference (floor mode), in x's layout."""
    y = F.max_pool2d(apply_reference(x, mean, scale, shift), 2, 2)
    return y.contiguous(memory_format=_format(_layout(x)))


def _route(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor,
           shift: torch.Tensor) -> torch.Tensor:
    """The pooled dy routed to x's size by the max pool's own backward: to
    the element of each window that F.max_pool2d picks from relu(y), zeros
    elsewhere."""
    y = apply_reference(x, mean, scale, shift)
    _, picks = F.max_pool2d(y, 2, 2, return_indices=True)
    routed = torch.ops.aten.max_pool2d_with_indices_backward(dy, y, [2, 2], [2, 2], [0, 0],
                                                             [1, 1], False, picks)
    return routed.contiguous(memory_format=_format(_layout(x)))


def backward_reduce_pool_reference(dy, x, mean, rstd, scale, shift) -> torch.Tensor:
    """backward_reduce_reference of the pooled dy routed to x's size."""
    return backward_reduce_reference(_route(dy, x, mean, scale, shift), x, mean, rstd, scale,
                                     shift)


def backward_dx_pool_reference(dy, x, mean, rstd, scale, shift, coef_b, coef_c) -> torch.Tensor:
    """backward_dx_reference of the pooled dy routed to x's size."""
    return backward_dx_reference(_route(dy, x, mean, scale, shift), x, mean, rstd, scale, shift,
                                 coef_b, coef_c)


# ---- the kernels ----

def _layout(x: torch.Tensor) -> bool:
    """True for contiguous NCHW, False for channels-last; raises otherwise."""
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"norm_act takes a non-empty [N, C, H, W] tensor, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"norm_act takes bfloat16 or float32, got {x.dtype}")
    if x.is_contiguous(memory_format=torch.channels_last):
        return False
    if x.is_contiguous():
        return True
    raise ValueError(f"norm_act takes a channels-last or contiguous NCHW tensor, got strides "
                     f"{x.stride()} for shape {tuple(x.shape)}")


def _vec(x: torch.Tensor, nchw: bool, *others: torch.Tensor, pool: bool = False) -> int:
    """Elements a load: 16 bytes' worth where every pointer is 16-byte
    aligned and no load would cross a row (channels-last: C) or a plane
    (NCHW: H*W; pooled, a pair of loads must stay in a row: 2V columns);
    else 1."""
    v = 16 // x.element_size()
    run, per = ((x.shape[1], v) if not nchw else (x.shape[3], 2 * v) if pool
                else (x.shape[2] * x.shape[3], v))
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *others))
    return v if aligned and run % per == 0 else 1


def _format(nchw: bool) -> torch.memory_format:
    return torch.contiguous_format if nchw else torch.channels_last


def _pooled(x: torch.Tensor) -> Tuple[int, int, int, int]:
    """x's shape after the 2x2 stride-2 max pool (floor mode); raises below 2 x 2."""
    n, c, h, w = x.shape
    if h < 2 or w < 2:
        raise ValueError(f"norm_act: a pooled block takes a map of at least 2 x 2, got "
                         f"{tuple(x.shape)}")
    return n, c, h // 2, w // 2


def _operands(x: torch.Tensor, dy: Optional[torch.Tensor], *vectors: Optional[torch.Tensor],
              pool: bool = False):
    """(nchw, the per-channel vectors made contiguous) after checking dy
    (x's shape, or pooled its pooled shape; x's type and layout) and each
    vector (f32 [C] on x's device)."""
    nchw = _layout(x)
    shape = _pooled(x) if pool else x.shape
    if dy is not None and (dy.shape != shape or dy.dtype != x.dtype
                           or not dy.is_contiguous(memory_format=_format(nchw))):
        raise ValueError(f"norm_act: dy must have the shape {tuple(shape)}, x's type and layout, "
                         f"got {dy.dtype} {tuple(dy.shape)} strides {dy.stride()} against "
                         f"{x.dtype} {x.stride()}")
    c = x.shape[1]
    for v in vectors:
        if v is not None and (v.shape != (c,) or v.dtype != torch.float32
                              or v.device != x.device):
            raise ValueError(f"norm_act: a per-channel vector must be float32 [{c}] on "
                             f"{x.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")
    return nchw, [None if v is None else v.contiguous() for v in vectors]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=16)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(fn_name: str, x: torch.Tensor, args) -> None:
    lib = _build.load("norm_act", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"norm_act {fn_name} launch failed: cudaError {err}")


def _elementwise(kind: str, x, dy, *vectors) -> torch.Tensor:
    """apply (dy None) or backward_dx on vectors (mean, rstd, scale, shift,
    b, c); their pooled versions for a kind that ends in ``_pool``."""
    pool = kind.endswith("_pool")
    nchw, vecs = _operands(x, dy, *vectors, pool=pool)
    if pool and dy is None:
        out = torch.empty(_pooled(x), dtype=x.dtype, device=x.device,
                          memory_format=_format(nchw))
    else:
        out = torch.empty_like(x)
    n, c, h, w = x.shape
    grads = () if dy is None else (dy,)
    _launch("mla_norm_act_elementwise", x,
            (x.data_ptr(), _ptr(dy), out.data_ptr(), *map(_ptr, vecs), n, h, w, c,
             int(x.dtype == torch.bfloat16), int(nchw), int(pool),
             _vec(x, nchw, out, *grads, pool=pool)))
    LAUNCHES[kind] += 1
    return out


def _reduce(kind: str, x, dy, *vectors) -> torch.Tensor:
    """stats (dy None) or backward_reduce on vectors (mean, rstd, scale,
    shift); backward_reduce_pool takes the pooled dy."""
    pool = kind.endswith("_pool")
    nchw, vecs = _operands(x, dy, *vectors, pool=pool)
    n, c, h, w = x.shape
    max_partials = n if nchw else _BLOCKS_PER_SM * _sm_count(x.device)
    partial = torch.empty((max_partials, 2, c), dtype=torch.float32, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    grads = () if dy is None else (dy,)
    _launch("mla_norm_act_reduce", x,
            (x.data_ptr(), _ptr(dy), *map(_ptr, vecs), partial.data_ptr(), max_partials,
             out.data_ptr(), n, h, w, c, int(x.dtype == torch.bfloat16), int(nchw), int(pool),
             _vec(x, nchw, *grads, pool=pool)))
    LAUNCHES[kind] += 1
    return out


# Each kernel is an op of the dispatcher, defined with torch.library.define
# and given its CUDA, CPU and fake implementations. (torch.library.custom_op
# would wrap each implementation in a dynamo guard whose first call imports
# torch._dynamo, seconds of set-up in a process that compiles nothing.)
_OPS = {
    "norm_act_apply": ("(Tensor x, Tensor mean, Tensor scale, Tensor shift) -> Tensor",
                       lambda x, mean, scale, shift: _elementwise(
                           "apply", x, None, mean, None, scale, shift, None, None),
                       apply_reference, lambda x, *_: torch.empty_like(x)),
    "norm_act_stats": ("(Tensor x) -> Tensor",
                       lambda x: _reduce("stats", x, None, None, None, None, None),
                       stats_reference,
                       lambda x: x.new_empty((2, x.shape[1]), dtype=torch.float32)),
    "norm_act_backward_reduce": (
        "(Tensor dy, Tensor x, Tensor mean, Tensor rstd, Tensor scale, Tensor shift) -> Tensor",
        lambda dy, x, mean, rstd, scale, shift: _reduce(
            "backward_reduce", x, dy, mean, rstd, scale, shift),
        backward_reduce_reference,
        lambda dy, x, *_: x.new_empty((2, x.shape[1]), dtype=torch.float32)),
    "norm_act_backward_dx": (
        "(Tensor dy, Tensor x, Tensor mean, Tensor rstd, Tensor scale, Tensor shift, "
        "Tensor coef_b, Tensor coef_c) -> Tensor",
        lambda dy, x, mean, rstd, scale, shift, coef_b, coef_c: _elementwise(
            "backward_dx", x, dy, mean, rstd, scale, shift, coef_b, coef_c),
        backward_dx_reference, lambda dy, x, *_: torch.empty_like(x)),
    "norm_act_apply_pool": (
        "(Tensor x, Tensor mean, Tensor scale, Tensor shift) -> Tensor",
        lambda x, mean, scale, shift: _elementwise(
            "apply_pool", x, None, mean, None, scale, shift, None, None),
        apply_pool_reference,
        lambda x, *_: x.new_empty(_pooled(x)).contiguous(memory_format=_format(_layout(x)))),
    "norm_act_backward_reduce_pool": (
        "(Tensor dy, Tensor x, Tensor mean, Tensor rstd, Tensor scale, Tensor shift) -> Tensor",
        lambda dy, x, mean, rstd, scale, shift: _reduce(
            "backward_reduce_pool", x, dy, mean, rstd, scale, shift),
        backward_reduce_pool_reference,
        lambda dy, x, *_: x.new_empty((2, x.shape[1]), dtype=torch.float32)),
    "norm_act_backward_dx_pool": (
        "(Tensor dy, Tensor x, Tensor mean, Tensor rstd, Tensor scale, Tensor shift, "
        "Tensor coef_b, Tensor coef_c) -> Tensor",
        lambda dy, x, mean, rstd, scale, shift, coef_b, coef_c: _elementwise(
            "backward_dx_pool", x, dy, mean, rstd, scale, shift, coef_b, coef_c),
        backward_dx_pool_reference, lambda dy, x, *_: torch.empty_like(x)),
}
for _name, (_schema, _cuda, _cpu, _fake) in _OPS.items():
    torch.library.define(f"mla_tpu_torch::{_name}", _schema)
    torch.library.impl(f"mla_tpu_torch::{_name}", "cuda")(_cuda)
    torch.library.impl(f"mla_tpu_torch::{_name}", "cpu")(_cpu)
    torch.library.register_fake(f"mla_tpu_torch::{_name}")(_fake)


# ---- the block's norm + activation ----

def norm_relu_eval(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float, pool: bool = False) -> torch.Tensor:
    """Eval mode: relu(batch norm of x with the running ``mean`` and
    ``var``), with ``pool`` its 2x2 stride-2 max pool; one ``apply`` (or
    ``apply_pool``) launch for a CUDA tensor (its plain version on the
    CPU). It takes no gradient: a backward through it raises."""
    scale = torch.rsqrt(var + eps) * weight
    ops = torch.ops.mla_tpu_torch
    return (ops.norm_act_apply_pool if pool else ops.norm_act_apply)(x, mean, scale, bias)


def _no_eval_gradient(ctx, grad):
    raise RuntimeError("norm_act: eval mode (the running statistics) has no gradient; "
                       "train the batch norm in train mode")


for _name in ("norm_act_apply", "norm_act_apply_pool"):
    torch.library.register_autograd(f"mla_tpu_torch::{_name}", _no_eval_gradient)


class _TrainNormAct(torch.autograd.Function):
    """Train mode: (relu(batch norm of x with its batch's moments), mean,
    var), the moments over ``group``'s global batch where one is given,
    with ``pool`` the output's 2x2 max pool. The forward keeps x (its own
    type), mean, rstd, scale, shift and the clamp's gate: no f32
    activation, and pooled no post-ReLU map and no pool index."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group, pool):
        sums = torch.ops.mla_tpu_torch.norm_act_stats(x)
        count = x.numel() // x.shape[1]
        if group is not None:
            dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
            count *= dist.get_world_size(group)
        mean, sq = sums[0] / count, sums[1] / count
        spread = sq - mean * mean
        var = torch.clamp_min(spread, 0.0)
        rstd = torch.rsqrt(var + eps)
        scale = rstd * weight
        ops = torch.ops.mla_tpu_torch
        y = (ops.norm_act_apply_pool if pool else ops.norm_act_apply)(x, mean, scale, bias)
        ctx.save_for_backward(x, mean, rstd, scale, bias, (spread >= 0).float())
        ctx.count, ctx.group, ctx.pool = count, group, pool
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _mean, _var):
        x, mean, rstd, scale, shift, gate = ctx.saved_tensors
        # autograd picks the incoming gradient's layout; the kernels read it in x's
        dy = dy.contiguous(memory_format=_format(_layout(x)))
        ops = torch.ops.mla_tpu_torch
        reduce, elementwise = ((ops.norm_act_backward_reduce_pool, ops.norm_act_backward_dx_pool)
                               if ctx.pool else
                               (ops.norm_act_backward_reduce, ops.norm_act_backward_dx))
        sums = reduce(dy, x, mean, rstd, scale, shift)
        total = sums
        if ctx.group is not None:
            total = sums.clone()
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=ctx.group)
        coef_b, coef_c = total[0] / ctx.count, gate * total[1] / ctx.count
        dx = elementwise(dy, x, mean, rstd, scale, shift, coef_b, coef_c)
        return dx, sums[1], sums[0], None, None, None


def norm_relu_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                    group=None, pool: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train mode: (relu(batch norm of x), batch mean, biased batch var),
    the moments over ``group``'s global batch where given (None: x alone),
    with ``pool`` the first output's 2x2 stride-2 max pool; for a CUDA
    tensor ``stats`` + ``apply`` forward and ``backward_reduce`` +
    ``backward_dx`` backward, pooled their ``_pool`` versions (the plain
    versions on the CPU). mean and var carry no gradient: they are for the
    running statistics."""
    return _TrainNormAct.apply(x, weight, bias, eps, group, pool)


def bytes_moved(x: torch.Tensor, kind: str) -> int:
    """Device-memory traffic a kernel must make on activation x (roofline
    denominator): apply reads x and writes y, stats reads x, the backward's
    reduce reads dy and x, its dx reads dy and x and writes dx; the pooled
    kinds read and write the pooled map where the others read or write y or
    dy (1.25, 1.25 and 2.25 times x's bytes on an even map)."""
    full = x.numel() * x.element_size()
    if kind.endswith("_pool"):
        n, c, h, w = _pooled(x)
        pooled = n * c * h * w * x.element_size()
        return {"apply_pool": full + pooled, "backward_reduce_pool": full + pooled,
                "backward_dx_pool": 2 * full + pooled}[kind]
    return {"apply": 2, "stats": 1, "backward_reduce": 2, "backward_dx": 3}[kind] * full

