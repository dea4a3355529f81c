"""Segment-embedding trunks (counterpart of ``mla_tpu/models/trunk.py``):
a deep CNN over each 96x64 log-mel patch -> one embedding per ~1 s segment.
``CompactCNN`` is the configurable conv stack (batch, group or no norm);
``VGGish`` the canonical VGGish topology.

The public layout is the reference's NHWC ([B, H, W] or [B, H, W, 1] in);
the module permutes to NCHW inside, PyTorch's native conv layout. Compute
follows the flax modules: inputs and weights cast to ``dtype``, parameters
stored in f32, batch norm evaluated in f32 and cast back (with the ReLU
after it, one fused kernel family on the card). In train mode
(``module.train()``) batch norm normalizes with the batch's statistics and
updates its running ones as flax does; in eval mode it reads the running
statistics. A forward that ``torch.utils.checkpoint`` re-runs in the
backward (``remat_trunk``) runs under :func:`frozen_statistics`, where batch
norm leaves its running statistics alone: the first pass moved them once, as
flax's ``nn.remat`` does.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mla_tpu_torch.ops import norm_act
from mla_tpu_torch.utils import profiling

_BN_EPS = 1e-5  # flax nn.BatchNorm's default epsilon
_GN_EPS = 1e-6  # flax nn.GroupNorm's default epsilon (torch's GroupNorm uses 1e-5)
_BN_MOMENTUM = 0.99  # flax convention: running = 0.99 * running + 0.01 * batch


class Dense(nn.Linear):
    """nn.Linear computing in ``dtype`` (weight stored [out, in] in f32)."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _BatchNormReLU(nn.BatchNorm2d):
    """A CompactCNN block's batch norm and the ReLU after it, with flax's
    arithmetic: relu((x - mean) * (scale * rsqrt(var + eps)) + bias), the
    norm in f32 and its result cast back to the input dtype before the ReLU.

    Both are the ops of ``ops/norm_act.py``: on the card (a CUDA tensor)
    the fused kernel family of ``csrc/norm_act.cu``, one ``apply`` pass in
    eval mode, a statistics pass and the apply pass forward and a reduce and
    a dx pass backward in train mode (a hand-derived backward, no autograd
    of f32 intermediates); on the CPU each kernel's plain torch version
    under the same backward, which the CPU tests hold against the JAX
    package. Eval mode takes no gradient. With ``pool`` (a stage's last
    block, whose 2x2 max pool follows) the block returns that pool of its
    output through the pooled kernels (``apply_pool``; in train mode
    ``backward_reduce_pool`` + ``backward_dx_pool`` backward), which neither
    write nor keep the full-size map.

    Train mode takes mean and variance over (N, H, W) in f32 with flax
    0.12's fast variance, max(0, E[x^2] - E[x]^2) (biased), and moves the
    running statistics by ``_BN_MOMENTUM`` with that biased variance; this
    is why the update is written here rather than left to F.batch_norm,
    whose running variance is unbiased. ``num_batches_tracked`` is not
    touched, and with ``update_stats`` False (:func:`frozen_statistics`) the
    running statistics are not either.

    With ``group`` set (:func:`global_statistics`, data parallelism over
    more than one rank) the moments are those of the global batch, as
    under the reference's ``pjit``: every rank all-reduces its [sum x, sum
    x^2], and in the backward its [sum g, sum g * xhat], so the gradient is
    the global-batch one once the ranks' gradients are averaged, and every
    rank's running statistics stay equal."""

    update_stats = True
    group = None  # the data-parallel process group, or None: this batch alone

    def forward(self, x: torch.Tensor, pool: bool = False) -> torch.Tensor:
        if not self.training:
            return norm_act.norm_relu_eval(x, self.running_mean, self.running_var, self.weight,
                                           self.bias, self.eps, pool)
        y, mean, var = norm_act.norm_relu_train(x, self.weight, self.bias, self.eps, self.group,
                                                pool)
        if self.update_stats:
            with torch.no_grad():
                m = _BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y


@contextlib.contextmanager
def frozen_statistics(module: nn.Module):
    """Within the block, every batch norm of ``module`` normalizes as before
    but leaves its running statistics alone: the re-run of a checkpointed
    forward, whose first pass already moved them."""
    norms = [m for m in module.modules() if isinstance(m, _BatchNormReLU)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


@contextlib.contextmanager
def global_statistics(module: nn.Module, group):
    """Within the block, every batch norm of ``module`` takes its train-mode
    moments over ``group``'s global batch (None: each rank's own batch)."""
    norms = [m for m in module.modules() if isinstance(m, _BatchNormReLU)]
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None


def _conv3x3(conv: nn.Conv2d, x: torch.Tensor, dt) -> torch.Tensor:
    """A "SAME" 3x3 convolution computing in ``dt`` (flax nn.Conv's dtype)."""
    bias = None if conv.bias is None else conv.bias.to(dt)
    return F.conv2d(x, conv.weight.to(dt), bias, padding=1)


class _GroupNorm(nn.GroupNorm):
    """Group norm with flax's arithmetic: per (sample, group) mean and
    variance over the group's channels and the map in f32, fast biased
    variance max(0, E[x^2] - E[x]^2), then (x - mean) * (scale *
    rsqrt(var + eps)) + bias in f32, cast back to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, g = x.shape[0], x.shape[1], self.num_groups
        xf = x.float()
        grp = xf.reshape(b, g, -1)
        mean = grp.mean(dim=-1)
        var = torch.clamp_min((grp * grp).mean(dim=-1) - mean * mean, 0.0)
        shape = (b, c, 1, 1)
        mul = torch.rsqrt(var + self.eps).repeat_interleave(c // g, dim=1) * self.weight
        y = (xf - mean.repeat_interleave(c // g, dim=1).view(shape)) * mul.view(shape)
        return (y + self.bias.view(1, c, 1, 1)).to(x.dtype)


class CompactCNN(nn.Module):
    """conv stages (3x3 conv + norm + ReLU) x convs_per_stage, a 2x2 pool
    between stages while the map is at least 2x2, global pooling and Dense
    -> embed_dim + ReLU. ``norm`` is "batch" (``bn{stage}_{i}``), "group"
    (min(32, channels) groups, ``gn{stage}_{i}``) or "none" (the conv gets
    a bias). With batch norm the block's norm + ReLU is one
    ``_BatchNormReLU`` call: on the card the fused kernels of
    ``csrc/norm_act.cu``, on the CPU their plain torch versions
    (``ops/norm_act.py``); with max pools a stage's last such call also
    takes the stage's pool.
    ``pool="avg"`` with ``global_pool="avg+max"`` is the PANNs
    CNN10/CNN14 block structure. While tracing, each block's norm + ReLU is
    a ``mla.trunk.norm_act`` span (``block``: its index; ``pool`` 1 where it
    holds the stage's max pool too) with device time,
    only on a thread the profiler records: there the trace's timeline and
    the norm + activation share read it; a thread it leaves out (the tick
    thread) pays nothing a block."""

    def __init__(self, conv_channels: Sequence[int] = (64, 128, 256, 512),
                 convs_per_stage: int = 2, embed_dim: int = 128, norm: str = "batch",
                 pool: str = "max", global_pool: str = "avg", dtype=torch.bfloat16):
        super().__init__()
        if norm not in ("batch", "group", "none"):
            raise ValueError(f"unknown norm {norm!r}")
        if pool not in ("max", "avg") or global_pool not in ("avg", "avg+max"):
            raise ValueError(f"unknown pool {pool!r} / global_pool {global_pool!r}")
        self.conv_channels = tuple(conv_channels)
        self.convs_per_stage = convs_per_stage
        self.norm = norm
        self.pool = pool
        self.global_pool = global_pool
        self.compute_dtype = dtype
        cin = 1
        for stage, ch in enumerate(self.conv_channels):
            for i in range(convs_per_stage):
                self.add_module(f"conv{stage}_{i}",
                                nn.Conv2d(cin, ch, 3, padding=1, bias=norm == "none"))
                if norm == "batch":
                    self.add_module(f"bn{stage}_{i}", _BatchNormReLU(ch, eps=_BN_EPS))
                elif norm == "group":
                    self.add_module(f"gn{stage}_{i}", _GroupNorm(min(32, ch), ch, eps=_GN_EPS))
                cin = ch
        self.embed = Dense(cin, embed_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W] or [B, H, W, 1] log-mel patches -> [B, embed_dim]."""
        if x.dim() == 3:
            x = x.unsqueeze(-1)
        dt = self.compute_dtype
        x = x.permute(0, 3, 1, 2).to(dt)  # NHWC -> NCHW
        traced = profiling.recorded()
        for stage in range(len(self.conv_channels)):
            pooled = False
            for i in range(self.convs_per_stage):
                x = _conv3x3(getattr(self, f"conv{stage}_{i}"), x, dt)
                # a stage's last batch norm + ReLU takes its max pool in
                pooled = (self.norm == "batch" and self.pool == "max"
                          and i == self.convs_per_stage - 1 and min(x.shape[2], x.shape[3]) >= 2)
                # the span holds norm and activation together (and pooled,
                # the pool): on the card with batch norm, the fused kernels'
                # launches
                with (profiling.annotate("mla.trunk.norm_act", x.device,
                                         block=stage * self.convs_per_stage + i,
                                         **({"pool": 1} if pooled else {}))
                      if traced else profiling.OFF):
                    if self.norm == "batch":
                        x = getattr(self, f"bn{stage}_{i}")(x, pooled)  # norm + ReLU (+ pool)
                    elif self.norm == "group":
                        x = torch.relu(getattr(self, f"gn{stage}_{i}")(x))
                    else:
                        x = torch.relu(x)
            if not pooled and min(x.shape[2], x.shape[3]) >= 2:
                x = F.avg_pool2d(x, 2, 2) if self.pool == "avg" else F.max_pool2d(x, 2, 2)
        if self.global_pool == "avg+max":
            x = x.mean(dim=(2, 3)) + x.amax(dim=(2, 3))
        else:
            x = x.mean(dim=(2, 3))
        return torch.relu(self.embed(x))


class VGGish(nn.Module):
    """The canonical VGGish topology: conv3x3-64 / pool / conv3x3-128 / pool /
    (conv3x3-256) x 2 / pool / (conv3x3-512) x 2 / pool / flatten / FC 4096 /
    FC 4096 / FC embed_dim, ReLU after each, 2x2 max pools, 96x64x1 in. The
    flatten takes the [6, 4, 512] map in NHWC order, as flax does, so the
    first FC's weight crosses the flat format by the plain transpose rule."""

    _PLAN = ((64, 1), (128, 1), (256, 2), (512, 2))

    def __init__(self, embed_dim: int = 128, dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = dtype
        cin = 1
        for stage, (ch, reps) in enumerate(self._PLAN):
            for i in range(reps):
                self.add_module(f"conv{stage + 1}_{i + 1}", nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch
        self.fc1_1 = Dense(6 * 4 * 512, 4096, dtype)
        self.fc1_2 = Dense(4096, 4096, dtype)
        self.fc2 = Dense(4096, embed_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 96, 64] or [B, 96, 64, 1] log-mel patches -> [B, embed_dim]."""
        if x.dim() == 3:
            x = x.unsqueeze(-1)
        dt = self.compute_dtype
        x = x.permute(0, 3, 1, 2).to(dt)  # NHWC -> NCHW
        for stage, (_, reps) in enumerate(self._PLAN):
            for i in range(reps):
                x = torch.relu(_conv3x3(getattr(self, f"conv{stage + 1}_{i + 1}"), x, dt))
            x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten in NHWC order
        x = torch.relu(self.fc1_1(x))
        x = torch.relu(self.fc1_2(x))
        return torch.relu(self.fc2(x))
