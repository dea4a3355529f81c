"""Segment-embedding trunk (counterpart of ``mla_tpu/models/trunk.py``):
a deep CNN over each 96x64 log-mel patch -> one embedding per ~1 s segment.

The public layout is the reference's NHWC ([B, H, W] or [B, H, W, 1] in);
the module permutes to NCHW inside, PyTorch's native conv layout. Compute
follows the flax modules: inputs and weights cast to ``dtype``, parameters
stored in f32, batch norm evaluated in f32 and cast back. In train mode
(``module.train()``) batch norm normalizes with the batch's statistics and
updates its running ones as flax does; in eval mode it reads the running
statistics.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

_BN_EPS = 1e-5  # flax nn.BatchNorm's default epsilon
_BN_MOMENTUM = 0.99  # flax convention: running = 0.99 * running + 0.01 * batch


class Dense(nn.Linear):
    """nn.Linear computing in ``dtype`` (weight stored [out, in] in f32)."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class _BatchNorm(nn.BatchNorm2d):
    """Batch norm with flax's arithmetic: (x - mean) * (scale * rsqrt(var +
    eps)) + bias in f32, result cast back to the input dtype.

    Train mode takes mean and variance over (N, H, W) in f32 with flax
    0.12's fast variance, max(0, E[x^2] - E[x]^2) (biased), and moves the
    running statistics by ``_BN_MOMENTUM`` with that biased variance; this
    is why the update is written here rather than left to F.batch_norm,
    whose running variance is unbiased. ``num_batches_tracked`` is not
    touched."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        if self.training:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
            with torch.no_grad():
                m = _BN_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x.float() - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class CompactCNN(nn.Module):
    """conv stages (3x3 conv + batch norm + ReLU) x convs_per_stage, a 2x2
    pool between stages while the map is at least 2x2, global pooling and
    Dense -> embed_dim + ReLU. ``pool="avg"`` with ``global_pool="avg+max"``
    is the PANNs CNN10/CNN14 block structure."""

    def __init__(self, conv_channels: Sequence[int] = (64, 128, 256, 512),
                 convs_per_stage: int = 2, embed_dim: int = 128, norm: str = "batch",
                 pool: str = "max", global_pool: str = "avg", dtype=torch.bfloat16):
        super().__init__()
        if norm != "batch":
            raise NotImplementedError(
                f"CompactCNN norm={norm!r}: only batch norm is ported (ROADMAP.md queue A)")
        if pool not in ("max", "avg") or global_pool not in ("avg", "avg+max"):
            raise ValueError(f"unknown pool {pool!r} / global_pool {global_pool!r}")
        self.conv_channels = tuple(conv_channels)
        self.convs_per_stage = convs_per_stage
        self.pool = pool
        self.global_pool = global_pool
        self.compute_dtype = dtype
        cin = 1
        for stage, ch in enumerate(self.conv_channels):
            for i in range(convs_per_stage):
                self.add_module(f"conv{stage}_{i}", nn.Conv2d(cin, ch, 3, padding=1, bias=False))
                self.add_module(f"bn{stage}_{i}", _BatchNorm(ch, eps=_BN_EPS))
                cin = ch
        self.embed = Dense(cin, embed_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W] or [B, H, W, 1] log-mel patches -> [B, embed_dim]."""
        if x.dim() == 3:
            x = x.unsqueeze(-1)
        dt = self.compute_dtype
        x = x.permute(0, 3, 1, 2).to(dt)  # NHWC -> NCHW
        for stage in range(len(self.conv_channels)):
            for i in range(self.convs_per_stage):
                conv = getattr(self, f"conv{stage}_{i}")
                x = F.conv2d(x, conv.weight.to(dt), padding=1)
                x = torch.relu(getattr(self, f"bn{stage}_{i}")(x))
            if min(x.shape[2], x.shape[3]) >= 2:
                x = F.avg_pool2d(x, 2, 2) if self.pool == "avg" else F.max_pool2d(x, 2, 2)
        if self.global_pool == "avg+max":
            x = x.mean(dim=(2, 3)) + x.amax(dim=(2, 3))
        else:
            x = x.mean(dim=(2, 3))
        return torch.relu(self.embed(x))
