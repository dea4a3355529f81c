"""Clip-level heads (counterpart of ``mla_tpu/models/heads.py``;
arXiv:1803.02353 §2-§3).

``EmbeddedMapping`` blocks transform the [B, T, D] segment-embedding
sequence, an ``AttentionModule`` pools over time, and the head variants
differ in how many attention modules there are and where they attach.
Dense layers compute in ``dtype``; gate and classifier logits are cast to
f32 before any pooling. Dropout acts in train mode only, with a mask drawn
from the generator the caller passes in; in eval mode it is the identity.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Union

import torch
import torch.nn as nn

from mla_tpu_torch.models.trunk import Dense
from mla_tpu_torch.ops.attention_pool import attention_pool


class GlobalRows(NamedTuple):
    """A dropout generator for one data-parallel rank: the masks are drawn
    for the whole ``batch`` rows and this rank keeps ``rows``, so the ranks
    together draw what one process draws for the global batch."""

    generator: torch.Generator
    batch: int
    rows: slice


def dropout(h: torch.Tensor, rate: float,
            generator: Optional[Union[torch.Generator, GlobalRows]]) -> torch.Tensor:
    """flax ``nn.Dropout`` in train mode: keep each element with probability
    1 - rate and scale it by 1 / (1 - rate). The mask comes from
    ``generator`` (on ``h``'s device), never from the global generator; a
    ``GlobalRows`` draws the global batch's mask and takes its rows."""
    if rate == 0.0:
        return h
    if rate == 1.0:
        return torch.zeros_like(h)
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator (pass generator=...)")
    keep = 1.0 - rate
    if isinstance(generator, GlobalRows):
        u = torch.rand((generator.batch,) + tuple(h.shape[1:]), generator=generator.generator,
                       device=h.device)[generator.rows]
    else:
        u = torch.rand(h.shape, generator=generator, device=h.device)
    mask = u < keep
    return torch.where(mask, h / keep, torch.zeros_like(h))


class EmbeddedMapping(nn.Module):
    """One level: ``layers_per_block`` x (Dense hidden_units + ReLU + dropout)."""

    def __init__(self, in_features: int, hidden_units: int = 512, layers_per_block: int = 1,
                 dtype=torch.bfloat16, dropout_rate: float = 0.0):
        super().__init__()
        self.layers_per_block = layers_per_block
        self.compute_dtype = dtype
        self.dropout_rate = dropout_rate
        for i in range(layers_per_block):
            self.add_module(f"fc{i}", Dense(in_features if i == 0 else hidden_units,
                                            hidden_units, dtype))

    def forward(self, h: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = h.to(self.compute_dtype)
        for i in range(self.layers_per_block):
            h = torch.relu(getattr(self, f"fc{i}")(h))
            if self.training:
                h = dropout(h, self.dropout_rate, generator)
        return h


class AttentionModule(nn.Module):
    """Per-class gate + per-class classifier, pooled over time."""

    def __init__(self, in_features: int, n_classes: int, att_activation: str = "exp",
                 cla_activation: str = "sigmoid", dtype=torch.bfloat16):
        super().__init__()
        self.att_activation = att_activation
        self.cla_activation = cla_activation
        self.gate = Dense(in_features, n_classes, dtype)
        self.cla = Dense(in_features, n_classes, dtype)

    def logits(self, h: torch.Tensor):
        """Per-segment (gate, cla) logits in f32 (the streaming contract)."""
        return self.gate(h).float(), self.cla(h).float()

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        gate, cla = self.logits(h)
        return attention_pool(gate, cla, self.att_activation, self.cla_activation)


class DecisionLevelPool(nn.Module):
    """Baseline heads: per-segment sigmoid classifier, avg or max over time.
    ``logits`` emits a zero gate, so the baselines stream through the same
    accumulators as the attention heads."""

    def __init__(self, in_features: int, n_classes: int, mode: str = "avg",
                 dtype=torch.bfloat16):
        super().__init__()
        self.mode = mode
        self.cla = Dense(in_features, n_classes, dtype)

    def logits(self, h: torch.Tensor):
        cla = self.cla(h).float()
        return torch.zeros_like(cla), cla

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        _, cla = self.logits(h)
        seg = torch.sigmoid(cla)
        if self.mode == "avg":
            return seg.mean(dim=-2)
        if self.mode == "max":
            return seg.amax(dim=-2)
        raise ValueError(f"unknown pool mode {self.mode!r}")


class MultiHeadAttentionPool(nn.Module):
    """Several attention modules on the same (last) hidden layer,
    concatenated, FC (f32) -> sigmoid."""

    def __init__(self, in_features: int, n_classes: int, n_heads: int = 4,
                 att_activation: str = "exp", cla_activation: str = "sigmoid",
                 dtype=torch.bfloat16):
        super().__init__()
        self.n_heads = n_heads
        self.att_activation = att_activation
        self.cla_activation = cla_activation
        for i in range(n_heads):
            self.add_module(f"att{i}", AttentionModule(in_features, n_classes, att_activation,
                                                       cla_activation, dtype))
        self.out = Dense(n_heads * n_classes, n_classes, torch.float32)

    def logits(self, h: torch.Tensor):
        return [getattr(self, f"att{i}").logits(h) for i in range(self.n_heads)]

    def finalize(self, pooled: List[torch.Tensor]) -> torch.Tensor:
        return torch.sigmoid(self.out(torch.cat(pooled, dim=-1)))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        pooled = [attention_pool(g, c, self.att_activation, self.cla_activation)
                  for g, c in self.logits(h)]
        return self.finalize(pooled)
