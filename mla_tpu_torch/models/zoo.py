"""Model assembly (counterpart of ``mla_tpu/models/zoo.py``).

``AudioTagger``: a trunk over each patch, embedded mapping blocks and the
selected clip-level head. Submodule names follow the flax module's, so the
flat weight format maps onto the ``state_dict`` by rule
(``models.convert``).
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from mla_tpu_torch._device import resolve_device
from mla_tpu_torch.config import ModelConfig
from mla_tpu_torch.models.heads import (
    AttentionModule,
    DecisionLevelPool,
    EmbeddedMapping,
    MultiHeadAttentionPool,
)
from mla_tpu_torch.models.trunk import CompactCNN, Dense, VGGish, frozen_statistics
from mla_tpu_torch.ops.attention_pool import attention_timeline

VARIANTS = (
    "multi_level_attention",
    "single_attention",
    "multi_attention",
    "avg_pool",
    "max_pool",
)


class AudioTagger(nn.Module):
    """patches [B, T, 96, 64] (trunk != none) or features [B, T, D] -> probs [B, C]."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.compute_dtype)
        if cfg.trunk == "cnn":
            self.trunk_module = CompactCNN(cfg.conv_channels, cfg.convs_per_stage,
                                           cfg.embed_dim, dtype=dtype)
        elif cfg.trunk in ("cnn10", "cnn14"):
            # PANNs block structure (Kong et al. 2020): 2 convs/stage, avg
            # 2x2 pools, avg+max global pooling
            chans = (64, 128, 256, 512) if cfg.trunk == "cnn10" else (
                64, 128, 256, 512, 1024, 2048)
            self.trunk_module = CompactCNN(chans, 2, cfg.embed_dim, pool="avg",
                                           global_pool="avg+max", dtype=dtype)
        elif cfg.trunk == "vggish":
            self.trunk_module = VGGish(cfg.embed_dim, dtype=dtype)
        elif cfg.trunk == "none":
            self.trunk_module = None
        else:
            raise ValueError(f"unknown trunk {cfg.trunk!r}")

        d, h, c = cfg.embed_dim, cfg.hidden_units, cfg.n_classes
        for i in range(cfg.n_blocks):
            self.add_module(f"block{i}", EmbeddedMapping(d if i == 0 else h, h,
                                                         cfg.layers_per_block, dtype,
                                                         cfg.dropout_rate))
        acts = (cfg.att_activation, cfg.cla_activation)
        if cfg.variant == "multi_level_attention":
            for i in range(cfg.n_blocks):
                self.add_module(f"att{i}", AttentionModule(h, c, *acts, dtype))
            self.out = Dense(cfg.n_blocks * c, c, torch.float32)
        elif cfg.variant == "single_attention":
            self.att = AttentionModule(h, c, *acts, dtype)
        elif cfg.variant == "multi_attention":
            self.mh = MultiHeadAttentionPool(h, c, cfg.n_attention_heads, *acts, dtype)
        elif cfg.variant in ("avg_pool", "max_pool"):
            self.pool = DecisionLevelPool(h, c, cfg.variant[:3], dtype)
        else:
            raise ValueError(f"unknown variant {cfg.variant!r}; pick from {VARIANTS}")

    def _blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.cfg.n_blocks)]

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """Input -> [B, T, embed_dim] segment embeddings (runs the trunk)."""
        if self.trunk_module is None:
            return x
        b, t = x.shape[0], x.shape[1]
        flat = x.reshape((b * t,) + tuple(x.shape[2:]))  # patches into the batch axis
        if self.cfg.remat_trunk and torch.is_grad_enabled():
            # recompute the trunk's activations in the backward instead of
            # keeping them (flax nn.remat in the reference). The re-run leaves
            # batch norm's running statistics alone; the trunks draw no
            # random numbers, so there is no RNG state to restore
            emb = checkpoint(self.trunk_module, flat, use_reentrant=False,
                             preserve_rng_state=False, context_fn=self._remat_contexts)
        else:
            emb = self.trunk_module(flat)
        return emb.reshape(b, t, -1)

    def _remat_contexts(self):
        """checkpoint's (first pass, re-run) contexts: the re-run freezes the
        trunk's batch-norm statistics."""
        return contextlib.nullcontext(), frozen_statistics(self.trunk_module)

    def head(self, h: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """[B, T, D] embeddings -> [B, C] clip probabilities. In train mode
        the blocks' dropout masks come from ``generator``."""
        variant = self.cfg.variant
        if variant == "multi_level_attention":
            zs: List[torch.Tensor] = []
            for i, block in enumerate(self._blocks()):
                h = block(h, generator)
                zs.append(getattr(self, f"att{i}")(h))
            return torch.sigmoid(self.out(torch.cat(zs, dim=-1)))
        for block in self._blocks():
            h = block(h, generator)
        if variant == "single_attention":
            return self.att(h)
        if variant == "multi_attention":
            return self.mh(h)
        return self.pool(h)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.head(self.embed(x), generator)

    def segment_logits(self, x: torch.Tensor):
        """Per-segment (gate, cla) f32 logits per level/head: the streaming
        contract (the pool baselines emit a zero gate). Meant for eval mode,
        as the reference runs it."""
        h = self.embed(x)
        variant = self.cfg.variant
        if variant == "multi_level_attention":
            outs = []
            for i, block in enumerate(self._blocks()):
                h = block(h)
                outs.append(getattr(self, f"att{i}").logits(h))
            return outs
        for block in self._blocks():
            h = block(h)
        if variant == "single_attention":
            return [self.att.logits(h)]
        if variant == "multi_attention":
            return self.mh.logits(h)
        return [self.pool.logits(h)]

    def timeline(self, x: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Weakly supervised localization: per level or head, ``(weights [B,
        T, C], seg_probs [B, T, C])``, where sum_t weights * seg_probs is
        that level's pooled vector (``ops.attention_pool.attention_timeline``
        under the variant's streaming activations)."""
        from mla_tpu_torch.serve.streaming import stream_activations

        att_act, cla_act = stream_activations(self.cfg)
        return [attention_timeline(g, c, att_act, cla_act) for g, c in self.segment_logits(x)]

    def finalize_multi_level(self, pooled: List[torch.Tensor]) -> torch.Tensor:
        """Concat per-level pooled vectors -> final FC + sigmoid (streaming tail)."""
        return torch.sigmoid(self.out(torch.cat(pooled, dim=-1)))

    def finalize_multi_head(self, pooled: List[torch.Tensor]) -> torch.Tensor:
        """The multi_attention variant's streaming tail."""
        return self.mh.finalize(pooled)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init in flax's defaults, drawn from ``generator``: conv and
    Dense weights truncated-normal with variance 1/fan_in (lecun_normal),
    biases 0, batch-norm scale 1, bias 0, running mean 0, var 1."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978  # truncation at 2 sd
            w = torch.nn.init.trunc_normal_(torch.empty(mod.weight.shape), 0.0, std,
                                            -2 * std, 2 * std, generator=generator)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.BatchNorm2d):
            mod.reset_parameters()
    return model


def build_model(cfg: ModelConfig, device=None, seed: Optional[int] = None) -> AudioTagger:
    """``AudioTagger`` on ``device`` (None = the card; raises without one
    unless device="cpu") in eval mode (``.train()`` switches batch norm and
    dropout to their train branches); ``seed`` draws random weights from a
    ``torch.Generator``, otherwise they are PyTorch's defaults and are meant
    to be replaced by ``load_state_dict``."""
    dev = resolve_device(device)
    model = AudioTagger(cfg)
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
