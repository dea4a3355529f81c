"""SpecAugment and mixup on the device (counterpart of
``mla_tpu/ops/augment.py``).

Each augmentation is split in two: the random draws (``spec_augment_draws``,
``mixup_draws``), taken from an explicit ``torch.Generator`` on the
device, and the arithmetic (``apply_spec_augment``, ``apply_mixup``), which
is the reference's: masks built from index comparisons, the per-clip mean as
the fill, a convex mix with a permuted partner. A caller may feed its own
draws to the arithmetic (the tests feed the reference's). Nothing here reads
a value back to the host, so a train step that augments does not sync.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class SpanDraws(NamedTuple):
    """One clip's masks per row: [B, n_masks] int64 starts and widths."""

    time_start: torch.Tensor
    time_width: torch.Tensor
    freq_start: torch.Tensor
    freq_width: torch.Tensor


def _spans(b: int, n: int, size: int, max_width: int,
           generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """[b, n] spans: width uniform in [0, max_width], start uniform in
    [0, max(size - width, 1)), as the reference's ``_span_mask`` draws them."""
    dev = generator.device
    width = torch.randint(0, max_width + 1, (b, n), generator=generator, device=dev)
    hi = torch.clamp(size - width, min=1)
    u = torch.rand((b, n), generator=generator, device=dev, dtype=torch.float64)
    start = torch.minimum((u * hi).to(torch.int64), hi - 1)
    return start, width


def spec_augment_draws(b: int, frames: int, mels: int, generator: torch.Generator,
                       n_time_masks: int = 2, time_mask_width: int = 24,
                       n_freq_masks: int = 2, freq_mask_width: int = 12) -> SpanDraws:
    """Every clip's time and frequency spans, drawn on the generator's
    device."""
    ts, tw = _spans(b, n_time_masks, frames, time_mask_width, generator)
    fs, fw = _spans(b, n_freq_masks, mels, freq_mask_width, generator)
    return SpanDraws(ts, tw, fs, fw)


def _span_mask(start: torch.Tensor, width: torch.Tensor, size: int) -> torch.Tensor:
    """[B, n] spans -> [B, size] bool, the union of the n spans."""
    idx = torch.arange(size, device=start.device)
    inside = (idx >= start[..., None]) & (idx < (start + width)[..., None])
    return inside.any(dim=1)


def apply_spec_augment(patches: torch.Tensor, draws: SpanDraws,
                       mask_value: Optional[float] = None) -> torch.Tensor:
    """[B, T, frames, mels] (or [B, frames, mels]) -> a masked copy. Time
    spans cover frames within every patch, frequency spans mel bins; the
    fill is each clip's mean over all its values (``mask_value=None``) or
    ``mask_value``."""
    squeeze = patches.dim() == 3
    if squeeze:
        patches = patches[:, None]
    b, _, frames, mels = patches.shape
    tm = _span_mask(draws.time_start, draws.time_width, frames)  # [B, frames]
    fm = _span_mask(draws.freq_start, draws.freq_width, mels)  # [B, mels]
    mask = tm[:, None, :, None] | fm[:, None, None, :]
    if mask_value is None:
        fill = patches.mean(dim=(1, 2, 3)).view(b, 1, 1, 1)
    else:
        fill = torch.tensor(mask_value, dtype=patches.dtype, device=patches.device)
    out = torch.where(mask, fill, patches)
    return out[:, 0] if squeeze else out


def spec_augment(patches: torch.Tensor, generator: torch.Generator, n_time_masks: int = 2,
                 time_mask_width: int = 24, n_freq_masks: int = 2, freq_mask_width: int = 12,
                 mask_value: Optional[float] = None) -> torch.Tensor:
    """SpecAugment (Park et al. 2019) with every clip's spans drawn from
    ``generator`` (on the patches' device): the reference's ``spec_augment``."""
    frames, mels = patches.shape[-2:]
    draws = spec_augment_draws(patches.shape[0], frames, mels, generator, n_time_masks,
                               time_mask_width, n_freq_masks, freq_mask_width)
    return apply_spec_augment(patches, draws, mask_value)


def mixup_draws(b: int, generator: torch.Generator,
                alpha: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm [b] int64, lam [b] f32) on the generator's device: a
    permutation of the batch and Beta(alpha, alpha) weights folded to lam =
    max(lam, 1 - lam), so each example stays dominant in its own mix."""
    dev = generator.device
    perm = torch.randperm(b, generator=generator, device=dev)
    conc = torch.full((b, 2), float(alpha), dtype=torch.float32, device=dev)
    lam = torch._sample_dirichlet(conc, generator=generator)[:, 0]
    return perm, torch.maximum(lam, 1.0 - lam)


def apply_mixup(x: torch.Tensor, y: torch.Tensor, perm: torch.Tensor, lam: torch.Tensor):
    """(lam x + (1 - lam) x[perm], lam y + (1 - lam) y[perm]), lam per row,
    cast to each operand's dtype (the reference's arithmetic)."""
    b = x.shape[0]
    lam_x = lam.reshape((b,) + (1,) * (x.dim() - 1)).to(x.dtype)
    lam_y = lam.reshape(b, 1).to(y.dtype)
    return (lam_x * x + (1 - lam_x) * x[perm], lam_y * y + (1 - lam_y) * y[perm])


def mixup(x: torch.Tensor, y: torch.Tensor, generator: torch.Generator, alpha: float = 0.5):
    """Mixup (Zhang et al. 2018) over the batch axis with the permutation and
    weights drawn from ``generator`` (on x's device); any feature rank.
    Returns (x, y) mixed."""
    perm, lam = mixup_draws(x.shape[0], generator, alpha)
    return apply_mixup(x, y, perm, lam)
