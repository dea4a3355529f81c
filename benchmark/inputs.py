"""Weights and inputs made from ``--seed``, on the device, in a few large
calls. The same seed gives the same weights and inputs; the benchmark hands
the same tensors to the program and to the reference.

Every seed draws the same amounts: values change with the seed, sizes never
do, and the serving schedule is one fixed set of arrival offsets dealt to the
streams in a seeded order.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from benchmark.reference.model import param_shapes


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose, from a seed of any size."""
    s = seed % (1 << 96)
    words = [(s >> k) & 0xFFFFFFFF for k in (0, 32, 64)] + list(purpose.encode())
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def make_weights(model: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight and batch-norm statistic, from one normal draw: convolutions
    at He scale, products at LeCun scale, biases and statistics near a
    trained network's (scales about 1, shifts about 0, variances about 1)."""
    shapes = param_shapes(model)
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        v = z[off: off + n].view(shape)
        off += n
        leaf = name.rsplit(".", 1)[1]
        if len(shape) > 1:
            fan_in = math.prod(shape[1:])
            v = v * math.sqrt((2.0 if len(shape) == 4 else 1.0) / fan_in)
        elif ".bn" in name and leaf == "weight":
            v = 1.0 + 0.1 * v
        elif leaf == "running_var":
            v = torch.exp(0.2 * v)
        else:  # biases and running means
            v = 0.1 * v
        out[name] = v.contiguous()
    return out


def program_state_dict(weights: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The weights as the program's ``state_dict`` takes them (batch norm's
    step counters added, at 0)."""
    sd = dict(weights)
    for name in weights:
        if name.endswith(".running_mean"):
            sd[name.replace("running_mean", "num_batches_tracked")] = torch.zeros(
                (), dtype=torch.int64, device=weights[name].device)
    return sd


def make_clips(n: int, n_samples: int, sample_rate: int, seed: int, purpose: str,
               device) -> torch.Tensor:
    """[n, n_samples] float32 audio in [-1, 1]: white noise at a level drawn
    per clip (-40 to -12 dBFS) under three tones per clip (100 Hz to 7 kHz,
    each at a level drawn per tone)."""
    g = generator(seed, purpose, device)
    noise = torch.randn((n, n_samples), generator=g, device=device)
    level = 10.0 ** (torch.rand((n, 1), generator=g, device=device) * 1.4 - 2.0)
    freq = 100.0 + torch.rand((n, 3, 1), generator=g, device=device) * 6900.0
    amp = 0.02 + 0.2 * torch.rand((n, 3, 1), generator=g, device=device)
    phase = 2 * math.pi * torch.rand((n, 3, 1), generator=g, device=device)
    t = torch.arange(n_samples, device=device, dtype=torch.float32) / sample_rate
    tones = (amp * torch.sin(2 * math.pi * freq * t + phase)).sum(1)
    return (noise * level + tones).clamp(-1.0, 1.0)


def make_labels(n: int, n_classes: int, rate: float, seed: int, device) -> torch.Tensor:
    """[n, n_classes] float32 multi-hot labels, each on with probability ``rate``."""
    g = generator(seed, "labels", device)
    return (torch.rand((n, n_classes), generator=g, device=device) < rate).float()


def pcm16(clips: torch.Tensor) -> torch.Tensor:
    """float audio -> int16 PCM, rounded to nearest."""
    return (clips * 32767.0).round().clamp(-32768, 32767).to(torch.int16)


def stream_phases(n_streams: int, period_s: float, seed: int) -> np.ndarray:
    """Each stream's start offset within the period: one fixed set of
    offsets drawn uniform over the period (the same set for every seed, so
    every seed offers the same arrivals), dealt to the streams in a seeded
    order."""
    offsets = np.sort(np.random.default_rng(n_streams).random(n_streams)) * period_s
    return offsets[np.random.default_rng(sub_seed(seed, "phases")).permutation(n_streams)]


def index_plan(n_pool: int, batch: int, n_steps: int, seed: int) -> torch.Tensor:
    """[n_steps, batch] int64 rows of the pool: consecutive seeded
    permutations cut into batches, so the rows of one pass all differ."""
    rng = np.random.default_rng(sub_seed(seed, "index"))
    per = n_pool // batch
    passes = [rng.permutation(n_pool)[: per * batch].reshape(per, batch)
              for _ in range(-(-n_steps // per))]
    return torch.from_numpy(np.concatenate(passes)[:n_steps].astype(np.int64))
