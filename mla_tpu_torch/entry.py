"""The flagship program (counterpart of ``__graft_entry__.py::entry``): a
batch of raw waveforms -> the log-mel front-end -> the CompactCNN trunk ->
multi-level attention -> clip probabilities, on the ``audioset_full_dp``
preset as shipped (CompactCNN 64/128/256/512 x 2 convs, 3 blocks of 512,
527 classes, bf16 compute, the torch-ops front-end at "default").

    fn, (model, wav) = entry()          # the card; entry(device="cpu") on the CPU
    probs = fn(model, wav)              # [4, 527]
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mla_tpu_torch._device import resolve_device
from mla_tpu_torch.config import Config, get_config
from mla_tpu_torch.models.zoo import AudioTagger, build_model
from mla_tpu_torch.ops import frontend as fe

FLAGSHIP = "audioset_full_dp"
# the reference's tiny overrides (__graft_entry__.py::_flagship_cfg)
TINY = {"model.conv_channels": "8,16", "model.convs_per_stage": "1",
        "model.hidden_units": "64", "model.n_classes": "32", "data.clip_seconds": "2.0"}
BATCH, SECONDS = 4, 10


def flagship_config(tiny: bool = False, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """The flagship preset, or its tiny cut, with dotted-path ``overrides``
    on top (e.g. {"frontend.impl": "pallas"})."""
    return get_config(FLAGSHIP, {**(TINY if tiny else {}), **(overrides or {})})


def example_waveforms(cfg: Config) -> np.ndarray:
    """[4, 10 * sample_rate] f32 noise at 0.1, drawn as the reference's
    entry() draws it."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((BATCH, SECONDS * cfg.frontend.sample_rate)).astype(np.float32) * 0.1


def flagship_forward(cfg: Config) -> Callable[[AudioTagger, torch.Tensor], torch.Tensor]:
    """fn(model, wav): waveform [B, n] -> probs [B, C] through the front-end
    ``cfg.frontend.impl`` selects, without autograd."""
    def fn(model: AudioTagger, wav: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(fe.apply_frontend(wav, cfg.frontend))

    return fn


def entry(device=None, seed: int = 0) -> Tuple[Callable, Tuple[AudioTagger, torch.Tensor]]:
    """-> (fn, (model, wav)): the flagship forward, a 4 x 10 s batch on
    ``device`` (None = the card; raises without one unless device="cpu"),
    and the model in eval mode with random weights drawn from a
    ``torch.Generator`` seeded by ``seed``."""
    dev = resolve_device(device)
    cfg = flagship_config()
    model = build_model(cfg.model, device=dev, seed=seed)
    wav = torch.from_numpy(example_waveforms(cfg)).to(dev)
    return flagship_forward(cfg), (model, wav)
