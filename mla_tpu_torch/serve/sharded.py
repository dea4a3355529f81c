"""Context-parallel (time-sharded) whole-clip scoring (counterpart of
``mla_tpu/serve/sharded.py``): the patch axis of one long clip is split
over a mesh axis, each shard runs trunk and per-level logits on its patches
and folds them into a local streaming state, and the shards' states combine
exactly (``ops.attention_pool.combine_stream_states``: the global maximum,
then the rescaled sums) into the whole-clip attention pooling. The combine
moves O(levels x classes) numbers, whatever the clip's length.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from mla_tpu_torch._device import resolve_device
from mla_tpu_torch.config import Config
from mla_tpu_torch.ops import attention_pool as ap
from mla_tpu_torch.ops import frontend as fe
from mla_tpu_torch.parallel.mesh import Mesh
from mla_tpu_torch.serve.streaming import (
    _model_with_weights,
    stream_activations,
    stream_finalize_scores,
)


@torch.inference_mode()
def tag_clip_time_sharded(cfg: Config, state_dict: Mapping, waveform: np.ndarray,
                          mesh: Mesh, axis: str = "data", device=None) -> np.ndarray:
    """Whole-clip scores [n_classes] with the patch axis sharded over
    ``mesh[axis]`` (a single-process mesh). Equal to
    ``serve.streaming.tag_clip`` to float tolerance.

    The front-end runs once on the whole clip on ``device`` (None = the
    card; with ``frontend.impl="pallas"`` one launch of the fused kernel).
    The patch count is padded up to a multiple of the axis size with
    silence patches whose gate logits are masked to -inf, so they add
    nothing to the accumulators. Shard i takes the i-th contiguous block of
    patches to the first device of the axis' i-th row; shards on one
    device share one model replica."""
    dev = resolve_device(device)
    shard_devs = mesh.axis_devices(axis)
    n = len(shard_devs)
    replicas = {d: _model_with_weights(cfg, state_dict, d) for d in dict.fromkeys(shard_devs)}
    x = torch.from_numpy(np.ascontiguousarray(waveform, np.float32)[None]).to(dev)
    patches = fe.apply_frontend(x, cfg.frontend)  # [1, T, 96, 64]
    t = patches.shape[1]
    per = -(-t // n)
    if per * n != t:
        pad = patches.new_zeros((1, per * n - t) + tuple(patches.shape[2:]))
        patches = torch.cat([patches, pad], dim=1)
    att_act, cla_act = stream_activations(cfg.model)
    c = cfg.model.n_classes
    shard_states = []  # [shard][level]
    for i, d in enumerate(shard_devs):
        p = patches[:, i * per:(i + 1) * per].to(d)
        valid = (torch.arange(i * per, (i + 1) * per, device=d) < t)[None, :, None]
        states = []
        for g, cl in replicas[d].segment_logits(p):
            g = torch.where(valid, g, -torch.inf)
            states.append(ap.update_stream_state(ap.init_stream_state((1, c), device=d),
                                                 g, cl, att_act, cla_act))
        shard_states.append(states)
    combined = [ap.combine_stream_states([s[li] for s in shard_states], att_act)
                for li in range(len(shard_states[0]))]
    out = stream_finalize_scores(replicas[shard_devs[0]], cfg.model.variant, combined)
    return out[0].float().cpu().numpy()
