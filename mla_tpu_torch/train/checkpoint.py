"""Checkpoint / resume (counterpart of ``mla_tpu/train/checkpoint.py``): the
whole train state (model ``state_dict`` with the batch-norm statistics,
Adam's state, step, EMA shadow), the sampler position and the config, one
``torch.save`` file per step, keep-last-N, written to a temporary name and
renamed into place so a reader never sees half a file.

A tensor-parallel state is saved whole, as the reference's checkpoints
are: its shards, Adam's moments and the EMA shadow are gathered over the
"model" axis (``train_state_payload``, a collective every rank joins before
the primary writes) and indexed as the whole model's; restoring takes each
rank's slices. So a checkpoint resumes at any ``train.model_parallel``.

This does not read the JAX package's Orbax checkpoints, nor they these:
weights cross between the packages through the flat ``.npz`` format
(``models/convert.py``).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional, Tuple

import torch

from mla_tpu_torch.parallel import tensor
from mla_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^step_(\d{8})\.pt$")


def train_state_payload(state: TrainState) -> Dict:
    """The saved part of ``state``, whole: step, model ``state_dict``, Adam's
    ``state_dict`` and the EMA shadow by the whole model's names. For a
    tensor-parallel state on a process group a collective over "model"."""
    model = state.model
    return {"step": int(state.step), "model": tensor.full_state_dict(model),
            "optimizer": tensor.full_optimizer_state(model, state.optimizer),
            "ema": (None if state.ema_params is None
                    else tensor.gather_named(model, state.ema_params))}


class CheckpointManager:
    """Save and restore (TrainState, sampler state) under ``directory``.
    Saves are synchronous, so ``wait`` and ``close`` have nothing to do;
    they keep the reference's interface."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.pt")

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, sampler_state: Optional[Dict] = None,
             config: Optional[Dict] = None, payload: Optional[Dict] = None):
        """Write ``state`` at ``step``; ``payload``, when given, is its
        :func:`train_state_payload`, gathered already (tensor parallel)."""
        payload = {
            **(payload if payload is not None else train_state_payload(state)),
            # JSON text, so the file loads with weights_only=True
            "sampler": None if sampler_state is None else json.dumps(sampler_state),
            "config": None if config is None else json.dumps(config),
        }
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.keep] if self.keep > 0 else []:
            os.remove(self._path(old))

    def restore(self, state: TrainState, step: Optional[int] = None
                ) -> Tuple[TrainState, Optional[Dict]]:
        """Load the latest (or given) step into ``state`` (a fresh state of
        the same config, e.g. from ``create_train_state``) and return it with
        the saved sampler state (None if none was saved)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        device = next(state.model.parameters()).device
        payload = torch.load(self._path(step), map_location=device, weights_only=True)
        tensor.load_full_state_dict(state.model, payload["model"])
        tensor.load_full_optimizer_state(state.model, state.optimizer, payload["optimizer"])
        state.step = int(payload["step"])
        if payload["ema"] is not None:
            state.ema_params = tensor.split_named(state.model, payload["ema"])
        sampler = payload["sampler"]
        return state, None if sampler is None else json.loads(sampler)

    def wait(self):
        pass

    def close(self):
        pass
