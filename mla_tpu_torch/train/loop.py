"""Train / eval loop (counterpart of ``mla_tpu/train/loop.py``), for one
process on one device.

Kept from the reference: the synthetic datasets; a training set staged once
on the device in float32, int16, uint8 or adpcm4 wire form, with each batch gathered
there by index (the host sends an index vector per step, not the batch); a
device-resident eval set; balanced or seeded-random draws, or the stateless
balanced stream of ``data/pipeline.py`` (``data.pipeline="grain"``, a torch
``DataLoader`` with ``data.grain_workers`` workers; batches are gathered on
the host and uploaded in the staging wire form each step); the log, eval and
checkpoint cadence, with the CSV scalar log and, with ``train.tensorboard``,
TensorBoard event files; hdf5 packs, loaded whole or (``data.out_of_core``)
read a batch at a time, an out-of-core set never staged or held on the
device; ``auto_resume`` with the sampler or RNG state, or the stream's
position; and graceful preemption by ``request_preemption`` or SIGTERM /
SIGINT. Not ported yet, and raising ``NotImplementedError`` that names its
ROADMAP.md item: model or data parallelism beyond the one card.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mla_tpu_torch._device import resolve_device
from mla_tpu_torch.config import Config
from mla_tpu_torch.data.adpcm import adpcm4_encode, wire_length
from mla_tpu_torch.data.audio_io import mulaw_encode, pcm16_quantize
from mla_tpu_torch.data.ooc import take_rows
from mla_tpu_torch.data.sampler import BalancedSampler, SequentialSampler
from mla_tpu_torch.data.synthetic import ArrayDataset, make_dataset
from mla_tpu_torch.models.zoo import build_model
from mla_tpu_torch.train.checkpoint import CheckpointManager
from mla_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from mla_tpu_torch.utils.logging import ScalarWriter, create_logging
from mla_tpu_torch.utils.metrics import calculate_stats


@dataclass
class FitResult:
    state: TrainState
    history: List[Dict[str, float]] = field(default_factory=list)
    eval_stats: List[Dict[str, float]] = field(default_factory=list)
    interrupted: bool = False  # preempted mid-run (a checkpoint was saved)
    # what this call ran: train steps and eval forward batches (each runs
    # the front-end once, so a caller can check the kernel's launch count)
    counts: Dict[str, int] = field(
        default_factory=lambda: {"train_steps": 0, "eval_batches": 0})


# --- graceful preemption: finish the in-flight step, checkpoint, return ---
_PREEMPTED = threading.Event()


def _on_preempt_signal(signum, frame):
    # a second Ctrl-C escalates to the normal abort path
    if signum == signal.SIGINT and _PREEMPTED.is_set():
        raise KeyboardInterrupt
    _PREEMPTED.set()


def request_preemption():
    """Programmatic equivalent of SIGTERM: ask a running fit() to finish the
    current step, checkpoint, and return. Safe from any thread."""
    _PREEMPTED.set()


def _input_kind(ds: ArrayDataset, trunk: str) -> str:
    if ds.kind == "waveform" and trunk == "none":
        raise ValueError("trunk='none' needs feature input, not raw waveforms")
    return ds.kind


def _check_supported(cfg: Config) -> None:
    t, d = cfg.train, cfg.data
    if t.model_parallel != 1:
        raise NotImplementedError(
            "train.model_parallel > 1 is not ported yet (ROADMAP.md queue A, item 9)")
    if t.data_parallel not in (-1, 1):
        raise NotImplementedError(
            f"train.data_parallel={t.data_parallel}: the port trains on one card "
            "(ROADMAP.md queue A, item 9)")
    if d.staging_dtype not in ("float32", "int16", "uint8", "adpcm4"):
        raise ValueError(f"staging_dtype must be float32|int16|uint8|adpcm4,"
                         f" got {d.staging_dtype!r}")


def _encode(x: np.ndarray, stage: str) -> np.ndarray:
    """Host-side wire form of a waveform array (float32 passes through)."""
    if stage == "uint8":
        return mulaw_encode(x)
    if stage == "int16":
        return pcm16_quantize(x)
    if stage == "adpcm4":
        return adpcm4_encode(pcm16_quantize(x))
    return np.asarray(x)


def evaluate(cfg: Config, state: TrainState, ds: ArrayDataset, eval_step,
             device: torch.device, x_device: Optional[torch.Tensor] = None,
             counts: Optional[Dict[str, int]] = None) -> Dict[str, float]:
    """Forward the eval set in batches of train.batch_size, metrics on the
    host. ``x_device``: the eval inputs already on the device, cut into
    batches there (the last window shifted back to stay in range, its
    overlap rows dropped). Otherwise each batch is uploaded, the last one
    padded to the full batch by repeating its last row. ``counts``, if
    given, has its "eval_batches" raised by one per forward batch."""
    bs = max(cfg.train.batch_size, 1)
    if x_device is not None and x_device.shape[0] < bs:
        x_device = None  # too small to cut full batches from
    outs = []
    for idx in SequentialSampler(len(ds.x), bs):
        if x_device is not None:
            start = min(int(idx[0]), x_device.shape[0] - bs)
            off = int(idx[0]) - start
            probs = eval_step(state, x_device[start:start + bs]).cpu().numpy()
            outs.append(probs[off:off + len(idx)])
        else:
            x = take_rows(ds, idx)
            pad = bs - len(idx)
            if pad:
                x = np.concatenate([x, np.repeat(x[-1:], pad, 0)])
            x_t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
            outs.append(eval_step(state, x_t).cpu().numpy()[: len(idx)])
        if counts is not None:
            counts["eval_batches"] += 1
    return calculate_stats(np.concatenate(outs), ds.y)


def fit(cfg: Config, workspace: Optional[str] = None, log: bool = True,
        auto_resume: bool = False, device=None) -> FitResult:
    """Train per ``cfg`` on ``device`` (None = the card; raises without one
    unless device="cpu"); returns the final state and the loss / eval
    history. Weights are initialized from ``train.seed`` through a
    ``torch.Generator``. ``auto_resume`` restores the latest checkpoint
    (parameters, Adam state, step, EMA, sampler position) and continues."""
    dev = resolve_device(device)
    _check_supported(cfg)
    workspace = workspace or cfg.workspace
    os.makedirs(workspace, exist_ok=True)
    logger = create_logging(os.path.join(workspace, "logs"), cfg.name) if log else None
    writer = ScalarWriter(
        os.path.join(workspace, "scalars.csv"),
        tensorboard_dir=(os.path.join(workspace, "tensorboard", cfg.name)
                         if cfg.train.tensorboard else None))

    def say(msg):
        if logger:
            logger.info(msg)

    kind = "features" if cfg.model.trunk == "none" else "waveform"
    train_ds = make_dataset(cfg.data, cfg.model.n_classes, "train", kind, cfg.frontend)
    eval_ds = make_dataset(cfg.data, cfg.model.n_classes, "eval", kind, cfg.frontend)
    input_kind = _input_kind(train_ds, cfg.model.trunk)
    stage = cfg.data.staging_dtype
    if stage != "float32" and input_kind != "waveform":
        raise ValueError("compressed staging_dtype needs waveform input "
                         "(features are not [-1,1] PCM)")

    model = build_model(cfg.model, device=dev, seed=cfg.train.seed)
    state = create_train_state(cfg, model)
    bs = cfg.train.batch_size
    clip_samples = int(train_ds.x.shape[1]) if input_kind == "waveform" else None
    train_step = make_train_step(cfg, model, input_kind, clip_samples=clip_samples)
    eval_step = make_eval_step(cfg, model, input_kind)

    use_grain = cfg.data.pipeline == "grain"
    sampler = (BalancedSampler(train_ds.y, bs, cfg.train.seed)
               if cfg.data.balanced_sampling and not use_grain else None)
    # device-resident training set: staged once in its wire form, each batch
    # gathered on the device by index (and decoded inside the train step).
    # The wire form is sized from the shapes first, so a set too large for
    # the budget is never encoded whole: it streams, encoded per batch. An
    # out-of-core set always streams: staging it would read it whole.
    is_ooc = not isinstance(train_ds.x, np.ndarray)
    if input_kind == "waveform":
        n_clip = int(train_ds.x.shape[1])
        per_row = {"float32": 4 * n_clip, "int16": 2 * n_clip, "uint8": n_clip,
                   "adpcm4": wire_length(n_clip)}[stage]
        data_bytes = per_row * int(train_ds.x.shape[0]) + int(train_ds.y.nbytes)
    else:
        data_bytes = int(train_ds.x.nbytes) + int(train_ds.y.nbytes)
    use_device_data = (cfg.data.device_resident and not use_grain and not is_ooc
                       and data_bytes <= cfg.data.device_resident_max_bytes)
    x_all = y_all = eval_x_dev = None
    if use_device_data:
        x_all = torch.from_numpy(_encode(train_ds.x, stage)).to(dev)
        y_all = torch.from_numpy(np.asarray(train_ds.y, np.float32)).to(dev)
        say(f"dataset device-resident ({data_bytes / 1e6:.0f} MB, staging={stage}); "
            "device-side batch gather" + ("" if stage == "float32" else " + decode"))
    if (cfg.data.device_resident and isinstance(eval_ds.x, np.ndarray)
            and eval_ds.x.nbytes <= cfg.data.device_resident_max_bytes):
        eval_x_dev = torch.from_numpy(np.asarray(eval_ds.x, np.float32)).to(dev)
    ckpt = CheckpointManager(os.path.join(workspace, "checkpoints", cfg.name),
                             keep=cfg.train.keep_checkpoints)
    rng = np.random.default_rng(cfg.train.seed)
    result = FitResult(state=state)
    say(f"config={cfg.name} device={dev} input={input_kind} batch={bs}")

    start_step = 0
    if auto_resume and ckpt.latest_step() is not None:
        state, sampler_st = ckpt.restore(state)
        if sampler is not None and sampler_st:
            sampler.load_state_dict(sampler_st)
        elif sampler_st and sampler_st.get("pipeline") == "random":
            # continue the host RNG's batch-draw stream where it left off
            rng.bit_generator.state = sampler_st["rng_state"]
        start_step = state.step
        say(f"auto-resumed from checkpoint at step {start_step}")

    grain_it = None
    if use_grain:
        from mla_tpu_torch.data.pipeline import make_train_iterator

        # the stream is a pure function of (seed, position): resuming starts
        # it at batch index start_step
        grain_it = make_train_iterator(train_ds, bs, cfg.train.seed, cfg.data.grain_workers,
                                       start_index=start_step)

    last_saved = -1

    def save_ckpt(step: int):
        nonlocal last_saved
        if step == last_saved:  # preempted right after a periodic save
            return
        last_saved = step
        if sampler is not None:
            samp_st = sampler.state_dict()
        elif use_grain:  # stateless: the position is the training step
            samp_st = {"pipeline": "grain", "seed": cfg.train.seed, "step": step}
        else:
            samp_st = {"pipeline": "random", "step": step, "rng_state": rng.bit_generator.state}
        ckpt.save(step, state, samp_st, config=dataclasses.asdict(cfg))

    _PREEMPTED.clear()
    prev_handlers = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, _on_preempt_signal)

    t_last = time.perf_counter()
    clips_done = 0
    try:
        for step_i in range(start_step, cfg.train.num_steps):
            if grain_it is not None:
                bx, by = next(grain_it)
                x = torch.from_numpy(_encode(bx, stage) if input_kind == "waveform"
                                     else np.asarray(bx)).to(dev)
                y = torch.from_numpy(np.asarray(by, np.float32)).to(dev)
            elif use_device_data:
                idx = sampler.next_batch() if sampler else rng.integers(0, len(train_ds.x), bs)
                idx_t = torch.from_numpy(np.asarray(idx, np.int64)).to(dev)
                x, y = x_all.index_select(0, idx_t), y_all.index_select(0, idx_t)
            else:
                idx = sampler.next_batch() if sampler else rng.integers(0, len(train_ds.x), bs)
                bx = take_rows(train_ds, idx)
                x = torch.from_numpy(_encode(bx, stage) if input_kind == "waveform"
                                     else np.asarray(bx)).to(dev)
                y = torch.from_numpy(np.asarray(train_ds.y[idx], np.float32)).to(dev)
            state, loss = train_step(state, x, y)
            result.counts["train_steps"] += 1
            clips_done += bs
            if cfg.train.debug_nans and not bool(torch.isfinite(loss)):
                raise FloatingPointError(f"non-finite loss at step {step_i + 1}")
            if (step_i + 1) % cfg.train.log_every == 0 or step_i == 0:
                loss_v = float(loss)
                dt = time.perf_counter() - t_last
                cps = clips_done / dt if dt > 0 else 0.0
                result.history.append({"step": step_i + 1, "loss": loss_v, "clips_per_sec": cps})
                writer.write(step_i + 1, {"loss": loss_v, "clips_per_sec": cps})
                say(f"step {step_i + 1} loss {loss_v:.4f} {cps:.1f} clips/s")
                t_last = time.perf_counter()
                clips_done = 0
            if (step_i + 1) % cfg.train.eval_every == 0 or step_i + 1 == cfg.train.num_steps:
                stats = evaluate(cfg, state, eval_ds, eval_step, dev, x_device=eval_x_dev,
                                 counts=result.counts)
                stats["step"] = step_i + 1
                result.eval_stats.append(stats)
                writer.write(step_i + 1, {k: v for k, v in stats.items() if k != "step"})
                say(f"eval @ {step_i + 1}: " + " ".join(f"{k}={v:.4f}" for k, v in stats.items()))
            if cfg.train.checkpoint_every > 0 and (
                    (step_i + 1) % cfg.train.checkpoint_every == 0
                    or step_i + 1 == cfg.train.num_steps):
                save_ckpt(step_i + 1)
            if _PREEMPTED.is_set():
                say(f"preemption requested: checkpointing at step {step_i + 1} and exiting")
                save_ckpt(step_i + 1)
                result.interrupted = True
                break
    finally:
        # restore the handlers even when the loop raises: a leaked handler
        # would swallow Ctrl-C for the rest of the process
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        if grain_it is not None:
            grain_it.close()  # stops the loader's workers
        ckpt.wait()
        writer.close()
    result.state = state
    return result


def resume(cfg: Config, workspace: Optional[str] = None,
           device=None) -> Tuple[TrainState, Optional[Dict]]:
    """Restore the latest checkpoint for ``cfg`` into a fresh train state on
    ``device``. Unlike the reference it needs no sample batch
    (``resume_sample``): the model's shapes follow from the config."""
    workspace = workspace or cfg.workspace
    model = build_model(cfg.model, device=device)
    mgr = CheckpointManager(os.path.join(workspace, "checkpoints", cfg.name))
    try:
        return mgr.restore(create_train_state(cfg, model))
    finally:
        mgr.close()
