"""Train / eval loop (counterpart of ``mla_tpu/train/loop.py``), on one
device, or data parallel over a process group (one rank per process,
``parallel/distributed.py``'s ``initialize`` first).

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
SIGINT.

Data parallel (``train.data_parallel`` -1 or the group's size): every rank
builds the same weights from ``train.seed``, draws the same index stream
and takes its ``local_batch_slice`` rows of each batch (the resident set is
whole on every rank, as the reference's ``put_replicated`` has it; a
streamed batch is read and encoded per rank; the stateless pipeline yields
each rank's slice). The step is the global-batch step
(``train.state.DataParallel``): global batch-norm moments, augmentations
drawn for the global batch, gradients and loss averaged in one all-reduce.
Eval forwards each rank's rows of every batch and sums the zero-padded
scores over the ranks. Only the primary rank writes logs, scalars,
TensorBoard and checkpoints; resume reads after a barrier; preemption is
agreed by an all-reduce MAX of the flag at the log cadence.

Tensor parallel (``train.model_parallel`` > 1, in a process group whose
ranks form a [data, model] grid, "model" innermost): every rank builds the
whole model from ``train.seed`` and ``parallel.tensor.tensor_parallel``
keeps its shards over the rank's "model" group; the ranks of one model
group take the same rows (their data coordinate's), and the data axis is
the data-parallel one above. Checkpoints hold whole arrays, gathered over
"model" before the primary writes (``train/checkpoint.py``), so a run
resumes at any ``model_parallel``. The reference refuses tensor
parallelism on more than one process; the port's multi-card ``fit`` is
one process per card, so its tensor parallelism is over the processes.
In one process ``model_parallel`` > 1 raises ``make_mesh``'s
``ValueError`` (one device), as the reference does on one device.
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
import torch.distributed as dist

from mla_tpu_torch._device import resolve_device
from mla_tpu_torch.config import Config
from mla_tpu_torch.data.adpcm import adpcm4_encode, wire_length
from mla_tpu_torch.data.audio_io import mulaw_encode, pcm16_quantize
from mla_tpu_torch.data.ooc import take_rows
from mla_tpu_torch.data.sampler import BalancedSampler, SequentialSampler
from mla_tpu_torch.data.synthetic import ArrayDataset, make_dataset
from mla_tpu_torch.models.zoo import build_model
from mla_tpu_torch.parallel import distributed, tensor
from mla_tpu_torch.parallel import mesh as pmesh
from mla_tpu_torch.parallel.distributed import gather_rows
from mla_tpu_torch.train.checkpoint import CheckpointManager, train_state_payload
from mla_tpu_torch.train.state import (
    DataParallel,
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
    d = cfg.data
    if d.staging_dtype not in ("float32", "int16", "uint8", "adpcm4"):
        raise ValueError(f"staging_dtype must be float32|int16|uint8|adpcm4,"
                         f" got {d.staging_dtype!r}")


def data_parallel(cfg: Config, device: torch.device) -> Optional[DataParallel]:
    """This rank's part of the process group's [data, model] mesh, or None
    in a single process. Either way ``train.data_parallel`` /
    ``model_parallel`` go through ``make_mesh`` first, so a size the world
    cannot supply raises the reference's ``ValueError``; so does a batch the
    data axis does not divide. The rows and the data group follow the
    rank's data coordinate; with ``model_parallel`` > 1 ``model`` is the
    axis over the rank's "model" group."""
    t = cfg.train
    in_group = dist.is_initialized()
    mesh = pmesh.make_mesh(t.data_parallel, t.model_parallel,
                           devices=None if in_group else [device], device=device)
    n, mp = mesh.shape[pmesh.DATA_AXIS], mesh.shape[pmesh.MODEL_AXIS]
    if t.batch_size % n:
        raise ValueError(f"batch_size {t.batch_size} not divisible by data-parallel {n}")
    if not in_group:
        return None
    return DataParallel(group=mesh.group(pmesh.DATA_AXIS), size=n,
                        rows=distributed.local_batch_slice(t.batch_size, mp),
                        global_batch=t.batch_size,
                        index=mesh.coordinate(distributed.process_index())[0],
                        model=(tensor.ModelAxis(group=mesh.group(pmesh.MODEL_AXIS))
                               if mp > 1 else None))


def build_parallel_model(cfg: Config, device: torch.device, dp: Optional[DataParallel],
                         seed: Optional[int] = None):
    """The model on ``device``, tensor parallel over ``dp.model`` when there
    is one: every rank builds the whole model (``seed`` draws the same
    weights on each) and keeps its shards."""
    model = build_model(cfg.model, device=device, seed=seed)
    if dp is not None and dp.model is not None:
        model = tensor.tensor_parallel(model, dp.model, cfg.model.hidden_units)
    return model


def _encode(x: np.ndarray, stage: str) -> np.ndarray:
    """Host-side wire form of a waveform array (float32 passes through)."""
    if stage == "uint8":
        return mulaw_encode(x)
    if stage == "int16":
        return pcm16_quantize(x)
    if stage == "adpcm4":
        return adpcm4_encode(pcm16_quantize(x))
    return np.asarray(x)


def eval_scores(cfg: Config, state: TrainState, ds: ArrayDataset, eval_step,
                device: torch.device, x_device: Optional[torch.Tensor] = None,
                counts: Optional[Dict[str, int]] = None,
                dp: Optional[DataParallel] = None) -> np.ndarray:
    """Forward the eval set in batches of train.batch_size -> scores [N, C]
    on the host. ``x_device``: the eval inputs already on the device, cut
    into batches there (the last window shifted back to stay in range, its
    overlap rows dropped). Otherwise each batch is uploaded, the last one
    padded to the full batch by repeating its last row. With ``dp`` each
    rank forwards its rows of every batch and the batch's scores are summed
    over the ranks in a zeroed [batch, C] buffer, so every rank returns
    them all. ``counts``, if given, has its "eval_batches" raised by one
    per forward batch."""
    bs = max(cfg.train.batch_size, 1)
    rows = slice(None) if dp is None else dp.rows
    if x_device is not None and x_device.shape[0] < bs:
        x_device = None  # too small to cut full batches from

    def forward(x_local):
        probs = eval_step(state, x_local)
        if dp is not None:
            probs = gather_rows(probs, rows, bs, dp.group)
        return probs.cpu().numpy()

    outs = []
    for idx in SequentialSampler(len(ds.x), bs):
        if x_device is not None:
            start = min(int(idx[0]), x_device.shape[0] - bs)
            off = int(idx[0]) - start
            outs.append(forward(x_device[start:start + bs][rows])[off:off + len(idx)])
        else:
            x = take_rows(ds, idx)
            pad = bs - len(idx)
            if pad:
                x = np.concatenate([x, np.repeat(x[-1:], pad, 0)])
            x_t = torch.from_numpy(np.ascontiguousarray(x[rows], np.float32)).to(device)
            outs.append(forward(x_t)[: len(idx)])
        if counts is not None:
            counts["eval_batches"] += 1
    return np.concatenate(outs)


def evaluate(cfg: Config, state: TrainState, ds: ArrayDataset, eval_step,
             device: torch.device, x_device: Optional[torch.Tensor] = None,
             counts: Optional[Dict[str, int]] = None,
             dp: Optional[DataParallel] = None) -> Dict[str, float]:
    """:func:`eval_scores`, then the metrics on the host."""
    return calculate_stats(eval_scores(cfg, state, ds, eval_step, device, x_device, counts, dp),
                           ds.y)


def fit(cfg: Config, workspace: Optional[str] = None, log: bool = True,
        auto_resume: bool = False, device=None) -> FitResult:
    """Train per ``cfg`` on ``device`` (None = the card; raises without one
    unless device="cpu"); returns the final state and the loss / eval
    history. Weights are initialized from ``train.seed`` through a
    ``torch.Generator``. ``auto_resume`` restores the latest checkpoint
    (parameters, Adam state, step, EMA, sampler position) and continues.

    In a process group each rank calls ``fit`` with the same ``cfg`` and
    trains its part of every global batch (see the module docstring);
    every rank returns the same state and history."""
    dev = resolve_device(device)
    _check_supported(cfg)
    dp = data_parallel(cfg, dev)
    primary = distributed.is_primary()
    workspace = workspace or cfg.workspace
    os.makedirs(workspace, exist_ok=True)
    logger = (create_logging(os.path.join(workspace, "logs"), cfg.name)
              if log and primary else None)
    writer = ScalarWriter(
        os.path.join(workspace, "scalars.csv"),
        tensorboard_dir=(os.path.join(workspace, "tensorboard", cfg.name)
                         if cfg.train.tensorboard else None)) if primary else None

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

    model = build_parallel_model(cfg, dev, dp, seed=cfg.train.seed)
    tp = dp is not None and dp.model is not None
    state = create_train_state(cfg, model)
    bs = cfg.train.batch_size
    clip_samples = int(train_ds.x.shape[1]) if input_kind == "waveform" else None
    train_step = make_train_step(cfg, model, input_kind, clip_samples=clip_samples, dp=dp)
    rows = slice(None) if dp is None else dp.rows
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
    say(f"config={cfg.name} device={dev} input={input_kind} batch={bs}"
        + ("" if dp is None else f" data_parallel={dp.size}")
        + (f" model_parallel={dp.model.size}" if tp else ""))

    start_step = 0
    if auto_resume and dp is not None:
        dist.barrier()  # no rank reads while another might still write
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
        grain_it = make_train_iterator(
            train_ds, bs, cfg.train.seed, cfg.data.grain_workers, start_index=start_step,
            host_index=0 if dp is None else dp.index, host_count=1 if dp is None else dp.size)

    last_saved = -1

    def save_ckpt(step: int):
        nonlocal last_saved
        if step == last_saved:
            return
        last_saved = step
        # tensor parallel: every rank joins the gathers of the whole arrays
        full = train_state_payload(state) if tp else None
        if not primary:  # not the writing rank
            return
        if sampler is not None:
            samp_st = sampler.state_dict()
        elif use_grain:  # stateless: the position is the training step
            samp_st = {"pipeline": "grain", "seed": cfg.train.seed, "step": step}
        else:
            samp_st = {"pipeline": "random", "step": step, "rng_state": rng.bit_generator.state}
        ckpt.save(step, state, samp_st, config=dataclasses.asdict(cfg), payload=full)

    _PREEMPTED.clear()
    prev_handlers = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, _on_preempt_signal)

    def preempt_agreed(step: int) -> bool:
        if dp is None:
            return _PREEMPTED.is_set()
        # ranks may be signalled at different steps; acting on a local flag
        # would split the collectives' order, so every rank of the group
        # agrees, at a cadence every rank keeps, on whether any was signalled
        if step % cfg.train.log_every and step != cfg.train.num_steps:
            return False
        flag = torch.tensor([float(_PREEMPTED.is_set())], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item() > 0)

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
                idx_t = torch.from_numpy(np.asarray(idx[rows], np.int64)).to(dev)
                x, y = x_all.index_select(0, idx_t), y_all.index_select(0, idx_t)
            else:
                idx = sampler.next_batch() if sampler else rng.integers(0, len(train_ds.x), bs)
                idx = idx[rows]
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
                if writer:
                    writer.write(step_i + 1, {"loss": loss_v, "clips_per_sec": cps})
                say(f"step {step_i + 1} loss {loss_v:.4f} {cps:.1f} clips/s")
                t_last = time.perf_counter()
                clips_done = 0
            if (step_i + 1) % cfg.train.eval_every == 0 or step_i + 1 == cfg.train.num_steps:
                stats = evaluate(cfg, state, eval_ds, eval_step, dev, x_device=eval_x_dev,
                                 counts=result.counts, dp=dp)
                stats["step"] = step_i + 1
                result.eval_stats.append(stats)
                if writer:
                    writer.write(step_i + 1, {k: v for k, v in stats.items() if k != "step"})
                say(f"eval @ {step_i + 1}: " + " ".join(f"{k}={v:.4f}" for k, v in stats.items()))
            if cfg.train.checkpoint_every > 0 and (
                    (step_i + 1) % cfg.train.checkpoint_every == 0
                    or step_i + 1 == cfg.train.num_steps):
                save_ckpt(step_i + 1)
            if preempt_agreed(step_i + 1):
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
        if writer:
            writer.close()
    result.state = state
    return result


def resume(cfg: Config, workspace: Optional[str] = None, device=None,
           dp: Optional[DataParallel] = None) -> Tuple[TrainState, Optional[Dict]]:
    """Restore the latest checkpoint for ``cfg`` into a fresh train state on
    ``device`` (tensor parallel over ``dp.model`` when there is one: each
    rank takes its slices). Unlike the reference it needs no sample batch
    (``resume_sample``): the model's shapes follow from the config."""
    workspace = workspace or cfg.workspace
    model = build_parallel_model(cfg, resolve_device(device), dp)
    mgr = CheckpointManager(os.path.join(workspace, "checkpoints", cfg.name))
    try:
        return mgr.restore(create_train_state(cfg, model))
    finally:
        mgr.close()
