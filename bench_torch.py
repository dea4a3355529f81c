#!/usr/bin/env python3
"""Benchmark of the PyTorch port's flagship program on one NVIDIA card, the
twin of bench.py:

    python3 bench_torch.py

The measured program is the flagship forward (``mla_tpu_torch/entry.py``):
a raw waveform batch -> the log-mel front-end -> the CompactCNN trunk ->
multi-level attention -> 527 clip probabilities, on ``audioset_full_dp`` as
shipped, and its train step (BCE, Adam, the front-end at the step's
"default" precision, dropout 0.4). Both run at batch 128 x 10 s with random
weights from a seeded ``torch.Generator``, once per front-end impl: "xla"
(the torch-ops front-end, as the preset ships) and "pallas" (the fused
CUDA kernel).

Protocol (bench.py's): after a warm-up, 5 repeats of 20 back-to-back calls,
each repeat timed with CUDA events; the median repeat gives clips/s, and
(max - min) / median its spread. Prints ONE JSON line with bench.py's keys,
the shipped "xla" numbers under them and the "pallas" ones beside, plus the
card's name and power limit and the peak device memory. ``vs_baseline`` and
``cpu_reference_clips_per_sec`` are null: no CPU or TPU figure is this
port's baseline. Raises without a card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mla_tpu_torch._device import resolve_device  # noqa: E402
from mla_tpu_torch.config import Config  # noqa: E402
from mla_tpu_torch.entry import flagship_config, flagship_forward  # noqa: E402
from mla_tpu_torch.models.zoo import build_model  # noqa: E402
from mla_tpu_torch.ops import fused_frontend as ff  # noqa: E402
from mla_tpu_torch.train.state import create_train_state, make_train_step  # noqa: E402

BATCH = 128
SECONDS = 10
N_ITERS = 20
REPEATS = 5  # timed repeats; the median is the number
IMPLS = ("xla", "pallas")  # the preset's front-end first


def _repeat_seconds(run, repeats: int, device: torch.device):
    """Seconds of each of ``repeats`` calls of run(): CUDA events around
    each on the card; the host clock on the CPU, which only the tests use
    (no CPU time is reported as a device time)."""
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    return times


def measure(cfg: Config, device, batch: int = BATCH, seconds: int = SECONDS,
            n_iters: int = N_ITERS, repeats: int = REPEATS) -> dict:
    """Inference and train-step clips/s of ``cfg``'s flagship program on
    ``device``, each the median of ``repeats`` timed runs of ``n_iters``
    calls after a warm-up, with their spreads, the peak device memory, the
    calls made (warm-ups included) and the fused front-end's kernel launches
    in them: one per call for impl "pallas" on the card, none otherwise."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    wav = torch.from_numpy((rng.standard_normal((batch, seconds * cfg.frontend.sample_rate))
                            * 0.1).astype(np.float32)).to(dev)
    y = torch.from_numpy((rng.random((batch, cfg.model.n_classes)) < 0.05)
                         .astype(np.float32)).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    launches, calls = ff.LAUNCHES, 0
    model = build_model(cfg.model, device=dev, seed=0)
    forward = flagship_forward(cfg)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, "waveform")
    losses = []

    def infer(n=n_iters):
        nonlocal calls
        for _ in range(n):
            forward(model, wav)
            calls += 1

    def train(n=n_iters):
        nonlocal calls
        for _ in range(n):
            _, loss = step(state, wav, y)
            calls += 1
        losses.append(loss)

    infer(1)  # warm-up: builds the kernel, picks the library kernels
    infer_s = _repeat_seconds(infer, repeats, dev)
    train(1)  # warm-up
    train_s = _repeat_seconds(train, repeats, dev)
    final_loss = float(losses[-1])
    if not np.isfinite(final_loss):
        raise FloatingPointError(f"non-finite train loss {final_loss}")
    launches = ff.LAUNCHES - launches
    if launches != (calls if cfg.frontend.impl == "pallas" and dev.type == "cuda" else 0):
        raise RuntimeError(f"{launches} front-end kernel launches in {calls} calls "
                           f"(impl {cfg.frontend.impl!r}, {dev.type})")
    model.eval()
    infer_med, train_med = statistics.median(infer_s), statistics.median(train_s)
    return {
        "infer_clips_per_sec": batch * n_iters / infer_med,
        "train_clips_per_sec": batch * n_iters / train_med,
        "infer_rel_spread": (max(infer_s) - min(infer_s)) / infer_med,
        "train_rel_spread": (max(train_s) - min(train_s)) / train_med,
        "infer_ms_per_call": infer_med / n_iters * 1e3,
        "train_ms_per_step": train_med / n_iters * 1e3,
        "final_loss": final_loss,
        "frontend_kernel_launches": launches,
        "calls": calls,
        "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if dev.type == "cuda" else None),
    }


def result_line(cfg: Config, per_impl: dict, device: str, power_limit: str,
                batch: int = BATCH, seconds: int = SECONDS, repeats: int = REPEATS) -> dict:
    """bench.py's JSON line: the shipped front-end's numbers under its keys,
    the fused kernel's beside them."""
    shipped = per_impl[cfg.frontend.impl]
    return {
        "metric": "infer_clips_per_sec_chip",
        "value": shipped["infer_clips_per_sec"],
        "unit": "clips/s",
        "vs_baseline": None,
        "train_clips_per_sec_chip": shipped["train_clips_per_sec"],
        "cpu_reference_clips_per_sec": None,
        "repeats": repeats,
        "infer_rel_spread": shipped["infer_rel_spread"],
        "train_rel_spread": shipped["train_rel_spread"],
        "batch": batch,
        "clip_seconds": seconds,
        "model": "multi_level_attention+cnn_trunk",
        "n_classes": cfg.model.n_classes,
        "device": device,
        "power_limit": power_limit,
        "peak_memory_gb": max((r["peak_memory_gb"] or 0.0) for r in per_impl.values()),
        "frontend_impl": cfg.frontend.impl,
        "by_frontend_impl": per_impl,
    }


def main() -> int:
    dev = resolve_device(None)  # the card, or RuntimeError
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    power_limit = smi.stdout.strip().splitlines()[0].split(",")[-1].strip()
    cfg = flagship_config()
    per_impl = {}
    for impl in IMPLS:
        per_impl[impl] = measure(flagship_config(overrides={"frontend.impl": impl}), dev)
        torch.cuda.empty_cache()
    print(json.dumps(result_line(cfg, per_impl, torch.cuda.get_device_name(dev), power_limit)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
