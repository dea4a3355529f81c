"""Batch tagging traffic: the flagship forward (``entry.flagship_forward``,
the model in eval mode as ``entry.entry()`` builds it) called back to back
on batches from a pool made on the card at set-up. Closed loop: the next
call is issued as the last is enqueued.

``correct`` holds the probabilities of a sample of the window's calls,
drawn from the seed, and of its last call, against the reference's for the
same batch.

The clip length is the configuration's. Parameters: batch, pool_batches,
keep_every (about one call in this many is kept for the check).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import inputs, yardstick
from benchmark.reference import compare
from benchmark.reference import model as ref
from benchmark.tracing import span


def make_inputs(r) -> dict:
    """The weights and the pool of batches of a run, from its seed."""
    p, fe = r.params, r.config["frontend"]
    bs, n_pool = p["batch"], p["pool_batches"]
    n = int(round(r.config["data"]["clip_seconds"] * fe["sample_rate"]))
    return {"weights": inputs.make_weights(r.config["model"], r.seed, r.device),
            "pool": inputs.make_clips(n_pool * bs, n, fe["sample_rate"], r.seed, "tag clips",
                                      r.device).view(n_pool, bs, n)}


def run(r) -> dict:
    from mla_tpu_torch.entry import flagship_forward
    from mla_tpu_torch.models.zoo import build_model

    p, m, fe = r.params, r.config["model"], r.config["frontend"]
    dev, on = r.device, r.trace
    bs, n_pool = p["batch"], p["pool_batches"]
    seconds = r.config["data"]["clip_seconds"]
    r.mark("imports")
    inp = make_inputs(r)
    r.mark("inputs")
    weights, pool = inp["weights"], inp["pool"]
    model = build_model(r.cfg.model, device=dev)
    model.load_state_dict(inputs.program_state_dict(weights))
    model.eval()
    forward = flagship_forward(r.cfg)
    offset = int(np.random.default_rng(inputs.sub_seed(r.seed, "keep")).integers(p["keep_every"]))
    r.mark("model")
    forward(model, pool[0])  # warm-up: the one shape the window uses
    r.mark("warm-up")
    r.setup_done()

    t0 = time.perf_counter()
    deadline, i, kept, last, traced_from = t0 + r.seconds, 0, [], None, 0
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if r.maybe_start_trace(now, t0):
            traced_from = i
        with span("forward", on):
            last = forward(model, pool[i % n_pool])
        if i % p["keep_every"] == offset:
            kept.append((i % n_pool, last))
        i += 1
    r.sync()
    t1 = time.perf_counter()
    r.window_closed()
    kept.append(((i - 1) % n_pool, last))
    window_s = t1 - t0
    failed = sum(int(not bool(torch.isfinite(o).all())) for _, o in kept)
    r.counters.update(clips_traced=(i - traced_from) * bs,
                      flops_per_clip=yardstick.tag_flops_per_clip(m, fe, seconds))
    r.note(f"{r.name}: {i} calls of {bs} clips in {window_s:.6f} s; {len(kept)} kept; peak "
           f"{r.memory_peak_bytes} bytes")

    del model, forward
    if r.on_card:
        torch.cuda.empty_cache()
    refs = {b: ref.tag(pool[b], weights, m, fe) for b in sorted({b for b, _ in kept})}
    gap = max(compare.max_abs_gap(o, refs[b]) for b, o in kept)
    return {"attempted": i, "failed": failed,
            "metrics": {"tag_clips_per_s": i * bs / window_s},
            "checks": {"prob_gap": (gap, r.limits["prob_gap"])}}


def control(r) -> dict:
    """The readings of the control (the reference in fp8 in the program's
    place) and of a planted fault (half of each batch left out, the mean of
    the rest in its place) against the reference, on this run's pool."""
    m, fe = r.config["model"], r.config["frontend"]
    inp = make_inputs(r)
    gaps = {"control": 0.0, "half_batch": 0.0}
    for batch in inp["pool"]:
        want = ref.tag(batch, inp["weights"], m, fe)
        half = want.clone()
        half[half.shape[0] // 2:] = want[: half.shape[0] // 2].mean(0)
        got = {"control": ref.tag(batch, inp["weights"], m, fe, prec="fp8"), "half_batch": half}
        for k, v in got.items():
            gaps[k] = max(gaps[k], compare.max_abs_gap(v, want))
    return {k: {"prob_gap": v} for k, v in gaps.items()}
