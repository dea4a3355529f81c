"""Training traffic: one train step after another on batches gathered on the
card, by a seeded index, from a pool of clips held there, as
``train/loop.py::fit`` stages a device-resident set. Closed loop: the next
step is issued as the last is enqueued.

Set-up makes the weights, the pool and its labels from the seed, builds the
model, its optimizer state and the step (``train.state.make_train_step``),
and drives that same step through its first ``check_steps`` updates by the
window's own call and feed, on rows that all differ; those updates are also
the warm-up. The window then continues the same step. ``correct`` holds the
first updates against the reference's: each step's loss, the first
gradient's norm as Adam took it (its first moment after one update over 1 -
beta1) and the change of the parameters after them, both by the worst leaf.

The batch, the pool and the clip length are the configuration's
(train.batch_size, data.n_train_clips, data.clip_seconds). Parameters:
label_rate (the share of labels on), check_steps.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from benchmark import inputs, yardstick
from benchmark.reference import compare
from benchmark.reference import model as ref
from benchmark.tracing import span

MAX_STEPS = 2000  # index rows planned: more than any window can take


def make_inputs(r) -> dict:
    """The weights, the pool of clips and labels, the index plan and the
    dropout seed of a run, from its seed."""
    m, fe, data = r.config["model"], r.config["frontend"], r.config["data"]
    pool, bs = data["n_train_clips"], r.config["train"]["batch_size"]
    n = int(round(data["clip_seconds"] * fe["sample_rate"]))
    return {
        "weights": inputs.make_weights(m, r.seed, r.device),
        "x": inputs.make_clips(pool, n, fe["sample_rate"], r.seed, "train clips", r.device),
        "y": inputs.make_labels(pool, m["n_classes"], r.params["label_rate"], r.seed, r.device),
        "plan": inputs.index_plan(pool, bs, MAX_STEPS, r.seed).to(r.device),
        "train_seed": inputs.sub_seed(r.seed, "dropout"),
    }


def _first_batches(inp: dict, n: int) -> list:
    return [(inp["x"].index_select(0, inp["plan"][i]), inp["y"].index_select(0, inp["plan"][i]))
            for i in range(n)]


def run(r) -> dict:
    from mla_tpu_torch.models.zoo import build_model
    from mla_tpu_torch.train.state import ADAM_BETAS, create_train_state, make_train_step

    p, m, fe, tr = r.params, r.config["model"], r.config["frontend"], r.config["train"]
    dev, on = r.device, r.trace
    bs, n_check = tr["batch_size"], p["check_steps"]
    r.mark("imports")
    inp = make_inputs(r)
    r.mark("inputs")
    weights, x_pool, y_pool, plan = inp["weights"], inp["x"], inp["y"], inp["plan"]
    cfg = dataclasses.replace(r.cfg, train=dataclasses.replace(r.cfg.train,
                                                               seed=inp["train_seed"]))
    model = build_model(cfg.model, device=dev)
    model.load_state_dict(inputs.program_state_dict(weights))
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, "waveform")
    params = dict(model.named_parameters())
    r.mark("model")

    def one(s: int) -> torch.Tensor:
        with span("gather", on):
            idx = plan[s]
            x, y = x_pool.index_select(0, idx), y_pool.index_select(0, idx)
        with span("step", on):
            return step(state, x, y)[1]

    first_losses, first_moment = [], None
    for s in range(n_check):
        first_losses.append(one(s))
        if s == 0:
            first_moment = {k: state.optimizer.state[v]["exp_avg"].clone()
                            for k, v in params.items()}
    after = {k: v.detach().clone() for k, v in params.items()}
    r.mark("first steps")
    r.setup_done()

    t0 = time.perf_counter()
    deadline, s, losses, traced_from = t0 + r.seconds, n_check, [], 0
    while True:
        now = time.perf_counter()
        if now >= deadline:
            break
        if r.maybe_start_trace(now, t0):
            traced_from = len(losses)
        losses.append(one(s))
        s += 1
    r.sync()
    t1 = time.perf_counter()
    r.window_closed()
    steps = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    window_s = t1 - t0
    r.counters.update(clips_traced=(steps - traced_from) * bs,
                      flops_per_clip=yardstick.train_flops_per_clip(
                          m, fe, r.config["data"]["clip_seconds"]))
    r.note(f"{r.name}: {steps} steps of {bs} clips in {window_s:.6f} s; peak "
           f"{r.memory_peak_bytes} bytes")

    program = {
        "losses": [float(v) for v in first_losses],
        "grad_norms": {k: float(v.norm()) / (1.0 - ADAM_BETAS[0]) for k, v in first_moment.items()},
        "change_norms": {k: float((after[k] - weights[k]).norm()) for k in after},
    }
    del step, state, model, params, first_moment, after, losses
    if r.on_card:
        torch.cuda.empty_cache()
    reference = ref.train_steps(weights, _first_batches(inp, n_check), m, fe, tr,
                                inp["train_seed"])
    gaps = compare.train_gaps(program, reference)
    r.note(f"{r.name}: losses {program['losses']} against {reference['losses']}; gaps "
           f"{gaps}")
    return {
        "attempted": steps, "failed": failed,
        "metrics": {"train_clips_per_s": steps * bs / window_s},
        "checks": {k: (gaps[k], lim) for k, lim in r.limits.items()},
    }



def control(r) -> dict:
    """The readings of the control (the reference in fp8 in the program's
    place) and of a planted fault (each step on half its batch) against
    the reference, on this run's inputs."""
    m, fe, tr = r.config["model"], r.config["frontend"], r.config["train"]
    inp = make_inputs(r)
    batches = _first_batches(inp, r.params["check_steps"])
    args = (inp["weights"], batches, m, fe, tr, inp["train_seed"])
    want = ref.train_steps(*args)
    return {"control": compare.train_gaps(ref.train_steps(*args, prec="fp8"), want),
            "half_batch": compare.train_gaps(ref.train_steps(*args, half=True), want)}
