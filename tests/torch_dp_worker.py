"""One rank of the port's multi-process tests (tests/test_torch_dp.py,
tests/test_torch_sharded.py). Imports torch and the port only.

    RANK=r WORLD_SIZE=n python -m tests.torch_dp_worker JOB STORE OUT

brings up a gloo group through ``initialize`` (the process count and rank
from the environment, the store a ``file://`` URL), runs every case the
job file (``torch.save`` of a dict) names, in order, and writes
``{case: result}`` to OUT. The group is destroyed at the end.
"""

import contextlib
import dataclasses
import os
import sys

import torch

from mla_tpu_torch.config import get_config
from mla_tpu_torch.models.convert import flat_to_state_dict, state_dict_to_flat
from mla_tpu_torch.models.zoo import build_model
from mla_tpu_torch.ops import attention_pool as ap
from mla_tpu_torch.ops import augment
from mla_tpu_torch.parallel import distributed
from mla_tpu_torch.train import loop
from mla_tpu_torch.train import state as tstate

CPU = torch.device("cpu")


def case_bn(job, rank):
    """A batch norm under the group: output, input and parameter gradients
    and running statistics on this rank's rows."""
    from mla_tpu_torch.models.trunk import _BatchNormReLU, global_statistics

    x, w = (torch.from_numpy(a) for a in job["bn"]["x"])
    rows = distributed.local_batch_slice(x.shape[0])
    bn = _BatchNormReLU(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(job["bn"]["scale"]))
        bn.bias.copy_(torch.from_numpy(job["bn"]["bias"]))
    bn.train()
    xl = x[rows].clone().requires_grad_(True)
    with global_statistics(bn, torch.distributed.group.WORLD):
        y = bn(xl)
        (y * w[rows]).sum().backward()
    return {"y": y.detach(), "x_grad": xl.grad, "scale_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad, "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


@contextlib.contextmanager
def _patched_draws(draws):
    """The augmentations' draws replaced by given ones (the reference's)."""
    if draws is None:
        yield
        return
    saved = augment.mixup_draws, augment.spec_augment_draws
    augment.mixup_draws = lambda b, gen, alpha=0.5: (draws["perm"], draws["lam"])
    augment.spec_augment_draws = lambda b, frames, mels, gen, *a, **k: draws["spans"]
    try:
        yield
    finally:
        augment.mixup_draws, augment.spec_augment_draws = saved


def _one_step(spec, rank):
    cfg = get_config("us8k_fused_frontend", spec["overrides"])
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(flat_to_state_dict(spec["flat"], model))
    st = tstate.create_train_state(cfg, model)
    dp = loop.data_parallel(cfg, CPU)
    step = tstate.make_train_step(cfg, model, "waveform", clip_samples=spec["x"].shape[1],
                                  dp=dp)
    x, y = (torch.from_numpy(a[dp.rows]) for a in (spec["x"], spec["y"]))
    with _patched_draws(spec.get("draws")):
        st, loss = step(st, x, y)
    moments = {n: st.optimizer.state[p]["exp_avg"] for n, p in model.named_parameters()}
    return {"loss": float(loss), "rows": (dp.rows.start, dp.rows.stop),
            "flat": state_dict_to_flat(model.state_dict()),
            "grads": state_dict_to_flat(tstate.variables_from_state(st, moments))}


def case_step(job, rank):
    return _one_step(job["step"], rank)


def case_step_aug(job, rank):
    return _one_step(job["step_aug"], rank)


class _Writes:
    """Counts the files a rank opens for logs, scalars and checkpoints."""

    def __init__(self):
        self.n = {"scalar_writers": 0, "loggers": 0, "checkpoint_saves": 0}

    @contextlib.contextmanager
    def counting(self):
        saved = loop.ScalarWriter, loop.create_logging, loop.CheckpointManager.save
        n = self.n

        def writer(*a, **k):
            n["scalar_writers"] += 1
            return saved[0](*a, **k)

        def logging_(*a, **k):
            n["loggers"] += 1
            return saved[1](*a, **k)

        def save(mgr, *a, **k):
            n["checkpoint_saves"] += 1
            return saved[2](mgr, *a, **k)

        loop.ScalarWriter, loop.create_logging, loop.CheckpointManager.save = (
            writer, logging_, save)
        try:
            yield
        finally:
            loop.ScalarWriter, loop.create_logging, loop.CheckpointManager.save = saved


def _fit_cfg(job, **train):
    cfg = get_config("us8k_fused_frontend", job["fit"]["overrides"])
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))


def _history(res):
    return {"losses": [h["loss"] for h in res.history],
            "steps": [h["step"] for h in res.history],
            "eval": res.eval_stats, "interrupted": res.interrupted,
            "counts": dict(res.counts)}


def case_fit(job, rank):
    w = _Writes()
    with w.counting():
        res = loop.fit(_fit_cfg(job), workspace=job["fit"]["workspace"], device="cpu")
    return {**_history(res), "writes": w.n,
            "flat": state_dict_to_flat(res.state.model.state_dict())}


def case_fit_inputs(job, rank):
    """``fit`` on the other input paths: the stateless pipeline (each rank
    pulls its slice of every global batch) and the streamed feed (each
    rank reads and encodes its rows)."""
    out = {}
    for key, over in job["fit"]["inputs"].items():
        cfg = get_config("us8k_fused_frontend", {**job["fit"]["overrides"], **over})
        res = loop.fit(cfg, workspace=job["fit"]["workspace"] + "_" + key, log=False,
                       device="cpu")
        out[key] = _history(res)
    return out


def case_resume(job, rank):
    ws = job["fit"]["workspace"] + "_resume"
    n = job["fit"]["resume_at"]
    first = loop.fit(_fit_cfg(job, num_steps=n, checkpoint_every=n), workspace=ws,
                     log=False, device="cpu")
    second = loop.fit(_fit_cfg(job), workspace=ws, log=False, auto_resume=True, device="cpu")
    return {"first": _history(first), "second": _history(second)}


def case_preempt(job, rank):
    """Rank 1 asks for preemption during its step ``preempt_at``; the ranks
    agree at the next log step."""
    at = job["fit"]["preempt_at"]
    make = loop.make_train_step

    def make_signalling(*a, **k):
        step = make(*a, **k)

        def run(state, x, y):
            if rank == 1 and state.step + 1 == at:
                loop.request_preemption()
            return step(state, x, y)

        return run

    loop.make_train_step = make_signalling
    try:
        res = loop.fit(_fit_cfg(job, checkpoint_every=0, log_every=job["fit"]["log_every"]),
                       workspace=job["fit"]["workspace"] + "_preempt", log=False, device="cpu")
    finally:
        loop.make_train_step = make
    return {**_history(res), "last_step": res.state.step}


def case_psum(job, rank):
    """``psum_stream_state`` of each rank's time shard, per gate."""
    out = {}
    for act, (g, c) in job["psum"].items():
        per = g.shape[1] // distributed.process_count()
        sl = slice(rank * per, (rank + 1) * per)
        st = ap.update_stream_state(ap.init_stream_state((g.shape[0], g.shape[2])),
                                    torch.from_numpy(g[:, sl]), torch.from_numpy(c[:, sl]), act)
        out[act] = ap.stream_finalize(ap.psum_stream_state(st, None, act))
    return out


CASES = {"bn": case_bn, "step": case_step, "step_aug": case_step_aug, "fit": case_fit,
         "fit_inputs": case_fit_inputs, "resume": case_resume, "preempt": case_preempt,
         "psum": case_psum}


def main(job_path, store, out_path):
    torch.set_num_threads(2)
    job = torch.load(job_path, weights_only=False)
    assert distributed.initialize(coordinator_address=store, backend="gloo")
    rank = distributed.process_index()
    try:
        out = {case: CASES[case](job, rank) for case in job["cases"]}
        torch.save(out, out_path)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "2")
    main(*sys.argv[1:4])
