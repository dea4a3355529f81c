"""One rank of the port's tensor-parallel tests (tests/test_torch_tp.py).
Imports torch and the port only.

    RANK=r WORLD_SIZE=n python -m tests.torch_tp_worker JOB STORE OUT

as ``tests/torch_dp_worker.py``: a gloo group through ``initialize``, every
case the job names, ``{case: result}`` written to OUT. The ranks form the
job's [data, model] mesh ("model" innermost).
"""

import dataclasses
import os
import sys

import torch

from mla_tpu_torch.config import get_config
from mla_tpu_torch.models.convert import flat_to_state_dict, state_dict_to_flat
from mla_tpu_torch.models.zoo import build_model
from mla_tpu_torch.parallel import distributed, tensor
from mla_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh
from mla_tpu_torch.train import checkpoint, loop
from mla_tpu_torch.train import state as tstate
from tests.torch_dp_worker import _history

CPU = torch.device("cpu")


def _model(model_cfg, flat):
    model = build_model(model_cfg, device="cpu")
    model.load_state_dict(flat_to_state_dict(flat, model))
    return model


def case_forward(job, rank):
    """Eval-mode forward of each head over the "model" group, on every
    rank (the rows are the data coordinate's, the output replicated)."""
    dp, mp = job["mesh"]
    mesh = make_mesh(dp, mp, device="cpu")
    axis = tensor.ModelAxis(group=mesh.group(MODEL_AXIS))
    d = mesh.coordinate(rank)[0]
    out = {}
    for name, spec in job["forward"].items():
        cfg = get_config("default", spec["overrides"])
        model = tensor.tensor_parallel(_model(cfg.model, spec["flat"]), axis,
                                       cfg.model.hidden_units)
        x = torch.from_numpy(spec["x"])
        per = x.shape[0] // dp
        with torch.no_grad():
            out[name] = model(x[d * per:(d + 1) * per])
    return out


def case_step(job, rank):
    """One train step per variant from the job's weights, on this rank's
    rows: the loss, and the whole parameters, gradients (Adam's first
    moment over 1 - beta1) and EMA shadow, gathered over "model"."""
    out = {}
    for name, spec in job["step"].items():
        cfg = get_config("us8k_fused_frontend", spec["overrides"])
        dp = loop.data_parallel(cfg, CPU)
        model = tensor.tensor_parallel(_model(cfg.model, spec["flat"]), dp.model,
                                       cfg.model.hidden_units)
        st = tstate.create_train_state(cfg, model)
        step = tstate.make_train_step(cfg, model, "waveform", clip_samples=spec["x"].shape[1],
                                      dp=dp)
        x, y = (torch.from_numpy(a[dp.rows]) for a in (spec["x"], spec["y"]))
        st, loss = step(st, x, y)
        beta1 = tstate.ADAM_BETAS[0]
        grads = tensor.gather_named(model, {n: st.optimizer.state[p]["exp_avg"] / (1 - beta1)
                                            for n, p in model.named_parameters()})
        out[name] = {"loss": float(loss), "rows": (dp.rows.start, dp.rows.stop),
                     "index": dp.index, "shard_names": sorted(model.tp_layout.dims),
                     "flat": state_dict_to_flat(tensor.full_state_dict(model)),
                     "grads": state_dict_to_flat(grads),
                     "ema": (None if st.ema_params is None else
                             state_dict_to_flat(tensor.gather_named(model, st.ema_params)))}
    return out


def _fit_cfg(job, **train):
    cfg = get_config("us8k_fused_frontend", job["fit"]["overrides"])
    dp, mp = job["mesh"]
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, data_parallel=dp, model_parallel=mp, **train))


def case_fit(job, rank):
    """A tensor-parallel ``fit`` with a checkpoint at its end: the history,
    the files this rank wrote, and the whole state gathered over "model"."""
    ws = job["fit"]["workspace"]
    res = loop.fit(_fit_cfg(job), workspace=ws, device="cpu")
    payload = checkpoint.train_state_payload(res.state)
    return {**_history(res), "payload": payload,
            "wrote": sorted(os.listdir(ws)) if os.path.isdir(ws) else []}


def case_restore(job, rank):
    """A checkpoint written at model_parallel 1, restored over "model":
    this rank's shards and the whole state gathered back."""
    cfg = _fit_cfg(job)
    dp = loop.data_parallel(cfg, CPU)
    state, _ = loop.resume(cfg, job["restore"]["workspace"], device="cpu", dp=dp)
    sd, lay = state.model.state_dict(), state.model.tp_layout
    return {"local": {k: sd[names[0]].clone() for k, names in lay.internal.items()},
            "payload": checkpoint.train_state_payload(state), "step": state.step}


CASES = {"forward": case_forward, "step": case_step, "fit": case_fit, "restore": case_restore}


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
