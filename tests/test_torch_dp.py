"""Data parallelism of the PyTorch port, on two CPU ranks over gloo: the
data-parallel train step at global batch 8 (4 rows a rank) against JAX's
single-device step on the whole batch (what the reference's pjit step
computes), with and without mixup + SpecAugment; batch norm's global-batch
moments and gradients against the module on the concatenated batch; a
2-rank ``fit`` against the single-process ``fit``, with only rank 0
writing; checkpoint and resume across the ranks; and preemption of one
rank agreed by both. One launch of the two ranks (tests/torch_dp_worker.py)
runs every case."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import csv  # noqa: E402
import os  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.config import get_config as jax_get_config  # noqa: E402
from mla_tpu.models.convert import params_to_flat  # noqa: E402
from mla_tpu.models.zoo import build_model as jax_build_model  # noqa: E402
from mla_tpu.train import state as jstate  # noqa: E402
from mla_tpu_torch.config import get_config  # noqa: E402
from mla_tpu_torch.models.convert import flat_to_state_dict, state_dict_to_flat  # noqa: E402
from mla_tpu_torch.models.zoo import build_model  # noqa: E402
from mla_tpu_torch.models.trunk import _BatchNormReLU  # noqa: E402
from mla_tpu_torch.train import loop  # noqa: E402
from mla_tpu_torch.train import state as tstate  # noqa: E402
from tests.test_torch_augment import _jax_span_draws  # noqa: E402
from tests.torch_dp_worker import _patched_draws  # noqa: E402
from tests.torch_port_common import launch_ranks  # noqa: E402

B, N_SAMPLES = 8, 32000  # the global batch: 4 rows on each of the 2 ranks
# dropout 0: JAX's masks come from another generator (the port's dropout
# under data parallelism is held by the fit case, against the port)
STEP = {"model.conv_channels": "8,16", "model.convs_per_stage": 1, "model.embed_dim": 32,
        "model.hidden_units": 64, "model.n_classes": 8, "model.compute_dtype": "float32",
        "model.dropout_rate": 0.0, "data.clip_seconds": 2.0, "train.batch_size": B,
        "frontend.impl": "xla"}
AUG = {"train.mixup_alpha": 0.4, "train.spec_augment": True}
TOL = 1e-5  # loss, parameters and running statistics, f32
# gradients: f32 sums in another order (the ranks' halves, then their
# mean), within 2e-4 of the tensor's largest, as tests/test_torch_train.py
GRAD_ATOL, GRAD_RTOL = 1e-7, 2e-4
DECIDED = 100 * tstate.ADAM_EPS  # below, Adam's first step is rounding noise
FIT = {"model.conv_channels": "8,16", "model.convs_per_stage": 1, "model.embed_dim": 32,
       "model.hidden_units": 64, "model.n_classes": 8, "model.compute_dtype": "float32",
       "model.dropout_rate": 0.2, "data.clip_seconds": 1.0, "data.n_train_clips": 16,
       "data.n_eval_clips": 8, "train.batch_size": 4, "train.num_steps": 6,
       "train.log_every": 1, "train.eval_every": 3, "train.checkpoint_every": 3}


# the other input paths, 3 steps each: the stateless DataLoader pipeline, and
# the streamed feed on the adpcm4 wire (read and encoded per rank)
INPUTS = {"grain": {"data.pipeline": "grain", "train.num_steps": 3},
          "streamed": {"data.device_resident": False, "data.staging_dtype": "adpcm4",
                       "train.num_steps": 3}}


def _flat_jax(params, batch_stats=None):
    flat = params_to_flat(jax.tree.map(np.asarray, dict(params)), prefix="params/")
    if batch_stats:
        flat.update(params_to_flat(jax.tree.map(np.asarray, dict(batch_stats)),
                                   prefix="batch_stats/"))
    return flat


def _jax_step(overrides, x, y):
    """JAX's single-device step on the global batch: (initial flat
    weights, state after, loss, the step's augmentation draws)."""
    jcfg = jax_get_config("us8k_fused_frontend", overrides)
    jmodel = jax_build_model(jcfg.model)
    jst = jstate.create_train_state(jcfg, jmodel, jnp.zeros((B, 2, 96, 64), jnp.float32))
    flat = _flat_jax(jst.params, jst.batch_stats)
    rng = jax.random.fold_in(jst.dropout_key, 0)
    kperm, klam = jax.random.split(jax.random.fold_in(rng, 2))
    lam = np.asarray(jax.random.beta(klam, 0.4, 0.4, (B,)))
    draws = {"perm": torch.from_numpy(np.asarray(jax.random.permutation(kperm, B), np.int64)),
             "lam": torch.from_numpy(np.maximum(lam, 1.0 - lam)),
             "spans": _jax_span_draws(jax.random.fold_in(rng, 1), B, 96, 64, 2,
                                      jcfg.train.time_mask_width, 2,
                                      jcfg.train.freq_mask_width)}
    step = jax.jit(jstate.make_train_step(jcfg, jmodel, "waveform", clip_samples=N_SAMPLES))
    jst, loss = step(jst, jnp.asarray(x), jnp.asarray(y))
    return flat, jst, float(loss), draws


def _adam_mu(opt_state):
    states = jax.tree.leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
    return next(s.mu for s in states if isinstance(s, optax.ScaleByAdamState))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(11)
    x = (0.1 * rng.standard_normal((B, N_SAMPLES))).astype(np.float32)
    y = (rng.random((B, 8)) < 0.3).astype(np.float32)
    ref = {}
    job = {"cases": ["bn", "step", "step_aug", "fit", "fit_inputs", "resume", "preempt"]}
    for case, over in (("step", STEP), ("step_aug", {**STEP, **AUG})):
        flat, jst, loss, draws = _jax_step(over, x, y)
        ref[case] = (jst, loss)
        job[case] = {"overrides": over, "flat": flat, "x": x, "y": y,
                     **({"draws": draws} if case == "step_aug" else {})}
    bx = rng.standard_normal((8, 4, 5, 6)).astype(np.float32) * 2 + 0.5
    job["bn"] = {"x": (bx, rng.standard_normal(bx.shape).astype(np.float32)),
                 "scale": rng.uniform(0.5, 1.5, 4).astype(np.float32),
                 "bias": rng.standard_normal(4).astype(np.float32)}
    job["fit"] = {"overrides": FIT, "workspace": str(tmp / "ws"), "resume_at": 3,
                  "preempt_at": 3, "log_every": 2, "inputs": INPUTS}
    ranks = launch_ranks(job, tmp)
    return {"ranks": ranks, "ref": ref, "job": job, "tmp": tmp}


def _single_process_grads(spec):
    """The port's one-process step on the whole batch (the same draws):
    its gradients, as Adam's first moments over 1 - beta1."""
    cfg = get_config("us8k_fused_frontend", spec["overrides"])
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(flat_to_state_dict(spec["flat"], model))
    st = tstate.create_train_state(cfg, model)
    step = tstate.make_train_step(cfg, model, "waveform", clip_samples=N_SAMPLES)
    with _patched_draws(spec.get("draws")):
        st, _ = step(st, torch.from_numpy(spec["x"]), torch.from_numpy(spec["y"]))
    moments = {n: st.optimizer.state[p]["exp_avg"] for n, p in model.named_parameters()}
    return state_dict_to_flat(tstate.variables_from_state(st, moments))


@pytest.mark.parametrize("case", ["step", "step_aug"])
def test_dp_step_equals_jax_step_at_the_global_batch(run, case):
    """Loss, parameters and running statistics after one step on 2 x 4 rows
    against JAX's step on the 8 rows (with mixup and SpecAugment: the port
    fed JAX's draws for the global batch); the gradients against the
    port's one-process step on the 8 rows and, without augmentation,
    against JAX's. (SpecAugment fills its masks with one value, so max
    pooling meets ties, which XLA and PyTorch route to different elements:
    the augmented gradients differ from JAX's by ~0.2 % of a tensor's
    largest, in the port's one-process step as much as in this one.)"""
    jst, ref_loss = run["ref"][case]
    r0, r1 = (r[case] for r in run["ranks"])
    single = _single_process_grads(run["job"][case])
    for k, g in single.items():
        np.testing.assert_allclose(r0["grads"][k], g, rtol=0,
                                   atol=GRAD_ATOL + GRAD_RTOL * np.abs(g).max(),
                                   err_msg=f"gradient {k} against the one-process step")
    assert (r0["rows"], r1["rows"]) == ((0, 4), (4, 8))
    assert r0["loss"] == r1["loss"]  # the all-reduced global loss
    np.testing.assert_allclose(r0["loss"], ref_loss, rtol=TOL, atol=0)
    for k in r0["flat"]:  # every rank ends the step with the same state
        np.testing.assert_array_equal(r0["flat"][k], r1["flat"][k], err_msg=k)
    init = run["job"][case]["flat"]
    lr = tstate.lr_schedule(get_config("us8k_fused_frontend", STEP))(0)
    params, beta1 = _flat_jax(jst.params), tstate.ADAM_BETAS[0]
    for k, mu in _flat_jax(_adam_mu(jst.opt_state)).items():
        g = mu / (1 - beta1)
        if case == "step":
            np.testing.assert_allclose(r0["grads"][k] / (1 - beta1), g, rtol=0,
                                       atol=GRAD_ATOL + GRAD_RTOL * np.abs(g).max(),
                                       err_msg=f"gradient {k}")
        decided = np.abs(g) >= DECIDED
        np.testing.assert_allclose(r0["flat"][k][decided], params[k][decided], rtol=0,
                                   atol=TOL, err_msg=f"params {k}")
        assert np.all(np.abs(r0["flat"][k] - init[k])[~decided] <= lr * (1 + 1e-6) + 1e-7), k
    for k, v in _flat_jax({}, jst.batch_stats).items():
        np.testing.assert_allclose(r0["flat"][k], v, rtol=0, atol=TOL, err_msg=k)


def test_batch_norm_takes_the_global_batch_moments(run):
    """Under the group each rank's rows are normalized with the 8-row
    moments: outputs and input gradients equal the module's on the
    concatenated batch, the ranks' parameter gradients sum to its, and
    both ranks' running statistics equal its."""
    spec = run["job"]["bn"]
    x, w = (torch.from_numpy(a) for a in spec["x"])
    bn = _BatchNormReLU(4)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(spec["scale"]))
        bn.bias.copy_(torch.from_numpy(spec["bias"]))
    bn.train()
    xg = x.clone().requires_grad_(True)
    y = bn(xg)
    (y * w).sum().backward()
    r0, r1 = (r["bn"] for r in run["ranks"])
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([r0["y"], r1["y"]]), y.detach(), **tol)
    torch.testing.assert_close(torch.cat([r0["x_grad"], r1["x_grad"]]), xg.grad, **tol)
    torch.testing.assert_close(r0["scale_grad"] + r1["scale_grad"], bn.weight.grad, **tol)
    torch.testing.assert_close(r0["bias_grad"] + r1["bias_grad"], bn.bias.grad, **tol)
    for r in (r0, r1):
        torch.testing.assert_close(r["running_mean"], bn.running_mean, rtol=0, atol=1e-7)
        torch.testing.assert_close(r["running_var"], bn.running_var, rtol=0, atol=1e-7)


def _scalars(path):
    with open(path) as fh:
        return [(int(r["step"]), r["key"], float(r["value"])) for r in csv.DictReader(fh)
                if r["key"] != "clips_per_sec"]


def test_dp_fit_equals_single_process_fit(run):
    """Six steps with dropout and two evals on 2 ranks: scalars.csv (loss and
    eval metrics) within 1e-5 of the single-process fit's, every rank with
    the same history and weights, and only rank 0 writing logs, scalars and
    checkpoints."""
    r0, r1 = (r["fit"] for r in run["ranks"])
    cfg = get_config("us8k_fused_frontend", FIT)
    ws = run["tmp"] / "single"
    single = loop.fit(cfg, workspace=str(ws), device="cpu")
    got, want = _scalars(os.path.join(run["job"]["fit"]["workspace"], "scalars.csv")), \
        _scalars(ws / "scalars.csv")
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want], rtol=1e-5, atol=1e-5)
    assert r0["losses"] == r1["losses"] and r0["eval"] == r1["eval"]
    assert r0["counts"] == r1["counts"] == {"train_steps": 6, "eval_batches": 2 * 2}
    for k in r0["flat"]:
        np.testing.assert_array_equal(r0["flat"][k], r1["flat"][k], err_msg=k)
    for k, v in state_dict_to_flat(single.state.model.state_dict()).items():
        np.testing.assert_allclose(r0["flat"][k], v, rtol=0, atol=1e-5, err_msg=k)
    assert r0["writes"] == {"scalar_writers": 1, "loggers": 1, "checkpoint_saves": 2}
    assert r1["writes"] == {"scalar_writers": 0, "loggers": 0, "checkpoint_saves": 0}


@pytest.mark.parametrize("path", list(INPUTS))
def test_dp_fit_input_paths_equal_single_process(run, path):
    """Each rank takes its slice of every global batch on the stateless
    pipeline and on the streamed adpcm4 feed: the losses and eval stats of
    the single-process fit on the same path."""
    cfg = get_config("us8k_fused_frontend", {**FIT, **INPUTS[path]})
    single = loop.fit(cfg, workspace=str(run["tmp"] / f"single_{path}"), log=False,
                      device="cpu")
    got = [r["fit_inputs"][path] for r in run["ranks"]]
    assert got[0] == got[1]
    assert got[0]["steps"] == [h["step"] for h in single.history] == [1, 2, 3]
    np.testing.assert_allclose(got[0]["losses"], [h["loss"] for h in single.history],
                               rtol=1e-5, atol=1e-5)
    for k, v in single.eval_stats[-1].items():
        np.testing.assert_allclose(got[0]["eval"][-1][k], v, rtol=1e-5, atol=1e-5, err_msg=k)


def test_dp_checkpoint_resume_equals_uninterrupted(run):
    """3 steps and a checkpoint, then auto_resume to 6: the resumed steps'
    losses equal the uninterrupted 2-rank run's, on both ranks."""
    full = run["ranks"][0]["fit"]
    for r in run["ranks"]:
        rec = r["resume"]
        assert rec["first"]["steps"] == [1, 2, 3] and rec["second"]["steps"] == [4, 5, 6]
        np.testing.assert_allclose(rec["second"]["losses"], full["losses"][3:],
                                   rtol=1e-6, atol=1e-7)
    assert run["ranks"][0]["resume"] == run["ranks"][1]["resume"]


def test_dp_preemption_of_one_rank_stops_both(run):
    """Rank 1 alone is signalled during step 3; both ranks agree at the log
    step 4, checkpoint there (rank 0 writes it) and return interrupted."""
    for r in run["ranks"]:
        rec = r["preempt"]
        assert rec["interrupted"] is True and rec["last_step"] == 4, rec
    from mla_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(os.path.join(run["job"]["fit"]["workspace"] + "_preempt",
                                         "checkpoints", "us8k_fused_frontend"))
    assert mgr.steps() == [4]
