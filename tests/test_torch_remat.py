"""remat_trunk in the PyTorch port (models/zoo.py: torch.utils.checkpoint
around the trunk): one train step with it on equals the step with it off,
gradients, parameters and batch-norm running statistics included (the
re-run forward must not move the statistics a second time), and equals JAX's
step with nn.remat from the same weights."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.models.zoo import build_model as jax_build_model  # noqa: E402
from mla_tpu.train import state as jstate  # noqa: E402
from mla_tpu_torch.models.convert import flat_to_state_dict  # noqa: E402
from mla_tpu_torch.models.zoo import build_model  # noqa: E402
from mla_tpu_torch.train import state as tstate  # noqa: E402
from tests.test_torch_train import (  # noqa: E402
    B,
    LOSS_RTOL,
    N_SAMPLES,
    _check_first_step,
    _configs,
    _flat_jax,
)

REMAT_TOL = 1e-6  # remat against no remat, f32: the same ops run again


def _batch(seed=6):
    rng = np.random.default_rng(seed)
    x = (0.1 * rng.standard_normal((B, N_SAMPLES))).astype(np.float32)
    y = (rng.random((B, 8)) < 0.3).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _step(remat: bool, x, y, norm="batch"):
    """One train step from seed-0 weights: (loss, grads, state_dict, trunk
    forward calls)."""
    _, tcfg = _configs({"frontend.impl": "xla", "model.remat_trunk": remat,
                        "model.dropout_rate": 0.3})
    model = build_model(tcfg.model, device="cpu", seed=0)
    calls = []
    model.trunk_module.register_forward_pre_hook(lambda *_: calls.append(1))
    st = tstate.create_train_state(tcfg, model)
    _, loss = tstate.make_train_step(tcfg, model, "waveform")(st, x, y)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return float(loss), grads, {k: v.clone() for k, v in model.state_dict().items()}, len(calls)


def test_remat_step_equals_the_plain_step():
    x, y = _batch()
    plain, remat = _step(False, x, y), _step(True, x, y)
    assert plain[3] == 1 and remat[3] == 2  # the trunk's forward ran again in the backward
    assert abs(plain[0] - remat[0]) <= REMAT_TOL
    for k, g in plain[1].items():
        np.testing.assert_allclose(remat[1][k].numpy(), g.numpy(), rtol=0, atol=REMAT_TOL,
                                   err_msg=f"gradient {k}")
    stats = [k for k in plain[2] if "running" in k]
    assert stats  # the trunk has batch norm
    for k, v in plain[2].items():  # parameters after Adam, running statistics
        np.testing.assert_allclose(remat[2][k].numpy(), v.numpy(), rtol=0, atol=REMAT_TOL,
                                   err_msg=k)
    init = build_model(_configs({})[1].model, device="cpu", seed=0).state_dict()
    assert all(not torch.equal(remat[2][k], init[k]) for k in stats)  # the first pass moved them


def test_remat_is_skipped_without_autograd():
    """Under no_grad (eval, serving, export) the trunk runs once."""
    _, tcfg = _configs({"frontend.impl": "xla", "model.remat_trunk": True})
    model = build_model(tcfg.model, device="cpu", seed=0)
    calls = []
    model.trunk_module.register_forward_pre_hook(lambda *_: calls.append(1))
    with torch.no_grad():
        model(torch.zeros(2, 2, 96, 64))
    assert calls == [1]


@pytest.mark.parametrize("impl", ["xla"])
def test_remat_step_matches_jax_remat(impl):
    """The port's remat step against JAX's (flax nn.remat around the trunk)
    from the same weights: gradients, parameters, batch statistics after one
    step, and the loss."""
    jcfg, tcfg = _configs({"frontend.impl": impl, "model.remat_trunk": True})
    jmodel = jax_build_model(jcfg.model)
    jst = jstate.create_train_state(jcfg, jmodel, jnp.zeros((B, 2, 96, 64), jnp.float32))
    init = _flat_jax(jst.params)
    model = build_model(tcfg.model, device="cpu")
    model.load_state_dict(flat_to_state_dict(_flat_jax(jst.params, jst.batch_stats), model))
    st = tstate.create_train_state(tcfg, model)
    x, y = _batch(7)
    jst, jl = jax.jit(jstate.make_train_step(jcfg, jmodel, "waveform"))(
        jst, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    st, loss = tstate.make_train_step(tcfg, model, "waveform")(st, x, y)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL, atol=0)
    _check_first_step(model, st, jst, init, tstate.lr_schedule(tcfg)(0))
