"""Train step of the PyTorch port against the JAX package's: BCE, the
learning-rate schedules and global-norm clipping against optax, the staged
wire decode, dropout and train-mode batch norm, and 1 and 10 train steps
from the same weights on both front-end impls (the JAX side's Pallas
kernel in interpret mode), with a cosine-with-warmup, a clipping and an EMA
case. Adam's eps sits in the same place in both libraries,
lr * m_hat / (sqrt(v_hat) + eps): the 10-step trajectories agree."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.config import get_config as jax_get_config  # noqa: E402
from mla_tpu.models.convert import params_to_flat  # noqa: E402
from mla_tpu.models.trunk import CompactCNN as JaxCompactCNN  # noqa: E402
from mla_tpu.models.zoo import build_model as jax_build_model  # noqa: E402
from mla_tpu.train import state as jstate  # noqa: E402
from mla_tpu_torch.config import get_config  # noqa: E402
from mla_tpu_torch.data.adpcm import adpcm4_encode  # noqa: E402
from mla_tpu_torch.data.audio_io import pcm16_quantize  # noqa: E402
from mla_tpu_torch.models.convert import flat_to_state_dict, state_dict_to_flat  # noqa: E402
from mla_tpu_torch.models.heads import EmbeddedMapping, dropout  # noqa: E402
from mla_tpu_torch.models.trunk import CompactCNN  # noqa: E402
from mla_tpu_torch.models.zoo import build_model  # noqa: E402
from mla_tpu_torch.ops import fused_frontend as ff  # noqa: E402
from mla_tpu_torch.train import state as tstate  # noqa: E402

# small enough for the CPU, the same on both sides; dropout 0 for parity
TRAIN_SMALL = {"model.conv_channels": "8,16", "model.convs_per_stage": 1,
               "model.embed_dim": 32, "model.hidden_units": 64, "model.n_classes": 8,
               "model.compute_dtype": "float32", "model.dropout_rate": 0.0,
               "data.clip_seconds": 2.0, "train.batch_size": 4}
B, N_SAMPLES, N_STEPS = 4, 32000, 10
LOSS_RTOL = 1e-4  # 10 steps; convolutions sum in another order than XLA's
PARAM_ATOL = 1e-5  # one Adam step moves each weight by ~lr = 1e-3


def _configs(overrides):
    ov = {**TRAIN_SMALL, **overrides}
    return jax_get_config("us8k_fused_frontend", ov), get_config("us8k_fused_frontend", ov)


def _flat_jax(params, batch_stats=None):
    flat = params_to_flat(jax.tree.map(np.asarray, dict(params)), prefix="params/")
    if batch_stats:
        flat.update(params_to_flat(jax.tree.map(np.asarray, dict(batch_stats)),
                                   prefix="batch_stats/"))
    return flat


def _assert_flat_close(ours, ref, atol, what):
    assert set(ref) <= set(ours), set(ref) - set(ours)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=atol, err_msg=f"{what} {k}")


def test_bce_loss_matches_reference():
    rng = np.random.default_rng(0)
    probs = rng.random((6, 8)).astype(np.float32)
    probs[0, :3] = [0.0, 1.0, 1e-9]  # the clip's edges
    targets = (rng.random((6, 8)) < 0.3).astype(np.float32)
    ref = float(jstate.bce_loss(jnp.asarray(probs), jnp.asarray(targets)))
    ours = float(tstate.bce_loss(torch.from_numpy(probs), torch.from_numpy(targets)))
    np.testing.assert_allclose(ours, ref, rtol=1e-7, atol=0)  # within one f32 rounding


def _optax_lrs(jcfg, n):
    """The learning rate optax's chain applies at each count: with a
    constant gradient of 1, Adam's bias-corrected step is lr / (1 + eps)."""
    tx = jstate.make_optimizer(jcfg)
    params = jnp.zeros((1,), jnp.float32)
    opt = tx.init(params)
    lrs = []
    for _ in range(n):
        upd, opt = tx.update(jnp.ones((1,), jnp.float32), opt, params)
        lrs.append(-float(upd[0]) * (1 + 1e-8))
    return np.array(lrs)


@pytest.mark.parametrize("schedule", ["constant", "cosine", "exponential"])
@pytest.mark.parametrize("warmup", [0, 7])
def test_lr_schedule_matches_optax(schedule, warmup):
    jcfg, tcfg = _configs({"train.lr_schedule": schedule, "train.warmup_steps": warmup,
                           "train.num_steps": 30, "train.lr_decay_rate": 0.5})
    sched = tstate.lr_schedule(tcfg)
    ours = np.array([sched(t) for t in range(50)])  # past num_steps: cosine's floor
    np.testing.assert_allclose(ours, _optax_lrs(jcfg, 50), rtol=0, atol=1e-7)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])  # clips, and leaves alone
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(1)
    grads = [rng.standard_normal(s).astype(np.float32) for s in [(3, 4), (5,), (2, 2, 2)]]
    ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
    ours = [torch.from_numpy(g.copy()) for g in grads]
    norm = tstate.clip_by_global_norm_(ours, max_norm)
    np.testing.assert_allclose(float(norm), np.sqrt(sum((g * g).sum() for g in grads)),
                               rtol=1e-6)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)


def test_decode_staged_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.integers(-32768, 32767, (3, 50)).astype(np.int16)
    q = rng.integers(0, 256, (3, 50)).astype(np.uint8)
    f = rng.standard_normal((3, 50)).astype(np.float32)
    wire = adpcm4_encode(x)  # 50 samples: one 256-sample block, edge-padded
    for arr, stage, n in ((x, "int16", None), (q, "uint8", None), (f, "int16", None),
                          (wire, "adpcm4", 50), (wire, "adpcm4", None), (f, "adpcm4", None)):
        ref = np.asarray(jstate.decode_staged(jnp.asarray(arr), stage, n))
        ours = tstate.decode_staged(torch.from_numpy(arr), stage, n).numpy()
        assert ours.dtype == np.float32 and ours.shape == ref.shape
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-7)
    # adpcm4 is exact: the decode reproduces the encoder's reconstruction
    np.testing.assert_array_equal(
        tstate.decode_staged(torch.from_numpy(wire), "adpcm4", 50).numpy(),
        np.asarray(jstate.decode_staged(jnp.asarray(wire), "adpcm4", 50)))


def test_dropout_rate_scale_and_generator():
    h = torch.ones(200_000)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    a, b, c = dropout(h, 0.4, gen(1)), dropout(h, 0.4, gen(1)), dropout(h, 0.4, gen(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.6) < 0.005  # sd of the rate: 0.0011
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.6))
    assert torch.equal(dropout(h, 0.0, None), h)
    with pytest.raises(ValueError, match="Generator"):
        dropout(h, 0.4, None)
    block = EmbeddedMapping(16, 32, 1, torch.float32, dropout_rate=0.5)
    x = torch.randn(4, 3, 16, generator=gen(3))
    with torch.no_grad():
        block.eval()
        assert torch.equal(block(x, gen(4)), block(x))  # identity in eval
        block.train()
        y1, y2 = block(x, gen(4)), block(x, gen(4))
        assert torch.equal(y1, y2)
        live, kept = torch.relu(block.fc0(x)), y1 != 0
        torch.testing.assert_close(y1[kept], live[kept] / 0.5)  # kept units scaled by 1/keep
        assert (live[~kept] != 0).any()  # and live units dropped
    # a train step's masks are a pure function of (train.seed, step)
    g1, g2 = (tstate.dropout_generator(0, 5, torch.device("cpu")) for _ in range(2))
    assert torch.equal(torch.rand(8, generator=g1), torch.rand(8, generator=g2))
    g3 = tstate.dropout_generator(0, 6, torch.device("cpu"))
    assert not torch.equal(torch.rand(8, generator=g3),
                           torch.rand(8, generator=tstate.dropout_generator(0, 5, "cpu")))


# running = 0.99 * running + 0.01 * batch: a running-stat tolerance of 1e-7
# holds the f32 batch statistics to 1e-5
@pytest.mark.parametrize("dtype,out_tol,stat_tol", [("float32", 1e-4, 1e-7),
                                                    ("bfloat16", 2e-2, 2e-4)])
def test_batch_norm_train_mode_matches_flax(dtype, out_tol, stat_tol):
    """Batch statistics over (N, H, W) with the fast biased variance, the
    running update at momentum 0.99 with that variance, eval mode after."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcnn = JaxCompactCNN(conv_channels=(8, 16), convs_per_stage=1, embed_dim=16, dtype=jdt)
    x = np.random.default_rng(3).standard_normal((6, 96, 64)).astype(np.float32)
    variables = jcnn.init(jax.random.key(0), jnp.asarray(x))
    cnn = CompactCNN((8, 16), 1, 16, dtype=tdt)
    cnn.load_state_dict(flat_to_state_dict(
        _flat_jax(variables["params"], variables["batch_stats"]), cnn))
    ref, mutated = jcnn.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    cnn.train()
    with torch.no_grad():
        ours = cnn(torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(ours, np.asarray(ref, np.float32), rtol=0, atol=out_tol)
    _assert_flat_close(state_dict_to_flat(cnn.state_dict()),
                       _flat_jax({}, mutated["batch_stats"]), stat_tol, "running stats")
    variables = {"params": variables["params"], "batch_stats": mutated["batch_stats"]}
    cnn.eval()
    with torch.no_grad():
        ours = cnn(torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(ours, np.asarray(jcnn.apply(variables, jnp.asarray(x)),
                                                np.float32), rtol=0, atol=out_tol)


STEP_CASES = {
    "xla": {"frontend.impl": "xla"},
    "pallas": {},  # the preset's own front-end: the fused kernel
    "cosine_warmup": {"frontend.impl": "xla", "train.lr_schedule": "cosine",
                      "train.warmup_steps": 3, "train.num_steps": N_STEPS},
    "clip": {"frontend.impl": "xla", "train.gradient_clip_norm": 0.05},
    "ema": {"frontend.impl": "xla", "train.ema_decay": 0.9},
    # batches staged in the adpcm4 wire, decoded inside the step
    "adpcm4": {"frontend.impl": "xla", "data.staging_dtype": "adpcm4"},
}
# gradients: f32 sums in another order, so within 2e-4 of the tensor's
# largest gradient, plus 1e-7 for the attention gate, whose gradient
# (~1e-6) is what is left of sums of terms ~1e3 times larger that cancel
GRAD_ATOL, GRAD_RTOL = 1e-7, 2e-4
# Adam's first step moves a weight by lr * g / (|g| + eps): where |g| is at
# least 100 eps the gradient decides it (+-lr within 1%); below, rounding
# noise may (the attention gate's bias, to which the softmax over time is
# invariant, has a true gradient of 0), and both sides move it by <= lr
DECIDED = 100 * tstate.ADAM_EPS


def _adam_mu(opt_state):
    states = jax.tree.leaves(opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
    return next(s.mu for s in states if isinstance(s, optax.ScaleByAdamState))


def _check_first_step(model, st, jst, init, lr):
    """Gradients (Adam's first moments over 1 - beta1), parameters, batch
    statistics and the EMA shadow after one step."""
    moments = {n: st.optimizer.state[p]["exp_avg"] for n, p in model.named_parameters()}
    grads = state_dict_to_flat(tstate.variables_from_state(st, moments))
    ref_grads = _flat_jax(_adam_mu(jst.opt_state))
    ours, ref = state_dict_to_flat(model.state_dict()), _flat_jax(jst.params)
    ema = (state_dict_to_flat(tstate.variables_from_state(st, st.ema_params))
           if st.ema_params is not None else None)
    ref_ema = _flat_jax(jst.ema_params) if jst.ema_params is not None else None
    assert (ema is None) == (ref_ema is None)
    beta1 = tstate.ADAM_BETAS[0]
    for k, mu in ref_grads.items():
        g = mu / (1 - beta1)
        np.testing.assert_allclose(grads[k] / (1 - beta1), g, rtol=0,
                                   atol=GRAD_ATOL + GRAD_RTOL * np.abs(g).max(),
                                   err_msg=f"gradient {k}")
        decided = np.abs(g) >= DECIDED
        np.testing.assert_allclose(ours[k][decided], ref[k][decided], rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"params {k}")
        for side in (ours[k], ref[k]):
            assert np.all(np.abs(side - init[k])[~decided] <= lr * (1 + 1e-6) + 1e-7), k
        if ema is not None:
            np.testing.assert_allclose(ema[k][decided], ref_ema[k][decided], rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"ema {k}")
    _assert_flat_close(ours, _flat_jax({}, jst.batch_stats), PARAM_ATOL, "batch stats")


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax_from_bridged_weights(case):
    """1 and 10 steps: after the first, the gradients, parameters, batch
    statistics (and EMA shadow); over all ten, the loss trajectory."""
    jcfg, tcfg = _configs(STEP_CASES[case])
    jmodel = jax_build_model(jcfg.model)
    jst = jstate.create_train_state(jcfg, jmodel, jnp.zeros((B, 2, 96, 64), jnp.float32))
    init = _flat_jax(jst.params)
    model = build_model(tcfg.model, device="cpu")
    model.load_state_dict(flat_to_state_dict(_flat_jax(jst.params, jst.batch_stats), model))
    st = tstate.create_train_state(tcfg, model)
    jstep = jax.jit(jstate.make_train_step(jcfg, jmodel, "waveform", clip_samples=N_SAMPLES))
    step = tstate.make_train_step(tcfg, model, "waveform", clip_samples=N_SAMPLES)
    rng = np.random.default_rng(4)
    xs = (0.1 * rng.standard_normal((N_STEPS, B, N_SAMPLES))).astype(np.float32)
    ys = (rng.random((N_STEPS, B, 8)) < 0.3).astype(np.float32)
    if tcfg.data.staging_dtype == "adpcm4":  # both steps get the same wire bytes
        xs = adpcm4_encode(pcm16_quantize(xs))
    ref_losses, losses = [], []
    for i in range(N_STEPS):
        jst, jl = jstep(jst, jnp.asarray(xs[i]), jnp.asarray(ys[i]))
        st, loss = step(st, torch.from_numpy(xs[i]), torch.from_numpy(ys[i]))
        ref_losses.append(float(jl))
        losses.append(float(loss))
        if i == 0:
            assert st.step == int(jst.step) == 1
            _check_first_step(model, st, jst, init, tstate.lr_schedule(tcfg)(0))
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL, atol=0)
    assert losses[-1] != losses[0]  # the steps did move the weights


def test_eval_step_reads_running_stats_and_ema():
    jcfg, tcfg = _configs({"frontend.impl": "xla", "train.ema_decay": 0.5})
    jmodel = jax_build_model(jcfg.model)
    jst = jstate.create_train_state(jcfg, jmodel, jnp.zeros((B, 2, 96, 64), jnp.float32))
    model = build_model(tcfg.model, device="cpu")
    model.load_state_dict(flat_to_state_dict(_flat_jax(jst.params, jst.batch_stats), model))
    st = tstate.create_train_state(tcfg, model)
    rng = np.random.default_rng(5)
    x = (0.1 * rng.standard_normal((B, N_SAMPLES))).astype(np.float32)
    y = (rng.random((B, 8)) < 0.3).astype(np.float32)
    jst, _ = jax.jit(jstate.make_train_step(jcfg, jmodel, "waveform"))(
        jst, jnp.asarray(x), jnp.asarray(y))
    st, _ = tstate.make_train_step(tcfg, model, "waveform")(
        st, torch.from_numpy(x), torch.from_numpy(y))
    ref = np.asarray(jax.jit(jstate.make_eval_step(jcfg, jmodel, "waveform"))(
        jst, jnp.asarray(x)))
    ours = tstate.make_eval_step(tcfg, model, "waveform")(st, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    assert tstate.eval_params(tcfg, st) is st.ema_params


def test_front_end_kernel_refuses_a_waveform_that_requires_grad():
    wav = torch.zeros((1, N_SAMPLES), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ff.fused_log_mel_patches(wav)


@pytest.mark.parametrize("override,what", [({"train.mixup_alpha": 0.2}, "mixup"),
                                           ({"train.spec_augment": True}, "spec_augment")])
def test_unported_augmentation_raises(override, what):
    """mixup and SpecAugment, once unported, now build a step that runs
    (tests/test_torch_augment.py holds them against JAX)."""
    _, tcfg = _configs(override)
    model = build_model(tcfg.model, device="cpu", seed=0)
    step = tstate.make_train_step(tcfg, model, "waveform")
    x = torch.from_numpy((np.random.default_rng(0).standard_normal((2, N_SAMPLES)) * 0.1)
                         .astype(np.float32))
    _, loss = step(tstate.create_train_state(tcfg, model), x, torch.eye(2, tcfg.model.n_classes))
    assert np.isfinite(float(loss))


def test_remat_trunk_raises():
    """remat_trunk, once unported, now builds a model whose train step runs."""
    _, tcfg = _configs({"model.remat_trunk": True})
    model = build_model(tcfg.model, device="cpu", seed=0)
    step = tstate.make_train_step(tcfg, model, "waveform")
    x = torch.zeros((2, N_SAMPLES))
    _, loss = step(tstate.create_train_state(tcfg, model), x, torch.eye(2, tcfg.model.n_classes))
    assert np.isfinite(float(loss))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the front-end kernel has no CPU mode")
    return torch.device("cuda")


def test_train_step_on_the_card_pallas_matches_xla(cuda):
    rng = np.random.default_rng(6)
    x = torch.from_numpy((0.1 * rng.standard_normal((B, N_SAMPLES))).astype(np.float32)).to(cuda)
    y = torch.from_numpy((rng.random((B, 8)) < 0.3).astype(np.float32)).to(cuda)
    losses = {}
    for impl in ("pallas", "xla"):
        _, tcfg = _configs({"frontend.impl": impl})
        model = build_model(tcfg.model, seed=0)
        before = ff.LAUNCHES
        _, loss = tstate.make_train_step(tcfg, model, "waveform")(
            tstate.create_train_state(tcfg, model), x, y)
        losses[impl] = float(loss)
        assert ff.LAUNCHES - before == (impl == "pallas")
    assert abs(losses["pallas"] - losses["xla"]) < 1e-4
