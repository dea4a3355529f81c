"""SpecAugment and mixup of the PyTorch port (mla_tpu_torch/ops/augment.py)
against the JAX package's: the port's arithmetic fed JAX's draws (recomputed
here with the jax.random calls mla_tpu/ops/augment.py makes) equals JAX's
output; the port's own draws hold their laws; and the train step's wiring
(mixup, then SpecAugment on waveform or patch input) is exact where the
augmentation must change nothing."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.ops import augment as jaug  # noqa: E402
from mla_tpu_torch.config import get_config  # noqa: E402
from mla_tpu_torch.models.zoo import build_model  # noqa: E402
from mla_tpu_torch.ops import augment as aug  # noqa: E402
from mla_tpu_torch.train import state as tstate  # noqa: E402

TOL = 1e-6  # port's arithmetic on JAX's draws against JAX's output (f32)


def _jax_span_draws(key, b, frames, mels, n_t, tw, n_f, fw):
    """JAX's spec_augment draws, as mla_tpu/ops/augment.py makes them: per
    clip a key split into one per mask, each split into (width, start)."""
    out = {k: np.zeros((b, n), np.int64) for k, n in
           (("ts", n_t), ("tw", n_t), ("fs", n_f), ("fw", n_f))}
    for c, k in enumerate(jax.random.split(key, b)):
        keys = jax.random.split(k, n_t + n_f)
        for i in range(n_t + n_f):
            size, maxw, pre, j = ((frames, tw, "t", i) if i < n_t
                                  else (mels, fw, "f", i - n_t))
            kw, ks = jax.random.split(keys[i])
            width = jax.random.randint(kw, (), 0, maxw + 1)
            start = jax.random.randint(ks, (), 0, jnp.maximum(size - width, 1))
            out[pre + "w"][c, j], out[pre + "s"][c, j] = int(width), int(start)
    return aug.SpanDraws(*(torch.from_numpy(out[k]) for k in ("ts", "tw", "fs", "fw")))


@pytest.mark.parametrize("shape,masks,mask_value", [
    ((3, 2, 96, 64), (2, 24, 2, 12), None),
    ((4, 96, 64), (1, 40, 3, 30), None),
    ((2, 3, 96, 64), (2, 96, 2, 64), -1.5),  # widths up to the whole axis
])
def test_spec_augment_on_jax_draws_equals_jax(shape, masks, mask_value):
    patches = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    key = jax.random.key(7)
    n_t, tw, n_f, fw = masks
    want = np.asarray(jaug.spec_augment(jnp.asarray(patches), key, n_t, tw, n_f, fw,
                                        mask_value=mask_value))
    draws = _jax_span_draws(key, shape[0], shape[-2], shape[-1], n_t, tw, n_f, fw)
    got = aug.apply_spec_augment(torch.from_numpy(patches), draws, mask_value).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert (got != patches).any()  # something was masked


@pytest.mark.parametrize("x_shape,alpha", [((6, 3, 96, 64), 0.5), ((5, 32000), 0.2),
                                           ((4, 7, 16), 2.0)])
def test_mixup_on_jax_draws_equals_jax(x_shape, alpha):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(x_shape).astype(np.float32)
    y = (rng.random((x_shape[0], 5)) < 0.4).astype(np.float32)
    key = jax.random.key(3)
    want_x, want_y = jaug.mixup(jnp.asarray(x), jnp.asarray(y), key, alpha)
    kperm, klam = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(kperm, x_shape[0]))
    lam = np.asarray(jax.random.beta(klam, alpha, alpha, (x_shape[0],)))
    lam = np.maximum(lam, 1.0 - lam)
    got_x, got_y = aug.apply_mixup(torch.from_numpy(x), torch.from_numpy(y),
                                   torch.from_numpy(perm.astype(np.int64)),
                                   torch.from_numpy(lam))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=TOL)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=TOL)


def test_port_draws_hold_their_laws():
    """Over a seeded generator: widths in [0, max_width] (both ends drawn),
    starts in [0, max(size - width, 1)), lam in [0.5, 1], a permutation; the
    same seed draws the same; the masks cover exactly the drawn spans."""
    gen = torch.Generator().manual_seed(0)
    d = aug.spec_augment_draws(4000, 96, 64, gen, 2, 24, 2, 12)
    for start, width, size, maxw in ((d.time_start, d.time_width, 96, 24),
                                     (d.freq_start, d.freq_width, 64, 12)):
        assert int(width.min()) == 0 and int(width.max()) == maxw
        assert bool((start >= 0).all()) and bool((start < torch.clamp(size - width, min=1)).all())
        assert int(start.max()) == size - 1  # a zero-width span may start anywhere
    again = aug.spec_augment_draws(4000, 96, 64, torch.Generator().manual_seed(0), 2, 24, 2, 12)
    assert all(torch.equal(a, b) for a, b in zip(d, again))
    patches = torch.randn(3, 2, 96, 64, generator=gen)
    one = aug.SpanDraws(*(t[:3] for t in d))
    out = aug.apply_spec_augment(patches, one)
    for c in range(3):
        rows = torch.zeros(96, dtype=torch.bool)
        cols = torch.zeros(64, dtype=torch.bool)
        for s, w in zip(one.time_start[c], one.time_width[c]):
            rows[s:s + w] = True
        for s, w in zip(one.freq_start[c], one.freq_width[c]):
            cols[s:s + w] = True
        masked = rows[:, None] | cols[None, :]
        assert torch.equal(out[c][:, masked], patches[c].mean().expand(2, int(masked.sum())))
        assert torch.equal(out[c][:, ~masked], patches[c][:, ~masked])
    perm, lam = aug.mixup_draws(1000, gen, 0.5)
    assert torch.equal(torch.sort(perm).values, torch.arange(1000))
    assert float(lam.min()) >= 0.5 and float(lam.max()) <= 1.0 and lam.dtype == torch.float32
    assert float(lam.mean()) < 0.9  # Beta(0.5, 0.5) folded: mean 1 - 1/pi ~ 0.68


def _step_cfgs(**over):
    small = {"model.conv_channels": "8,16", "model.convs_per_stage": 1,
             "model.embed_dim": 16, "model.hidden_units": 32, "model.n_classes": 5,
             "model.compute_dtype": "float32", "model.dropout_rate": 0.3,
             "train.batch_size": 4}
    return (get_config("us8k_fused_frontend", small),
            get_config("us8k_fused_frontend", {**small, **over}))


def _one_step(cfg, x, y, kind="waveform"):
    """(loss, the step's gradients and the state after it: parameters after
    Adam and the batch-norm statistics)."""
    model = build_model(cfg.model, device="cpu", seed=0)
    st = tstate.create_train_state(cfg, model)
    _, loss = tstate.make_train_step(cfg, model, kind)(st, x, y)
    grads = {f"grad {n}": p.grad.clone() for n, p in model.named_parameters()}
    return float(loss), {**grads, **{k: v.clone() for k, v in model.state_dict().items()}}


def _assert_steps_equal(a, b, atol, after_adam=True):
    """Losses and gradients within ``atol``, and the statistics; the
    parameters after Adam too where ``after_adam`` (Adam's first update is
    ~lr * sign(g), so it magnifies any difference in a gradient near 0)."""
    assert abs(a[0] - b[0]) <= atol, (a[0], b[0])
    for k, v in a[1].items():
        if after_adam or k.startswith("grad") or "running" in k:
            np.testing.assert_allclose(b[1][k].numpy(), v.numpy(), rtol=0, atol=atol, err_msg=k)


def test_mixup_of_identical_rows_is_the_step_without_mixup():
    """mixup_alpha > 0 on a batch of one clip repeated: every mix is the clip
    itself, so the step (dropout drawn as without mixup) is unchanged, up to
    lam x + (1 - lam) x rounding: the same loss, gradients and batch-norm
    statistics."""
    plain, mixed = _step_cfgs(**{"train.mixup_alpha": 0.5})
    row = np.random.default_rng(2).standard_normal(32000).astype(np.float32) * 0.1
    x = torch.from_numpy(np.tile(row, (4, 1)))
    y = torch.zeros(4, 5)
    y[:, 2] = 1.0
    _assert_steps_equal(_one_step(plain, x, y), _one_step(mixed, x, y), atol=1e-6,
                        after_adam=False)


def test_spec_augment_of_zero_widths_is_the_step_without_it():
    """spec_augment with both mask widths 0 masks nothing: the step is the
    step without SpecAugment, bit for bit. On feature input SpecAugment does
    not run at all, as in the reference."""
    plain, masked = _step_cfgs(**{"train.spec_augment": True, "train.time_mask_width": 0,
                                  "train.freq_mask_width": 0})
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 32000)).astype(
        np.float32) * 0.1)
    y = torch.eye(4, 5)
    _assert_steps_equal(_one_step(plain, x, y), _one_step(masked, x, y), atol=0.0)
    on = get_config("audioset_multi_level", {"model.trunk": "none", "model.n_classes": 5,
                                             "model.hidden_units": 32,
                                             "train.spec_augment": True})
    off = get_config("audioset_multi_level", {"model.trunk": "none", "model.n_classes": 5,
                                              "model.hidden_units": 32})
    feats = torch.randn(4, 10, on.model.embed_dim, generator=torch.Generator().manual_seed(0))
    _assert_steps_equal(_one_step(off, feats, y, "features"),
                        _one_step(on, feats, y, "features"), atol=0.0)


def test_augmented_step_draws_from_the_step_generators():
    """With mixup and SpecAugment on, the step's augmented input is the
    front-end's output mixed with the draws of augment_generator(seed, step,
    2), then masked with those of augment_generator(seed, step, 1): the
    same loss as driving the model by hand on that input."""
    _, cfg = _step_cfgs(**{"train.mixup_alpha": 0.4, "train.spec_augment": True})
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 32000)).astype(
        np.float32) * 0.1)
    y = torch.eye(4, 5)
    loss, _ = _one_step(cfg, x, y)
    from mla_tpu_torch.ops import frontend as fe

    model = build_model(cfg.model, device="cpu", seed=0)
    with torch.no_grad():
        p = fe.apply_frontend(x, cfg.frontend)
    p, ym = aug.mixup(p, y, tstate.augment_generator(cfg.train.seed, 0, 2, p.device),
                      cfg.train.mixup_alpha)
    p = aug.spec_augment(p, tstate.augment_generator(cfg.train.seed, 0, 1, p.device),
                         time_mask_width=cfg.train.time_mask_width,
                         freq_mask_width=cfg.train.freq_mask_width)
    model.train()
    want = tstate.bce_loss(model(p, tstate.dropout_generator(cfg.train.seed, 0, p.device)), ym)
    assert loss == float(want.detach())
