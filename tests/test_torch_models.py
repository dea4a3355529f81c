"""Model zoo of the PyTorch port against the JAX package with the same
weights: the model golden file, the CNN-trunk forward and segment logits
at f32 and bf16, CompactCNN's group and no norm, the VGGish trunk, and
the timeline readout."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.models.trunk import CompactCNN as JaxCompactCNN  # noqa: E402
from mla_tpu.models.zoo import build_model as jax_build_model  # noqa: E402
from mla_tpu_torch.config import ModelConfig  # noqa: E402
from mla_tpu_torch.models.trunk import CompactCNN  # noqa: E402
from mla_tpu_torch.models.zoo import build_model  # noqa: E402
from tests.torch_port_common import configs, jax_weights, torch_model  # noqa: E402

VARIANTS = ["multi_level_attention", "single_attention", "multi_attention", "avg_pool",
            "max_pool"]
F32_TOL = 1e-4  # convolutions sum in another order than XLA's
BF16_TOL = 2e-2  # bf16 budget: the two frameworks round bf16 at other places


def _patches(seed, b=2, t=3):
    return (np.random.default_rng(seed).standard_normal((b, t, 96, 64))).astype(np.float32)


def test_model_golden():
    g = np.load("tests/golden/model_golden.npz")
    n_blocks, layers, hidden, d, c = (int(v) for v in g["meta"])
    cfg = ModelConfig(variant="multi_level_attention", trunk="none", n_classes=c,
                      n_blocks=n_blocks, layers_per_block=layers, hidden_units=hidden,
                      embed_dim=d, compute_dtype="float32")
    flat = {f"params/{k}": g[k] for k in g.files if k not in ("x", "probs", "meta")}
    with torch.no_grad():
        probs = torch_model(cfg, flat)(torch.from_numpy(g["x"])).numpy()
    np.testing.assert_allclose(probs, g["probs"], atol=1e-5, rtol=0)


def _jax_and_port(variant, dtype, seed):
    jcfg, tcfg = configs({"model.variant": variant, "model.compute_dtype": dtype,
                          "model.n_attention_heads": 2})
    variables, flat = jax_weights(jcfg.model, seed)
    return jax_build_model(jcfg.model), variables, torch_model(tcfg.model, flat)


@pytest.mark.parametrize("variant", VARIANTS)
def test_cnn_forward_and_segment_logits_match_jax_f32(variant):
    jmodel, variables, model = _jax_and_port(variant, "float32", seed=2)
    x = _patches(0)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    ref_levels = jmodel.apply(variables, jnp.asarray(x), method="segment_logits")
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
        levels = model.segment_logits(torch.from_numpy(x))
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=0)
    assert len(levels) == len(ref_levels)
    for (g, c), (rg, rc) in zip(levels, ref_levels):
        assert g.dtype == c.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=F32_TOL, rtol=0)
        np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("variant", ["multi_level_attention", "multi_attention"])
def test_cnn_forward_and_segment_logits_match_jax_bf16(variant):
    jmodel, variables, model = _jax_and_port(variant, "bfloat16", seed=3)
    x = _patches(1)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    ref_levels = jmodel.apply(variables, jnp.asarray(x), method="segment_logits")
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
        levels = model.segment_logits(torch.from_numpy(x))
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=BF16_TOL, rtol=0)
    for (g, c), (rg, rc) in zip(levels, ref_levels):
        assert g.dtype == torch.float32  # cast to f32 before any pooling
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=BF16_TOL, rtol=BF16_TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("pool,global_pool", [("max", "avg"), ("avg", "avg+max")])
def test_compact_cnn_pool_options_match_jax(pool, global_pool):
    """The cnn10/cnn14 block structure (avg pools, avg+max global pool) at a
    small width, and the min(H, W) >= 2 pool guard: five stages shrink a
    24x16 input to 1x1 before the last stage."""
    x = _patches(2, b=1, t=2)[0][:, :24, :16]  # [2, 24, 16]
    chans = (4, 8, 8, 8, 8)
    jm = JaxCompactCNN(chans, 1, 6, pool=pool, global_pool=global_pool, dtype=jnp.float32)
    variables = jm.init(jax.random.key(0), jnp.asarray(x))
    rng = np.random.default_rng(0)
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
                         variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    ref = np.asarray(jm.apply(variables, jnp.asarray(x)))
    model = CompactCNN(chans, 1, 6, pool=pool, global_pool=global_pool, dtype=torch.float32)
    from mla_tpu.models.convert import params_to_flat
    from mla_tpu_torch.models.convert import flat_to_state_dict

    flat = params_to_flat(jax.tree.map(np.asarray, dict(variables["params"])), "params/")
    flat.update(params_to_flat(jax.tree.map(np.asarray, dict(stats)), "batch_stats/"))
    model.load_state_dict(flat_to_state_dict(flat, model))
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=F32_TOL, rtol=0)


def _flat(variables):
    from mla_tpu.models.convert import params_to_flat

    flat = params_to_flat(jax.tree.map(np.asarray, dict(variables["params"])), "params/")
    if "batch_stats" in variables:
        flat.update(params_to_flat(jax.tree.map(np.asarray, dict(variables["batch_stats"])),
                                   "batch_stats/"))
    return flat


@pytest.mark.parametrize("norm,dtype,tol", [("group", "float32", 1e-5), ("none", "float32", 1e-5),
                                            ("group", "bfloat16", BF16_TOL)])
def test_compact_cnn_norms_match_jax(norm, dtype, tol):
    """norm="group" (flax GroupNorm: min(32, C) groups, eps 1e-6, fast
    variance in f32; 64 channels make groups of two) and norm="none" (the
    conv's bias), through the flat format, the scales and biases moved off
    their init values."""
    from mla_tpu.models.convert import flat_to_params
    from mla_tpu_torch.models.convert import flat_to_state_dict, state_dict_to_flat

    x = _patches(3, b=1, t=3)[0]  # [3, 96, 64]
    chans = (8, 64)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = JaxCompactCNN(chans, 1, 6, norm=norm, dtype=jdt)
    flat = _flat(jm.init(jax.random.key(1), jnp.asarray(x)))
    rng = np.random.default_rng(1)
    for k, a in flat.items():
        if k.endswith(("/scale", "/bias")):
            flat[k] = (a + rng.uniform(-0.5, 0.5, a.shape)).astype(np.float32)
    assert any("/gn1_0/" in k for k in flat) == (norm == "group")
    ref = np.asarray(jm.apply({"params": flat_to_params(flat)["params"]}, jnp.asarray(x)),
                     np.float32)
    model = CompactCNN(chans, 1, 6, norm=norm, dtype=tdt)
    sd = flat_to_state_dict(flat, model)
    model.load_state_dict(sd)
    assert state_dict_to_flat(sd).keys() == flat.keys()  # scales export as "scale"
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(x)).float().numpy()
    np.testing.assert_allclose(ours, ref, atol=tol, rtol=0)


def test_vggish_model_matches_jax():
    """An AudioTagger on the VGGish trunk (conv 64 / 128 / 256 x 2 / 512 x 2,
    FC 4096 x 2) at f32: the flat keys are JAX's, fc1_1's [12288, 4096]
    kernel crosses by the plain transpose because the port flattens NHWC,
    and the forward and the segment logits agree."""
    jcfg, tcfg = configs({"model.trunk": "vggish", "model.n_blocks": 1})
    variables, flat = jax_weights(jcfg.model, seed=5)
    assert {k.split("/")[2] for k in flat if k.startswith("params/trunk_module/")} == {
        "conv1_1", "conv2_1", "conv3_1", "conv3_2", "conv4_1", "conv4_2", "fc1_1", "fc1_2",
        "fc2"}
    model = torch_model(tcfg.model, flat)
    x = _patches(4, b=1, t=2)
    jmodel = jax_build_model(jcfg.model)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    ref_emb = np.asarray(jmodel.apply(variables, jnp.asarray(x), method="embed"))
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
        emb = model.embed(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(emb, ref_emb, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", VARIANTS)
def test_timeline_matches_jax(variant):
    """AudioTagger.timeline: per level or head, (weights, seg_probs) within
    the f32 budget of JAX's, and sum_t w * f the pooled vector that the
    variant's tail turns into the forward's probabilities."""
    jmodel, variables, model = _jax_and_port(variant, "float32", seed=6)
    x = _patches(5)
    ref = jmodel.apply(variables, jnp.asarray(x), method="timeline")
    with torch.no_grad():
        ours = model.timeline(torch.from_numpy(x))
        probs = model(torch.from_numpy(x))
        pooled = [(w * f).sum(dim=1) for w, f in ours]
        if variant == "multi_level_attention":
            np.testing.assert_allclose(model.finalize_multi_level(pooled).numpy(),
                                       probs.numpy(), atol=1e-5, rtol=0)
        elif variant == "multi_attention":
            np.testing.assert_allclose(model.finalize_multi_head(pooled).numpy(),
                                       probs.numpy(), atol=1e-5, rtol=0)
        else:
            np.testing.assert_allclose(pooled[0].numpy(), probs.numpy(), atol=1e-5, rtol=0)
    assert len(ours) == len(ref)
    for (w, f), (rw, rf) in zip(ours, ref):
        np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=F32_TOL, rtol=0)
        np.testing.assert_allclose(f.numpy(), np.asarray(rf), atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("override,what", [({"model.remat_trunk": True}, "remat")])
def test_unported_options_raise(override, what):
    _, tcfg = configs(override)
    with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP"):
        build_model(tcfg.model, device="cpu")


def test_build_model_device_rule():
    _, tcfg = configs()
    model = build_model(tcfg.model, device="cpu", seed=0)
    assert not model.training and next(model.parameters()).device.type == "cpu"
    again = build_model(tcfg.model, device="cpu", seed=0)
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)  # a seeded generator makes the same weights
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(tcfg.model)
