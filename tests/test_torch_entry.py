"""The flagship program of the PyTorch port (``mla_tpu_torch/entry.py``)
against ``__graft_entry__.py::entry`` at full width: CompactCNN 64-512 x 2
convs, 3 blocks of 512, 527 classes. JAX's ``entry()`` makes the weights and
the 4 x 10 s batch; the weights cross over through the flat format. Also the
flagship config against the reference's, the tiny cut, the device rule, and
``bench_torch.py``'s measuring function and JSON line at a tiny size."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import ast  # noqa: E402
import dataclasses  # noqa: E402
import os  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as jentry  # noqa: E402
import bench_torch  # noqa: E402
from mla_tpu.config import get_config as jax_get_config  # noqa: E402
from mla_tpu.models.convert import params_to_flat  # noqa: E402
from mla_tpu.models.zoo import build_model as jax_build_model  # noqa: E402
from mla_tpu.ops.frontend import waveform_to_patches  # noqa: E402
from mla_tpu_torch.entry import (  # noqa: E402
    entry,
    example_waveforms,
    flagship_config,
    flagship_forward,
)
from mla_tpu_torch.models.convert import flat_to_state_dict  # noqa: E402
from mla_tpu_torch.models.trunk import _BatchNormReLU  # noqa: E402
from mla_tpu_torch.models.zoo import build_model  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-4  # convolutions sum in another order than XLA's
# bf16 budget, about ten times the gap measured on the CPU (1.7e-5): the two
# frameworks round bf16 at other places, and the port's "default" front-end
# also rounds the DFT operands to bf16 where JAX on the CPU computes "default"
# in f32. The port's own f32 forward lies 4.0e-5 from its bf16 one, inside
# this budget, so the bf16 test also checks that the trunk runs in bf16.
BF16_TOL = 2e-4


@pytest.fixture(scope="module")
def reference():
    """JAX entry()'s (fn, variables, wav) at full width and its variables
    in the flat format."""
    fn, (variables, wav) = jentry.entry()
    flat = params_to_flat(jax.tree.map(np.asarray, dict(variables["params"])), prefix="params/")
    flat.update(params_to_flat(jax.tree.map(np.asarray, dict(variables["batch_stats"])),
                               prefix="batch_stats/"))
    return fn, variables, np.asarray(wav), flat


def _port(cfg, flat):
    """The port's flagship forward for ``cfg``, the model holding ``flat``
    and entry()'s batch, on the CPU."""
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(flat_to_state_dict(flat, model))
    return flagship_forward(cfg), model, torch.from_numpy(example_waveforms(cfg))


def test_flagship_config_equals_reference():
    for tiny in (False, True):
        ours, ref = flagship_config(tiny), jentry._flagship_cfg(tiny)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    cfg = flagship_config()
    m = cfg.model
    assert (m.conv_channels, m.convs_per_stage, m.n_blocks, m.hidden_units, m.n_classes,
            m.compute_dtype, cfg.frontend.impl, cfg.frontend.precision,
            cfg.train.frontend_precision) == ((64, 128, 256, 512), 2, 3, 512, 527, "bfloat16",
                                              "xla", "default", "default")


def test_flagship_forward_matches_jax_entry_bf16(reference):
    """entry() as shipped: bf16 compute, the torch-ops front-end at "default"."""
    fn, variables, wav, flat = reference
    ref = np.asarray(jax.jit(fn)(variables, wav))
    ours_fn, (model, ours_wav) = entry(device="cpu")
    model.load_state_dict(flat_to_state_dict(flat, model))
    np.testing.assert_array_equal(ours_wav.numpy(), wav)  # the same batch, drawn alike
    norm_inputs = []
    for mod in model.modules():
        if isinstance(mod, _BatchNormReLU):
            mod.register_forward_hook(lambda m, args, out: norm_inputs.append(args[0].dtype))
    probs = ours_fn(model, ours_wav).numpy()
    assert norm_inputs and set(norm_inputs) == {torch.bfloat16}  # the convolutions ran in bf16
    assert probs.shape == (4, 527) and probs.dtype == np.float32 and np.isfinite(probs).all()
    np.testing.assert_allclose(probs, ref, atol=BF16_TOL, rtol=0)


def test_flagship_forward_matches_jax_entry_f32(reference):
    """f32 compute, and the front-end at "highest" on both sides, since JAX
    on the CPU computes "default" in f32 and the port rounds it to bf16."""
    _, variables, wav, flat = reference
    jcfg = jax_get_config("audioset_full_dp", {"model.compute_dtype": "float32",
                                               "frontend.precision": "highest"})
    jmodel = jax_build_model(jcfg.model)
    ref = np.asarray(jax.jit(lambda v, w: jmodel.apply(v, waveform_to_patches(w, jcfg.frontend)))(
        variables, wav))
    cfg = flagship_config(overrides={"model.compute_dtype": "float32",
                                     "frontend.precision": "highest"})
    fn, model, ours_wav = _port(cfg, flat)
    np.testing.assert_allclose(fn(model, ours_wav).numpy(), ref, atol=F32_TOL, rtol=0)


def test_flagship_forward_on_the_fused_front_end(reference):
    """impl="pallas" takes the fused front-end's plain version on the CPU:
    the same probs as the torch-ops front-end within the bf16 budget."""
    _, _, _, flat = reference
    fn, model, wav = _port(flagship_config(), flat)
    fn_p, model_p, _ = _port(flagship_config(overrides={"frontend.impl": "pallas"}), flat)
    np.testing.assert_allclose(fn_p(model_p, wav[:2]).numpy(), fn(model, wav[:2]).numpy(),
                               atol=BF16_TOL, rtol=0)


def test_tiny_flagship_matches_jax():
    jcfg = jentry._flagship_cfg(tiny=True)
    jmodel = jax_build_model(jcfg.model)
    wav = example_waveforms(flagship_config(tiny=True))
    patches = waveform_to_patches(wav, jcfg.frontend)
    variables = jmodel.init(jax.random.key(1), patches)
    flat = params_to_flat(jax.tree.map(np.asarray, dict(variables["params"])), prefix="params/")
    flat.update(params_to_flat(jax.tree.map(np.asarray, dict(variables["batch_stats"])),
                               prefix="batch_stats/"))
    fn, model, _ = _port(flagship_config(tiny=True), flat)
    probs = fn(model, torch.from_numpy(wav)).numpy()
    assert probs.shape == (4, 32)
    np.testing.assert_allclose(probs, np.asarray(jmodel.apply(variables, patches)),
                               atol=BF16_TOL, rtol=0)


def test_entry_seed_and_device_rule():
    _, (a, wav) = entry(device="cpu")
    _, (b, _) = entry(device="cpu")
    _, (c, _) = entry(device="cpu", seed=1)
    assert wav.shape == (4, 10 * 16000) and not a.training
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_torch.main()


def _bench_py_keys():
    """The keys of bench.py's JSON line (the dict its main() prints)."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py has no result dict")


def test_bench_line_has_the_reference_keys():
    cfg = flagship_config(tiny=True)
    per_impl = {impl: bench_torch.measure(flagship_config(True, {"frontend.impl": impl}), "cpu",
                                          batch=2, seconds=2, n_iters=2, repeats=2)
                for impl in bench_torch.IMPLS}
    line = bench_torch.result_line(cfg, per_impl, "cpu", "n/a", batch=2, seconds=2, repeats=2)
    keys = _bench_py_keys()
    assert len(keys) == 13 and keys <= set(line)
    assert line["vs_baseline"] is None and line["cpu_reference_clips_per_sec"] is None
    assert line["value"] == per_impl["xla"]["infer_clips_per_sec"] > 0
    assert set(line["by_frontend_impl"]) == {"xla", "pallas"}
    for r in per_impl.values():
        assert r["train_clips_per_sec"] > 0 and np.isfinite(r["final_loss"])
        assert r["frontend_kernel_launches"] == 0  # the CPU takes the plain version
        assert r["peak_memory_gb"] is None and r["calls"] == 2 * (1 + 2 * 2)
