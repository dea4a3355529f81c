"""Weight bridge of the PyTorch port: JAX init -> flat -> torch state_dict
-> flat is the identity, and the bridge rejects what does not fit."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.models import convert as jax_convert  # noqa: E402
from mla_tpu_torch.models import convert  # noqa: E402
from mla_tpu_torch.models.zoo import build_model  # noqa: E402
from tests.torch_port_common import configs, jax_weights  # noqa: E402

VARIANTS = ["multi_level_attention", "single_attention", "multi_attention", "avg_pool",
            "max_pool"]


@pytest.mark.parametrize("variant,trunk", [(v, "cnn") for v in VARIANTS]
                         + [("multi_level_attention", "none")])
def test_flat_state_dict_round_trip_is_identity(variant, trunk):
    jcfg, tcfg = configs({"model.variant": variant, "model.trunk": trunk,
                          "model.n_attention_heads": 2})
    _, flat = jax_weights(jcfg.model, seed=1)
    model = build_model(tcfg.model, device="cpu")
    sd = convert.flat_to_state_dict(flat, model)
    model.load_state_dict(sd)  # strict: every key of the model is filled
    back = convert.state_dict_to_flat(model.state_dict())
    assert set(back) == set(flat)  # every flat key consumed and given back
    for key, a in flat.items():
        assert back[key].shape == a.shape, key
        np.testing.assert_array_equal(back[key], a, err_msg=key)


def test_conv_dense_and_batchnorm_layouts():
    jcfg, tcfg = configs()
    _, flat = jax_weights(jcfg.model)
    sd = convert.flat_to_state_dict(flat, build_model(tcfg.model, device="cpu"))
    hwio = flat["params/trunk_module/conv1_0/kernel"]
    np.testing.assert_array_equal(sd["trunk_module.conv1_0.weight"].numpy(),
                                  hwio.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["block1.fc0.weight"].numpy(),
                                  flat["params/block1/fc0/kernel"].T)
    np.testing.assert_array_equal(sd["trunk_module.bn0_0.weight"].numpy(),
                                  flat["params/trunk_module/bn0_0/scale"])
    np.testing.assert_array_equal(sd["trunk_module.bn0_0.running_var"].numpy(),
                                  flat["batch_stats/trunk_module/bn0_0/var"])
    assert int(sd["trunk_module.bn0_0.num_batches_tracked"]) == 0


@pytest.mark.parametrize("fault", ["unknown", "missing", "shape", "bad_leaf"])
def test_bridge_rejects_what_does_not_fit(fault):
    jcfg, tcfg = configs()
    _, flat = jax_weights(jcfg.model)
    model = build_model(tcfg.model, device="cpu")
    if fault == "unknown":
        flat["params/att9/gate/kernel"] = np.zeros((32, 5), np.float32)
        err = KeyError
    elif fault == "missing":
        del flat["batch_stats/trunk_module/bn1_0/mean"]
        err = KeyError
    elif fault == "shape":
        flat["params/out/kernel"] = np.zeros((5, 15), np.float32)
        err = ValueError
    else:
        flat["params/out/gamma"] = np.zeros(5, np.float32)
        err = KeyError
    with pytest.raises(err):
        convert.flat_to_state_dict(flat, model)


def test_load_flat_npz(tmp_path):
    jcfg, tcfg = configs()
    _, flat = jax_weights(jcfg.model)
    path = tmp_path / "w.npz"
    np.savez_compressed(path, **flat)
    loaded = convert.load_flat_npz(str(path))
    assert set(loaded) == set(flat)
    model = build_model(tcfg.model, device="cpu")
    model.load_state_dict(convert.flat_to_state_dict(loaded, model))
    assert torch.equal(model.out.bias, torch.from_numpy(flat["params/out/bias"]))


def test_params_flat_helpers_match_reference():
    tree = {"a": {"b": {"kernel": np.ones((2, 3))}, "c": np.arange(3.0)}, "d": np.zeros(1)}
    ours, ref = convert.params_to_flat(tree, "params/"), jax_convert.params_to_flat(tree, "params/")
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
        assert ours[k].dtype == np.float32
    assert convert.flat_to_params(ours).keys() == jax_convert.flat_to_params(ref).keys()
