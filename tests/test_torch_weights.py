"""The port's ``weights`` verb against the reference's (both CLIs in
process): a flat .npz written by the port's ``--out`` loads in JAX's
``weights --load`` and the reverse, array for array; ``--allow_partial``
warm-starts the intersection for another class count; ``--ema`` dumps the
EMA shadow seeded from the imported weights; the key and shape mismatch
errors carry the reference's messages; and the VGGish importers
(``models/convert.py``) equal the reference's in both flatten orders."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.__main__ import main as jmain  # noqa: E402
from mla_tpu.models import convert as jconvert  # noqa: E402
from mla_tpu_torch.__main__ import main as tmain  # noqa: E402
from mla_tpu_torch.config import get_config  # noqa: E402
from mla_tpu_torch.models import convert  # noqa: E402
from mla_tpu_torch.train.loop import resume  # noqa: E402
from tests.torch_port_common import SMALL, configs, jax_weights  # noqa: E402

CONFIG = "streaming_inference"  # the verb's default config


def _sets(extra=None):
    return ["--set"] + [f"{k}={v}" for k, v in {**SMALL, **(extra or {})}.items()]


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """(path, flat) of perturbed JAX-initialized weights at SMALL."""
    jcfg, _ = configs()
    _, flat = jax_weights(jcfg.model, seed=3)
    path = tmp_path_factory.mktemp("w") / "w.npz"
    np.savez(path, **flat)
    return str(path), flat


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out.strip()


def _assert_npz_equal(path, flat):
    with np.load(path) as got:
        assert set(got.files) == set(flat)
        for k, a in flat.items():
            np.testing.assert_array_equal(got[k], a, err_msg=k)


def test_npz_moves_both_ways_between_the_packages(npz, tmp_path, capsys):
    path, flat = npz
    t_ws, j_ws, t2_ws = (str(tmp_path / n) for n in ("t", "j", "t2"))
    msg_t = _run(tmain, ["weights", "--workspace", t_ws, "--load", path] + _sets(), capsys)
    msg_j = _run(jmain, ["weights", "--workspace", j_ws, "--load", path] + _sets(), capsys)
    assert msg_t.replace(t_ws, "W") == msg_j.replace(j_ws, "W")
    assert msg_t.startswith(f"imported {len(flat)}/{len(flat)} arrays -> checkpoint step 0")
    # port --out -> JAX --load -> JAX --out -> port --load -> port --out
    p_npz, j_npz, p2_npz = (str(tmp_path / n) for n in ("p.npz", "j.npz", "p2.npz"))
    out_t = _run(tmain, ["weights", "--workspace", t_ws, "--out", p_npz] + _sets(), capsys)
    assert out_t == f"{len(flat)} weight arrays -> {p_npz}"
    _assert_npz_equal(p_npz, flat)
    _run(jmain, ["weights", "--workspace", str(tmp_path / "j2"), "--load", p_npz] + _sets(),
         capsys)
    _run(jmain, ["weights", "--workspace", str(tmp_path / "j2"), "--out", j_npz] + _sets(),
         capsys)
    _assert_npz_equal(j_npz, flat)
    _run(tmain, ["weights", "--workspace", t2_ws, "--load", j_npz] + _sets(), capsys)
    _run(tmain, ["weights", "--workspace", t2_ws, "--out", p2_npz] + _sets(), capsys)
    _assert_npz_equal(p2_npz, flat)
    # the step-0 checkpoint carries exactly the imported weights
    state, sampler = resume(get_config(CONFIG, SMALL), t2_ws, device="cpu")
    assert state.step == 0 and sampler == {"imported_from": "j.npz", "step": 0}
    back = convert.state_dict_to_flat(state.model.state_dict())
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


def _exit_message(main, argv):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return str(e.value.code)


def test_allow_partial_warm_starts_other_class_count(npz, tmp_path, capsys):
    path, flat = npz
    seven = {"model.n_classes": 7}
    argv = ["weights", "--load", path] + _sets(seven)
    msg_t = _exit_message(tmain, argv + ["--workspace", str(tmp_path / "t")])
    msg_j = _exit_message(jmain, argv + ["--workspace", str(tmp_path / "j")])
    assert msg_t == msg_j and ": shape (" in msg_t and "!= expected" in msg_t
    t_ws = str(tmp_path / "tp")
    out_t = _run(tmain, argv + ["--allow_partial", "--workspace", t_ws], capsys)
    out_j = _run(jmain, argv + ["--allow_partial", "--workspace", str(tmp_path / "jp")], capsys)
    counts = out_t.split(" arrays")[0]
    assert counts == out_j.split(" arrays")[0]
    n_used, n_all = map(int, counts.split()[1].split("/"))
    assert 0 < n_used < n_all == len(flat)
    state, _ = resume(get_config(CONFIG, {**SMALL, **seven}), t_ws, device="cpu")
    got = convert.state_dict_to_flat(state.model.state_dict())
    kept = [k for k in flat if got[k].shape == flat[k].shape]
    fresh = [k for k in flat if got[k].shape != flat[k].shape]
    assert len(kept) == n_used and fresh and all(k.startswith("params/att") or
                                                 k.startswith("params/out") for k in fresh)
    for k in kept:
        np.testing.assert_array_equal(got[k], flat[k], err_msg=k)


def test_key_mismatch_message_is_the_reference(npz, tmp_path):
    path, flat = npz
    broken = dict(flat)
    broken.pop("params/out/bias")
    broken["params/extra/kernel"] = np.zeros((2, 2), np.float32)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **broken)
    argv = ["weights", "--load", bad] + _sets()
    msg_t = _exit_message(tmain, argv + ["--workspace", str(tmp_path / "t")])
    assert msg_t == _exit_message(jmain, argv + ["--workspace", str(tmp_path / "j")])
    assert "missing ['params/out/bias']" in msg_t and "params/extra/kernel" in msg_t
    none = ["weights"] + _sets() + ["--workspace", str(tmp_path / "n")]
    assert _exit_message(tmain, none) == _exit_message(jmain, none)


def test_ema_dump_is_seeded_from_the_import(npz, tmp_path, capsys):
    path, flat = npz
    t_ws, j_ws = str(tmp_path / "t"), str(tmp_path / "j")
    for main, ws in ((tmain, t_ws), (jmain, j_ws)):
        _run(main, ["weights", "--workspace", ws, "--load", path]
             + _sets({"train.ema_decay": 0.9}), capsys)
        _run(main, ["weights", "--workspace", ws, "--out", str(tmp_path / f"{ws[-1]}.npz"),
                    "--ema"] + _sets({"train.ema_decay": 0.9}), capsys)
        _assert_npz_equal(str(tmp_path / f"{ws[-1]}.npz"), flat)
    # without an EMA shadow both refuse with one message
    ws0 = str(tmp_path / "t0"), str(tmp_path / "j0")
    for main, ws in zip((tmain, jmain), ws0):
        _run(main, ["weights", "--workspace", ws, "--load", path] + _sets(), capsys)
    msgs = [_exit_message(main, ["weights", "--workspace", ws, "--out",
                                 str(tmp_path / "x.npz"), "--ema"] + _sets())
            for main, ws in zip((tmain, jmain), ws0)]
    assert msgs[0] == msgs[1] == ("checkpoint has no EMA shadow "
                                  "(trained with train.ema_decay=0)")


def _torchvggish_state_dict(seed, fc1_out=4):
    """A torchvggish-layout state dict of numpy arrays (narrow convs, the
    first FC's 6*4*512 input kept, its output cut to ``fc1_out``)."""
    rng = np.random.default_rng(seed)
    convs = {"features.0": (8, 1), "features.3": (8, 8), "features.6": (8, 8),
             "features.8": (8, 8), "features.11": (8, 8), "features.13": (8, 8)}
    sd = {}
    for name, (o, i) in convs.items():
        sd[f"{name}.weight"] = rng.standard_normal((o, i, 3, 3)).astype(np.float32)
        sd[f"{name}.bias"] = rng.standard_normal(o).astype(np.float32)
    for name, (o, i) in {"embeddings.0": (fc1_out, 6 * 4 * 512), "embeddings.2": (3, fc1_out),
                         "embeddings.4": (2, 3)}.items():
        sd[f"{name}.weight"] = rng.standard_normal((o, i)).astype(np.float32)
        sd[f"{name}.bias"] = rng.standard_normal(o).astype(np.float32)
    return sd


@pytest.mark.parametrize("order", ["nhwc", "nchw"])
def test_vggish_importers_match_the_reference(order):
    sd = _torchvggish_state_dict(11)
    got = convert.torch_vggish_to_flax(sd, flatten_order=order)
    want = jconvert.torch_vggish_to_flax(sd, flatten_order=order)
    assert got.keys() == want.keys()
    for k in want:
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(got[k][leaf], want[k][leaf], err_msg=f"{k}/{leaf}")
    # torch tensors in, the same arrays out
    got_t = convert.torch_vggish_to_flax({k: torch.from_numpy(v) for k, v in sd.items()},
                                         flatten_order=order)
    np.testing.assert_array_equal(got_t["fc1_1"]["kernel"], want["fc1_1"]["kernel"])
    back = convert.flax_vggish_to_torch(got, flatten_order=order)
    want_back = jconvert.flax_vggish_to_torch(want, flatten_order=order)
    assert back.keys() == want_back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k], want_back[k], err_msg=k)
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)  # the inverse


def test_vggish_importer_refuses_unknown_order():
    with pytest.raises(ValueError, match="unknown flatten_order"):
        convert.torch_vggish_to_flax(_torchvggish_state_dict(0), flatten_order="hwcn")
