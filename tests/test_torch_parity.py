"""The PyTorch port's parity harness (mla_tpu_torch/parity.py, the parity
verb): on the CPU every check passes within the reference's bound (2e-4
front-end, 1e-5 model, 1e-10 metrics against sklearn) under the reference's
check names; a missing golden raises with its path; the TF32 flags are
pinned off inside a check and the caller's restored after; a missing
sklearn skips its check; the verb's exit code."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import json  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu import parity as jparity  # noqa: E402
from mla_tpu_torch import _device, parity  # noqa: E402
from mla_tpu_torch.ops import frontend  # noqa: E402

# the reference's check names (mla_tpu/parity.py::run_all) and bounds
BOUNDS = {"frontend_matmul": 2e-4, "frontend_fft": 2e-4, "frontend_pallas": 2e-4,
          "model_multi_level_attention": 1e-5, "model_single_attention": 1e-5,
          "model_multi_attention": 1e-5, "model_avg_pool": 1e-5, "model_max_pool": 1e-5,
          "metrics_vs_sklearn": 1e-10}


@pytest.fixture(scope="module")
def results():
    return parity.run_all(device="cpu")


def test_every_check_passes_on_the_cpu_within_the_references_bound(results):
    assert [r["check"] for r in results] == list(BOUNDS)
    for r in results:
        assert r["pass"] is True, r
        assert 0.0 <= r["max_abs_err"] < BOUNDS[r["check"]], r
    json.dumps(results)


def test_check_names_and_bounds_are_the_references():
    """The reference's model and metrics checks (no Pallas interpreter
    needed) carry the same names; the port's bounds are the reference's."""
    assert jparity.check_model()["check"] == parity.check_model("cpu")["check"]
    assert jparity.check_metrics()["check"] == parity.check_metrics()["check"]
    assert (parity.FRONTEND_BOUND, parity.MODEL_BOUND, parity.METRICS_BOUND) == (
        2e-4, 1e-5, 1e-10)


def test_model_golden_error_matches_the_references():
    """The golden forward: the port's error and JAX's, both at f32, within
    the bound and within 1e-6 of each other."""
    ours, ref = parity.check_model("cpu"), jparity.check_model()
    assert abs(ours["max_abs_err"] - ref["max_abs_err"]) < 1e-6


def test_a_missing_golden_raises_with_its_path(tmp_path, monkeypatch):
    monkeypatch.setattr(parity, "GOLDEN_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "frontend_golden.npz")):
        parity.check_frontend("matmul", "cpu")
    with pytest.raises(FileNotFoundError, match="model_golden.npz"):
        parity.check_model("cpu")
    assert list(tmp_path.iterdir()) == []  # nothing regenerated


@pytest.mark.parametrize("matmul_precision,cudnn", [("high", True), ("highest", True),
                                                    ("medium", False)])
def test_tf32_is_off_inside_the_checks_and_the_flags_are_restored(monkeypatch,
                                                                   matmul_precision, cudnn):
    before = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision(matmul_precision)
        torch.backends.cudnn.allow_tf32 = cudnn
        callers = _device.tf32_flags()
        seen = []
        real = frontend.waveform_to_patches
        monkeypatch.setattr(frontend, "waveform_to_patches",
                            lambda *a, **k: seen.append(_device.tf32_flags()) or real(*a, **k))
        assert parity.check_frontend("matmul", "cpu")["pass"]
        assert seen[0]["matmul_allow_tf32"] is False and seen[0]["cudnn_allow_tf32"] is False
        assert seen[0]["float32_matmul_precision"] == "highest"
        assert _device.tf32_flags() == callers
        with pytest.raises(ZeroDivisionError), _device.tf32_off():
            1 / 0
        assert _device.tf32_flags() == callers
    finally:
        torch.set_float32_matmul_precision(before[0])
        torch.backends.cudnn.allow_tf32 = before[1]


def test_metrics_check_is_skipped_without_sklearn(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "sklearn.metrics", None)
    r = parity.check_metrics()
    assert r == {"check": "metrics_vs_sklearn", "max_abs_err": None, "pass": None,
                 "skipped": "sklearn not importable"}
    monkeypatch.setattr(parity, "run_all", lambda device=None: [
        {"check": "model_avg_pool", "max_abs_err": 0.0, "pass": True}, r])
    assert parity.main("cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "# skipped: metrics_vs_sklearn (sklearn not importable)"


def test_parity_verb_exit_codes(monkeypatch, capsys):
    from mla_tpu_torch.__main__ import main

    assert main(["parity", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln)["check"] for ln in lines] == list(BOUNDS)
    monkeypatch.setattr(parity, "run_all", lambda device=None: [
        {"check": "model_avg_pool", "max_abs_err": 1.0, "pass": False}])
    assert main(["parity", "--device", "cpu"]) == 1


def test_parity_needs_a_card_unless_given_the_cpu(monkeypatch):
    from mla_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity.run_all()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["parity"])
