"""The PyTorch port's doctor (mla_tpu_torch/utils/doctor.py, the doctor
verb), mirroring tests/test_doctor.py: a quick run on the CPU is ok with
every check populated; the GEMM check reports TFLOPS and its spread; the
verdict is no-device without a device, degraded on a slow fetch or a GEMM
spread past the bar or a card the kernels are not built for, and only
warns on TF32 flags, a synchronize that does not wait or a build that
fails; the verb's exit code and JSON; the device probe times out on a
hang. The thresholds, the verdict's status and the exclusivity bar are held
against mla_tpu/utils/doctor.py on the same inputs."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import json  # noqa: E402
import threading  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.utils import doctor as jdoctor  # noqa: E402
from mla_tpu_torch.ops import _build  # noqa: E402
from mla_tpu_torch.utils import doctor  # noqa: E402

H100 = {"name": "NVIDIA H100 80GB HBM3", "capability": [9, 0]}


def test_run_quick_on_cpu_is_ok():
    report = doctor.run(device="cpu", quick=True)
    assert report["devices"] == [{"name": "cpu"}]
    assert report["platform"] == "cpu"
    assert report["verdict"]["status"] == "ok"
    for key in ("versions", "fetch_rtt", "synchronize", "compile", "matmul_precision"):
        assert key in report and report[key] and "error" not in report[key], key
    assert "gemm" not in report  # quick skips the spot check
    assert report["versions"]["torch"] == torch.__version__
    assert set(report["versions"]) == {"torch", "cuda", "cudnn", "numpy", "scipy", "triton",
                                       "nvcc", "g++"}
    # the CPU waits for its own work, and its f32 product is exact
    assert report["synchronize"]["noop"] is False
    assert report["matmul_precision"]["default_is_reduced_precision"] is False
    # on the CPU only the native front builds (the kernels are for the card)
    assert list(report["compile"]["builds"]) == ["native/serve_front.cpp"]
    assert report["compile"]["builds_ok"] is True
    json.dumps(report)  # the verb prints it


def test_gemm_check_spread_and_tflops():
    g = doctor.check_gemm_throughput("cpu", n=128, iters=2, repeats=3)
    assert g["tflops"] > 0
    assert g["rel_spread"] >= 0
    assert g["n"] == 128 and len(g["times_s"]) == 3
    ctx = doctor.exclusivity_context(device="cpu", n=128, iters=2)
    assert set(ctx) == {"gemm_tflops", "gemm_spread", "exclusive"}


def test_verdict_no_device():
    v = doctor.verdict({"devices": []})
    assert v["status"] == "no-device"
    assert v["reasons"]


def test_verdict_degraded_on_rtt_and_spread():
    base = {"devices": [{"name": "NVIDIA H100 80GB HBM3", "capability": [9, 0]}],
            "platform": "cuda", "fetch_rtt": {"median_ms": 1.0}, "gemm": {"rel_spread": 0.01}}
    assert doctor.verdict(base) == {"status": "ok", "reasons": []}
    slow = dict(base, fetch_rtt={"median_ms": doctor.RTT_DEGRADED_MS + 1})
    assert doctor.verdict(slow)["status"] == "degraded"
    shared = dict(base, gemm={"rel_spread": doctor.SPREAD_DEGRADED + 0.01})
    v = doctor.verdict(shared)
    assert v["status"] == "degraded"
    assert any("exclusive" in r for r in v["reasons"])
    other = dict(base, devices=[{"name": "A100", "capability": [8, 0]}])
    v = doctor.verdict(other)
    assert v["status"] == "degraded" and "sm_80" in v["reasons"][0]


def test_thresholds_equal_the_references():
    for name in ("RTT_DEGRADED_MS", "SPREAD_DEGRADED", "DEVICE_PROBE_TIMEOUT_S",
                 "SERVING_SPREAD_BAR"):
        assert getattr(doctor, name) == getattr(jdoctor, name), name


# one report dict fed to both packages; each reads its own synchronize key
# ("synchronize" here, "block_until_ready" there). The numbers are literals,
# not the port's constants, so a moved threshold shows.
_REPORTS = {
    "no-device": {"devices": []},
    "healthy": {"fetch_rtt": {"median_ms": 0.02}, "gemm": {"rel_spread": 0.01}},
    "no-checks-yet": {},
    "rtt-at-the-bar": {"fetch_rtt": {"median_ms": 200.0}, "gemm": {"rel_spread": 0.25}},
    "slow-fetch": {"fetch_rtt": {"median_ms": 200.5}, "gemm": {"rel_spread": 0.01}},
    "wide-spread": {"fetch_rtt": {"median_ms": 0.02}, "gemm": {"rel_spread": 0.2501}},
    "both": {"fetch_rtt": {"median_ms": 900.0}, "gemm": {"rel_spread": 0.9}},
    "sync-noop": {"fetch_rtt": {"median_ms": 0.02}, "synchronize": {"noop": True},
                  "block_until_ready": {"noop": True}},
    "reduced-precision": {"matmul_precision": {"default_is_reduced_precision": True}},
}


@pytest.mark.parametrize("case", sorted(_REPORTS))
def test_verdict_status_equals_the_references(case):
    """Same report, same status: ok / degraded / no-device. The reasons on
    RTT and spread read alike; the port's own reasons (the card's
    capability, TF32 flags, builds) are left out by giving an sm_90 card on
    a CPU platform with no build results."""
    report = dict(_REPORTS[case], platform="cpu")
    report.setdefault("devices", [H100])
    ours, ref = doctor.verdict(report), jdoctor.verdict(report)
    assert ours["status"] == ref["status"], (ours, ref)
    expected = {"no-device": "no-device", "slow-fetch": "degraded",
                "wide-spread": "degraded", "both": "degraded"}.get(case, "ok")
    assert ours["status"] == expected
    shared = [r for r in ref["reasons"] if r.startswith(("host fetch RTT", "GEMM repeat"))]
    assert [r for r in ours["reasons"] if r.startswith(("host fetch RTT", "GEMM repeat"))] \
        == shared
    assert len(ours["reasons"]) == len(ref["reasons"])


@pytest.mark.parametrize("spread", [0.0, 0.0499, 0.05, 0.0501, 0.3])
def test_exclusivity_context_equals_the_references(monkeypatch, spread):
    """The same GEMM result stamped by both packages: equal rounding and the
    same 5% serving bar."""
    g = {"n": 128, "iters": 2, "tflops": 1.23456, "median_s": 0.01, "rel_spread": spread}
    monkeypatch.setattr(doctor, "check_gemm_throughput", lambda **kw: g)
    monkeypatch.setattr(jdoctor, "check_gemm_throughput", lambda **kw: g)
    assert doctor.exclusivity_context() == jdoctor.exclusivity_context()
    assert doctor.exclusivity_context()["exclusive"] is (spread <= 0.05)


def test_verdict_tf32_and_platform_facts_warn_but_do_not_degrade():
    # TF32 flags on (PyTorch leaves cuDNN's on), a synchronize that does not
    # wait, a reduced-precision default and a failed build are reasons, not
    # sickness: the status stays ok
    report = {
        "devices": [{"name": "NVIDIA H100 80GB HBM3", "capability": [9, 0]}],
        "platform": "cuda",
        "fetch_rtt": {"median_ms": 0.02},
        "gemm": {"rel_spread": 0.05},
        "synchronize": {"noop": True},
        "compile": {"builds": {"csrc/adpcm.cu": {"ok": False, "error": "RuntimeError: x\ny"}}},
        "matmul_precision": {"matmul_allow_tf32": True, "cudnn_allow_tf32": True,
                             "default_is_reduced_precision": True},
    }
    v = doctor.verdict(report)
    assert v["status"] == "ok"
    assert len(v["reasons"]) == 5
    assert sum("TF32" in r for r in v["reasons"]) == 2
    assert any(r == "csrc/adpcm.cu does not build: RuntimeError: x" for r in v["reasons"])
    # the same flags on the CPU are no reason: no TF32 there
    assert len(doctor.verdict(dict(report, platform="cpu"))["reasons"]) == 3


def test_a_build_that_fails_is_recorded_not_raised(monkeypatch):
    def broken(name):
        raise RuntimeError("g++ failed for serve_front.cpp (exit 1)")

    monkeypatch.setattr(_build, "load_native", broken)
    c = doctor.check_compile_latency("cpu")
    assert c["builds_ok"] is False
    assert c["builds"]["native/serve_front.cpp"] == {
        "ok": False, "error": "RuntimeError: g++ failed for serve_front.cpp (exit 1)"}


def test_cli_doctor_exit_code_and_json(capsys, monkeypatch):
    from mla_tpu_torch.__main__ import main

    assert main(["doctor", "--quick", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["verdict"]["status"] == "ok" and report["platform"] == "cpu"
    # without a card the default device is none: exit 2, no fall-back to the CPU
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert main(["doctor", "--quick"]) == 2
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["devices"] == [] and report["verdict"]["status"] == "no-device"
    assert "fetch_rtt" not in report


def test_probe_devices_times_out_on_hang(monkeypatch):
    # a driver that never answers must yield None after the timeout, not
    # hang the caller
    never = threading.Event()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: never.wait() and 0)
    try:
        assert doctor.probe_devices(timeout_s=0.2) is None
        report = doctor.run(device_timeout_s=0.2, quick=True)
        assert report["verdict"]["status"] == "no-device"
    finally:
        never.set()
