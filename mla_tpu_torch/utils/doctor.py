"""Environment self-check (``python -m mla_tpu_torch doctor``; counterpart of
``mla_tpu/utils/doctor.py``): one command that answers "is this host fit to
train or serve on its card right now?" before a long run is launched. Each
check returns data, not a judgment; ``verdict()`` folds them into ``ok`` /
``degraded`` / ``no-device`` with readable reasons.

The failure modes it looks for, on a CUDA host:
- a wedged driver can block the first CUDA call forever: the device probe
  runs in a daemon thread with a timeout;
- ``torch.cuda.synchronize`` must wait for the device, or timing code lies:
  a dependent matmul chain is timed under synchronize and under ``.item()``;
- every host fetch costs a round trip (``.item()``'s median);
- f32 products and cuDNN convolutions may round to TF32 (PyTorch leaves
  ``torch.backends.cudnn.allow_tf32`` on): parity paths must turn it off;
- the port's kernels are built for ``sm_90a`` by nvcc, its native front by
  g++: both builds must load;
- a card shared with another job pollutes benchmarks, which shows as spread
  across timed GEMM repeats.
"""

from __future__ import annotations

import subprocess
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mla_tpu_torch._device import tf32_flags, tf32_off

# thresholds for verdict(); module-level so tests can reference them
RTT_DEGRADED_MS = 200.0     # a host fetch slower than this: the host or driver is sick
SPREAD_DEGRADED = 0.25      # (max - min) / median across GEMM repeats
DEVICE_PROBE_TIMEOUT_S = 120.0
SERVING_SPREAD_BAR = 0.05   # benchmark numbers are quoted to ~1%: rerun above 5%
KERNEL_CAPABILITY = (9, 0)  # the port's kernels are built for sm_90a


def probe_devices(timeout_s: float = DEVICE_PROBE_TIMEOUT_S, device=None) -> Optional[list]:
    """The devices ``device`` names (None = the cards), each as a dict, or
    None when the probe did not answer within ``timeout_s`` (the thread is
    a daemon: a wedged driver call cannot pin the process). ``device="cpu"``
    lists the host alone."""
    out: Dict[str, Any] = {}

    def probe():
        if device is not None and torch.device(device).type == "cpu":
            out["devices"] = [{"name": "cpu"}]
            return
        out["devices"] = [{"index": i, "name": torch.cuda.get_device_name(i),
                           "capability": list(torch.cuda.get_device_capability(i))}
                          for i in range(torch.cuda.device_count())]

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    return out.get("devices")


def _tool_version(cmd: List[str], pick: str = "") -> str:
    """The first line of ``cmd``'s output containing ``pick``, or "missing"."""
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "missing"
    lines = [ln for ln in (r.stdout or r.stderr).splitlines() if pick in ln]
    return lines[0].strip() if r.returncode == 0 and lines else "missing"


def check_versions() -> Dict[str, str]:
    from mla_tpu_torch.ops import _build

    vers = {"torch": torch.__version__, "cuda": str(torch.version.cuda),
            "cudnn": str(torch.backends.cudnn.version())}
    for mod in ("numpy", "scipy", "triton"):
        try:
            vers[mod] = getattr(__import__(mod), "__version__", "?")
        except Exception:  # noqa: BLE001 - an absent optional package is data
            vers[mod] = "missing"
    try:
        nvcc = _build._nvcc()
    except RuntimeError:
        nvcc = None
    vers["nvcc"] = _tool_version([nvcc, "--version"], "release") if nvcc else "missing"
    vers["g++"] = _tool_version(["g++", "--version"])
    return vers


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_fetch_rtt(device="cuda", iters: int = 9) -> Dict[str, float]:
    """Median and max wall time of one scalar host fetch (``.item()``)."""
    dev = torch.device(device)
    x = torch.ones((), device=dev) + 1.0
    x.item()  # first-fetch costs outside the timing
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        x.item()
        times.append(time.perf_counter() - t0)
    return {"median_ms": float(np.median(times)) * 1e3, "max_ms": float(np.max(times)) * 1e3}


def check_synchronize_noop(device="cuda") -> Dict[str, Any]:
    """Whether ``torch.cuda.synchronize`` really waits: a dependent matmul
    chain timed under synchronize and under a host fetch. When synchronize
    is honest the two are comparable; one >20x faster than the fetch means
    only fetches wait, and timing code must fetch. The chain is sized so an
    honest wait still takes milliseconds on a fast card."""
    dev = torch.device(device)
    n, chain = (512, 8) if dev.type == "cpu" else (4096, 8)

    def work(a):
        for _ in range(chain):
            a = a @ a * (1.0 / n)
        return a.sum()

    a = torch.full((n, n), 1.0 / n, device=dev)
    work(a).item()  # warm-up
    t0 = time.perf_counter()
    work(a)
    _sync(dev)
    sync_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    work(a).item()
    fetch_s = time.perf_counter() - t0
    return {"sync_ms": sync_s * 1e3, "fetch_ms": fetch_s * 1e3,
            "noop": bool(fetch_s > 0.002 and sync_s < fetch_s / 20)}


def check_compile_latency(device="cuda") -> Dict[str, Any]:
    """First against cached call of an odd-shaped product (library handles
    and kernel selection on first use), and whether the port's own builds
    load and in how long: each ``csrc/*.cu`` through nvcc (on a card only)
    and ``native/serve_front.cpp`` through g++. A build that fails is
    recorded with its error, not raised."""
    from mla_tpu_torch.ops import _build

    dev = torch.device(device)
    x = torch.ones((37, 53), device=dev)  # a shape no earlier check used
    t0 = time.perf_counter()
    torch.tanh(x @ x.T).sum().item()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.tanh(x @ x.T).sum().item()
    cached = time.perf_counter() - t0
    builds: Dict[str, Any] = {}

    def timed(name, path_fn, load_fn):
        t0 = time.perf_counter()
        try:
            was_built = path_fn().exists()
            load_fn()
            builds[name] = {"ok": True, "s": time.perf_counter() - t0, "was_built": was_built}
        except Exception as e:  # noqa: BLE001 - a failing build is data
            builds[name] = {"ok": False, "error": f"{type(e).__name__}: {e}"[:2000]}

    if dev.type == "cuda":
        from mla_tpu_torch.ops import adpcm, fused_frontend, row_merge

        for name, sigs in (("fused_frontend", fused_frontend._SIGNATURES),
                           ("row_merge", row_merge._SIGNATURES), ("adpcm", adpcm._SIGNATURES)):
            timed(f"csrc/{name}.cu", lambda n=name: _build.library_path(n),
                  lambda n=name, s=sigs: _build.load(n, s))
    timed("native/serve_front.cpp", lambda: _build.native_library_path("serve_front"),
          lambda: _build.load_native("serve_front"))
    return {"first_call_ms": first * 1e3, "cached_call_ms": cached * 1e3, "builds": builds,
            "builds_ok": all(b["ok"] for b in builds.values())}


def check_matmul_precision(device="cuda") -> Dict[str, Any]:
    """The TF32 flags, and the measured relative error of an f32 product at
    the current (default) flags against the same product with TF32 off."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32)).to(dev)
    d = a @ b
    with tf32_off():
        h = a @ b
    rel = float((d - h).abs().max() / h.abs().max())
    return {**tf32_flags(), "default_vs_highest_rel_err": rel,
            "default_is_reduced_precision": bool(rel > 1e-5)}


def check_gemm_throughput(device="cuda", n: Optional[int] = None, iters: Optional[int] = None,
                          repeats: int = 3) -> Dict[str, float]:
    """f32 GEMM throughput at the default flags and its repeat spread (the
    exclusive-card detector: a spread over ~25% means another job shares
    the device). A chain of ``iters`` products x @ a, where a is the constant
    1/n matrix (x keeps its values), per repeat; timed with CUDA events on a
    card, on the host clock on the CPU. Defaults: 4096 x 40 on a card (~0.1 s
    a repeat), 512 x 6 on the CPU."""
    dev = torch.device(device)
    cpu = dev.type == "cpu"
    n = n or (512 if cpu else 4096)
    iters = iters or (6 if cpu else 40)
    a = torch.full((n, n), 1.0 / n, device=dev)
    x = torch.full((n, n), 1.0 / n, device=dev)

    def work():
        y = x
        for _ in range(iters):
            y = y @ a
        return y

    work()
    _sync(dev)  # warm-up
    times = []
    for _ in range(repeats):
        if cpu:
            t0 = time.perf_counter()
            work()
            times.append(time.perf_counter() - t0)
        else:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            work()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    med = float(np.median(times))
    return {"n": n, "iters": iters, "tflops": 2.0 * n * n * n * iters / med / 1e12,
            "median_s": med, "times_s": times, "rel_spread": (max(times) - min(times)) / med}


def exclusivity_context(**gemm_kwargs) -> Dict[str, float]:
    """One quick GEMM spread probe to stamp onto benchmark output:
    {'gemm_tflops', 'gemm_spread', 'exclusive'}, ``exclusive`` at the
    serving bar (5%), stricter than verdict()'s threshold."""
    g = check_gemm_throughput(**gemm_kwargs)
    return {"gemm_tflops": round(g["tflops"], 2), "gemm_spread": round(g["rel_spread"], 3),
            "exclusive": g["rel_spread"] <= SERVING_SPREAD_BAR}


def verdict(report: Dict[str, Any]) -> Dict[str, Any]:
    """Fold check results into ok / degraded / no-device + reasons. Degraded:
    a slow fetch, a GEMM spread past the bar, or a card the kernels are not
    built for. The rest are facts of the platform, reasons without a
    degrade."""
    if not report.get("devices"):
        return {"status": "no-device",
                "reasons": ["device probe timed out or found no device: no CUDA card, or "
                            "the driver is not answering"]}
    reasons: List[str] = []
    degraded = False
    rtt = report.get("fetch_rtt", {}).get("median_ms", 0.0)
    if rtt > RTT_DEGRADED_MS:
        reasons.append(f"host fetch RTT {rtt:.0f} ms (> {RTT_DEGRADED_MS:.0f})")
        degraded = True
    spread = report.get("gemm", {}).get("rel_spread", 0.0)
    if spread > SPREAD_DEGRADED:
        reasons.append(f"GEMM repeat spread {spread:.0%} — device likely NOT exclusive")
        degraded = True
    for d in report["devices"]:
        cap = d.get("capability")
        if cap is not None and tuple(cap) != KERNEL_CAPABILITY:
            reasons.append(f"{d['name']} is sm_{cap[0]}{cap[1]}: the port's kernels are built "
                           f"for sm_90a")
            degraded = True
    if report.get("synchronize", {}).get("noop"):
        reasons.append("torch.cuda.synchronize does not wait here: time by fetching a result")
    builds = report.get("compile", {}).get("builds", {})
    for name, b in builds.items():
        if not b.get("ok", True):
            reasons.append(f"{name} does not build: {b['error'].splitlines()[0]}")
    prec = report.get("matmul_precision", {})
    if report.get("platform") == "cuda":
        if prec.get("matmul_allow_tf32"):
            reasons.append("f32 products may round to TF32 (torch.backends.cuda.matmul."
                           "allow_tf32 is on): turn it off on parity paths")
        if prec.get("cudnn_allow_tf32"):
            reasons.append("cuDNN convolutions may round to TF32 (torch.backends.cudnn."
                           "allow_tf32 is on, PyTorch's default): turn it off on parity paths")
    if prec.get("default_is_reduced_precision"):
        reasons.append("the default f32 product is reduced precision: pin "
                       "torch.set_float32_matmul_precision('highest') on parity paths")
    return {"status": "degraded" if degraded else "ok", "reasons": reasons}


def run(device=None, device_timeout_s: float = DEVICE_PROBE_TIMEOUT_S,
        quick: bool = False) -> Dict[str, Any]:
    """Run every check on ``device`` (None = the first card; "cpu" the
    host); never raises on a sick environment (the report is the product).
    ``quick`` skips the GEMM spot check."""
    report: Dict[str, Any] = {"versions": check_versions()}
    devices = probe_devices(device_timeout_s, device)
    report["devices"] = devices or []
    if not devices:
        report["verdict"] = verdict(report)
        return report
    dev = torch.device("cuda" if device is None else device)
    report["platform"] = dev.type
    checks = [("fetch_rtt", check_fetch_rtt), ("synchronize", check_synchronize_noop),
              ("compile", check_compile_latency), ("matmul_precision", check_matmul_precision)]
    if not quick:
        checks.append(("gemm", check_gemm_throughput))
    for name, fn in checks:
        try:
            report[name] = fn(dev)
        except Exception as e:  # noqa: BLE001 - a failing check is data
            report[name] = {"error": f"{type(e).__name__}: {e}"}
    report["verdict"] = verdict(report)
    return report
