#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mla_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing its last line:
  1. device: the card's name, power limit and compute capability (9, 0);
  2. build: the kernel from mla_tpu_torch/csrc, timed, with nvcc's ptxas
     report;
  3. each kernel against its plain torch version on the card, at the main
     path's shapes and a few others, per precision mode, and against the
     front-end golden file (TF32 off);
  4. the main path at full width: BatchedStreamingServer on the
     streaming_inference preset with frontend.impl="pallas", random weights
     from a seeded torch.Generator through the flat weight format, 8 int16
     streams of ~20-30 s fed in uneven blocks, ticks, flushes and scores;
     the launch counters must show the kernel ran once per device step, and
     the scores must agree with the same server on the torch-ops front-end;
  5. times (median of 30 after warm-up): each kernel and its plain version
     with CUDA events, one server tick on the host clock, the kernel's
     bound, and a torch.profiler breakdown of ten ticks.
It prints the card's line from nvidia-smi, one JSON line of per-kernel
numbers, and last {"ok": true, "device": {...}}. The full record also goes
to build/chip_smoke.json.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
REPS = 30
# published H100 SXM peaks (NVIDIA data sheet, dense): f32 on the CUDA cores,
# bf16 on the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_BYTES = 3.35e12
TOL = {"highest": 2e-4, "bf16x3": 5e-4, "default": 1e-3}  # kernel vs plain version
BF16_SCORE_BUDGET = 2e-2  # scores, pallas vs torch-ops front-end under bf16 compute
MAIN_PRECISION = "default"  # the streaming_inference preset's front-end precision


def _median_ms(fn, reps: int = REPS, inner: int = 10, warmup: int = 3) -> float:
    """Median device time of one fn() call in ms: CUDA events around each of
    ``reps`` bursts of ``inner`` back-to-back calls, so the host's launch
    cost hides behind the queue as it does in a running server."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _profile_ticks(srv, n_ticks: int):
    """torch.profiler over n_ticks ticks: (host ms per tick, device-busy ms
    per tick, [(operator or kernel, device ms per tick)] for the top eight), or busy
    None if the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            srv.tick()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n_ticks
    spans = [(ev.time_range.start, ev.time_range.end) for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return host_ms, None, []
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):  # union of the device intervals
        if cur_e is None or s > cur_e:
            busy_us += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    # device time by the operator that launched it (kernel names are templates)
    ops = [(ev.key, ev.self_device_time_total) for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CPU and ev.self_device_time_total > 0]
    # the port's own kernels are launched through ctypes, outside any operator
    ops += [("kernel fused_log_mel_patches", ev.time_range.elapsed_us())
            for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
            and "fused_log_mel" in ev.name]
    totals = {}
    for k, v in ops:
        totals[k] = totals.get(k, 0.0) + v
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:8]
    return host_ms, busy_us / 1e3 / n_ticks, [(k, v / 1e3 / n_ticks) for k, v in top]


def _drive(srv, streams, schedule):
    """Feed the streams in the schedule's uneven blocks with ticks between,
    drain, flush every stream, then replace the last stream by a lone
    sub-patch one; returns the scores of all nine streams."""
    sids = [srv.open() for _ in streams]
    for step, (i, lo, hi) in enumerate(schedule):
        srv.feed(sids[i], streams[i][lo:hi])
        if step % 5 == 4:
            srv.tick()
    srv.drain()
    for sid in sids:
        srv.flush(sid)
    scores = [srv.scores(sid) for sid in sids]
    srv.close(sids[-1])
    lone = srv.open()
    srv.feed(lone, streams[0][:8000])
    srv.flush(lone)
    scores.append(srv.scores(lone))
    for sid in sids[:-1] + [lone]:
        srv.close(sid)
    return np.stack(scores)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs the port on "
              "an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from mla_tpu_torch.config import FrontendConfig, get_config
    from mla_tpu_torch.models.convert import flat_to_state_dict, state_dict_to_flat
    from mla_tpu_torch.models.zoo import build_model
    from mla_tpu_torch.ops import _build
    from mla_tpu_torch.ops import fused_frontend as ff
    from mla_tpu_torch.ops.frontend import trimmed_spectral_bases
    from mla_tpu_torch.serve.server import BatchedStreamingServer

    record = {}

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    name, cap = torch.cuda.get_device_name(0), torch.cuda.get_device_capability(0)
    print(f"device: {name}, capability {cap}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {card}")
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card is sm_{cap[0]}{cap[1]}")
    record["card"] = card

    # 2. build
    t0 = time.perf_counter()
    _build.load("fused_frontend", ff._SIGNATURES)
    build_s = time.perf_counter() - t0
    print(f"build: csrc/fused_frontend.cu {build_s:.2f} s")
    ptxas_log = _build.library_path("fused_frontend").with_suffix(".log")
    if ptxas_log.exists():
        print(ptxas_log.read_text().strip())
    record["build_s"] = build_s

    # 3. kernel vs plain version on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    cfg = FrontendConfig()
    geo = dataclasses.replace(cfg, example_window_seconds=0.5, example_hop_seconds=0.5)
    # 22.05 kHz: window 551 (not a multiple of 4), 349 mel-active bins (more
    # than one per thread), > 48 KB of shared memory per block
    sr22 = dataclasses.replace(cfg, sample_rate=22050)
    cases = [("serve [8, 77120]", (8, 77120), cfg), ("10 s batch [4, 160000]", (4, 160000), cfg),
             ("1-D [160000]", (160000,), cfg), ("0.5 s patches [2, 64000]", (2, 64000), geo),
             ("22.05 kHz [2, 88200]", (2, 88200), sr22)]
    errs = {}
    for label, shape, c in cases:
        wav = (torch.randn(shape, generator=gen) * 0.1).cuda()
        for prec, tol in TOL.items():
            out = ff.fused_log_mel_patches(wav, c, prec)
            torch.cuda.synchronize()
            ref = ff.fused_log_mel_patches_reference(wav, c, prec)
            if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
                raise RuntimeError(f"kernel {label} {prec}: shape {tuple(out.shape)} or non-finite")
            err = float((out - ref).abs().max())
            errs[f"{label} {prec}"] = err
            print(f"kernel vs plain, {label}, {prec}: max |diff| {err:.3e} (tol {tol:g})")
            if err > tol:
                raise RuntimeError(f"kernel disagrees with its plain version: {label} {prec} {err}")
    golden = np.load(os.path.join(ROOT, "tests", "golden", "frontend_golden.npz"))
    out = ff.fused_log_mel_patches(torch.from_numpy(golden["wav"]).cuda(), cfg, "highest")
    torch.cuda.synchronize()
    err = float(np.abs(out.cpu().numpy() - golden["patches"]).max())
    errs["golden highest"] = err
    print(f"kernel vs tests/golden/frontend_golden.npz, highest: max |diff| {err:.3e} (tol 2e-4)")
    if err > 2e-4:
        raise RuntimeError(f"kernel disagrees with the front-end golden: {err}")

    # 4. the main path at full width
    scfg = get_config("streaming_inference", {"frontend.impl": "pallas"})
    model = build_model(scfg.model, device="cpu", seed=SEED)
    flat = state_dict_to_flat(model.state_dict())
    state_dict = flat_to_state_dict(flat, model)
    for k, v in model.state_dict().items():
        if not torch.equal(state_dict[k], v):
            raise RuntimeError(f"flat-format round trip changed {k}")
    rng = np.random.default_rng(SEED)
    sr = scfg.frontend.sample_rate
    streams = []
    for i in range(8):
        n = 20 * sr + i * 23456
        t = np.arange(n) / sr
        tone = 0.3 * np.sin(2 * np.pi * (220 + 110 * i) * t)
        streams.append((tone + 0.05 * rng.standard_normal(n)).astype(np.float32))
    schedule, pos = [], [0] * 8
    while any(p < len(s) for p, s in zip(pos, streams)):
        for i, s in enumerate(streams):
            if pos[i] < len(s):
                hi = min(len(s), pos[i] + int(rng.integers(3000, 40000)))
                schedule.append((i, pos[i], hi))
                pos[i] = hi
    srv = BatchedStreamingServer(scfg, state_dict, max_streams=8, chunk_patches=5,
                                 transfer_dtype="int16")
    srv.warmup()
    ff.LAUNCHES = 0
    d0 = srv.dispatches
    scores = _drive(srv, streams, schedule)
    torch.cuda.synchronize()
    launches, dispatches = ff.LAUNCHES, srv.dispatches - d0
    print(f"main path: {dispatches} device steps, fused_log_mel_patches launches {launches}")
    if launches != dispatches or launches < 1:
        raise RuntimeError(f"kernel launches {launches} != device steps {dispatches}")
    n_classes = scfg.model.n_classes
    if scores.shape != (9, n_classes) or not np.isfinite(scores).all() \
            or scores.min() < 0 or scores.max() > 1:
        raise RuntimeError(f"bad scores: shape {scores.shape}, range "
                           f"[{np.nanmin(scores)}, {np.nanmax(scores)}]")
    xcfg = dataclasses.replace(scfg, frontend=dataclasses.replace(scfg.frontend, impl="xla"))
    xsrv = BatchedStreamingServer(xcfg, state_dict, max_streams=8, chunk_patches=5,
                                  transfer_dtype="int16")
    xscores = _drive(xsrv, streams, schedule)
    score_err = float(np.abs(scores - xscores).max())
    print(f"main path scores, pallas vs xla front-end: max |diff| {score_err:.3e} "
          f"(bf16 budget {BF16_SCORE_BUDGET:g})")
    if score_err > BF16_SCORE_BUDGET:
        raise RuntimeError(f"pallas and xla servers disagree: {score_err}")
    record.update(main_path_dispatches=dispatches, main_path_launches=launches,
                  score_err_vs_xla=score_err)

    # 5. times
    tag = f"({card})"
    wav = (torch.randn((8, srv.chunk_samples), generator=gen) * 0.1).cuda()
    kernel_ms = {p: _median_ms(lambda p=p: ff.fused_log_mel_patches(wav, scfg.frontend, p))
                 for p in TOL}
    for p, ms in kernel_ms.items():
        print(f"time: fused_log_mel_patches {p} [8, {srv.chunk_samples}]: {ms:.4f} ms {tag}")
    plain_ms = _median_ms(
        lambda: ff.fused_log_mel_patches_reference(wav, scfg.frontend, MAIN_PRECISION))
    print(f"time: plain version {MAIN_PRECISION} [8, {srv.chunk_samples}]: {plain_ms:.4f} ms {tag}")
    n_prof = 10
    tick_audio = (0.1 * rng.standard_normal(
        srv.chunk_samples + (REPS + 3 + n_prof) * srv.hop_samples)).astype(np.float32)
    for _ in range(8):
        srv.feed(srv.open(), tick_audio)
    tick_ms = []
    for _ in range(REPS + 3):
        t0 = time.perf_counter()
        srv.tick()
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    tick_med = statistics.median(tick_ms[3:])
    print(f"time: server tick, 8 int16 streams x 5 patches, host clock: {tick_med:.4f} ms {tag}")
    prof_host, prof_busy, prof_top = _profile_ticks(srv, n_prof)
    if prof_busy is None:
        print(f"tick profile: device time not measured (the profiler saw no device activity) {tag}")
    else:
        # the profiler slows the host, not the device: the idle share is the
        # profiled device busy against the unprofiled tick
        idle_share = 1 - prof_busy / tick_med
        print(f"tick profile ({n_prof} ticks): device busy {prof_busy:.4f} ms per tick; idle "
              f"share against the unprofiled tick {idle_share:.4f}; host with the profiler "
              f"on {prof_host:.4f} ms per tick {tag}")
        for k, v in prof_top:
            print(f"tick profile: {v:.4f} ms device per tick under {k}")
    record.update(tick_profile={"host_ms_profiler_on": prof_host, "device_busy_ms": prof_busy,
                                "idle_share": None if prof_busy is None else idle_share,
                                "top_kernels_ms": prof_top})

    b, n = wav.shape
    _, _, frames, _, _, _ = ff._framing_plan(scfg.frontend, n)
    cos_b, _, mel_t, n_bins = trimmed_spectral_bases(scfg.frontend)
    k, m = cos_b.shape[0], scfg.frontend.num_mel_bins
    dft_flops = 2 * 2 * b * frames * k * n_bins
    mel_flops = 2 * b * frames * n_bins * m
    nbytes = ff.frontend_bytes_moved(b, n, scfg.frontend) + 4 * (2 * cos_b.size + mel_t.size)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    # operations over the card's peak for their operand type: the DFT's
    # products are f32 in "highest", one bf16 pass in "default" and three in
    # "bf16x3"; the mel product is f32 in every mode
    dft_peak_passes = {"highest": (PEAK_F32_FLOPS, 1), "default": (PEAK_BF16_TC_FLOPS, 1),
                       "bf16x3": (PEAK_BF16_TC_FLOPS, 3)}
    ops_ms = {p: (passes * dft_flops / peak + mel_flops / PEAK_F32_FLOPS) * 1e3
              for p, (peak, passes) in dft_peak_passes.items()}
    bound = {p: max(ops_ms[p], bytes_ms) for p in TOL}
    f32_cores_ms = max((dft_flops + mel_flops) / PEAK_F32_FLOPS * 1e3, bytes_ms)
    print(f"bound: {dft_flops / 1e9:.4f} GFLOP DFT + {mel_flops / 1e9:.4f} GFLOP mel; "
          f"{nbytes / 1e6:.3f} MB at {PEAK_BYTES / 1e12:g} TB/s = {bytes_ms:.4f} ms; "
          f"highest (f32 {PEAK_F32_FLOPS / 1e12:g} TFLOP/s) {bound['highest']:.4f} ms, "
          f"default (DFT bf16 {PEAK_BF16_TC_FLOPS / 1e12:g} TFLOP/s, mel f32) "
          f"{bound['default']:.4f} ms, bf16x3 (three bf16 passes, mel f32) "
          f"{bound['bf16x3']:.4f} ms; side number, all on f32 CUDA cores as this kernel "
          f"computes {f32_cores_ms:.4f} ms {tag}")
    for p in TOL:
        print(f"roofline share: fused_log_mel_patches {p}: "
              f"{bound[p] / kernel_ms[p]:.4f} of bound {tag}")
    record.update(kernel_ms=kernel_ms, plain_ms=plain_ms, tick_ms=tick_med, bound_ms=bound,
                  bound_ms_f32_cores=f32_cores_ms, bytes=nbytes, dft_flops=dft_flops,
                  mel_flops=mel_flops, max_abs_err=errs)

    kernels = [{
        "name": "fused_log_mel_patches",
        "route": "cuda",
        "source": "mla_tpu_torch/csrc/fused_frontend.cu",
        "replaces": "mla_tpu/ops/pallas_frontend.py:154",
        "launches": launches,
        "max_abs_err": errs[f"serve [8, 77120] {MAIN_PRECISION}"],
        "max_abs_err_by_case": errs,
        "ms": kernel_ms[MAIN_PRECISION],
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound[MAIN_PRECISION],
        "bound_ms_by_precision": bound,
        "bound_ms_f32_cores": f32_cores_ms,
        "bound_by": "operations" if ops_ms[MAIN_PRECISION] >= bytes_ms else "bytes",
        "library_ms": None,
        "library_note": "no single PyTorch call computes framing, DFT magnitude, mel "
                        "product and log together",
        "precision": MAIN_PRECISION,
        "shape": [b, n],
        "tick_ms": tick_med,
    }]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as fh:
        json.dump({**record, "kernels": kernels}, fh, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
