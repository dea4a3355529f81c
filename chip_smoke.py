#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mla_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing its last line:
  1. device: the card's name, power limit and compute capability (9, 0);
  2. build: every kernel source in mla_tpu_torch/csrc (fused_frontend.cu,
     row_merge.cu, adpcm.cu), one nvcc each, all started together, timed,
     with nvcc's ptxas report;
  3. each kernel against its plain torch version on the card: the fused
     front-end, both variants (mma, the tensor-core kernel the main path
     takes, and simt, the first design), at the serving, training and
     flagship ([128, 160000]) shapes and a few others, per precision mode,
     and against the front-end golden file (TF32 off); the
     row-merge probe's kernels bit-exact at five cases (three aligned shapes
     up to [16384, 4096], an odd [33, 7], and a view that starts one float
     into its buffer), each case launching the row-merge variant
     (row_merge_bulk or row_merge_generic) that row_merge_variant names;
     the ADPCM decode kernel, both variants (scan, the warp-parallel scan
     the wrapper picks for 4-bit codes in blocks of 256, and serial, one
     lane per block, which it picks for the rest), bit-exact against
     its plain version, the golden wires (tests/golden/adpcm_wire.npz,
     adpcm2_wire.npz), the host decoder and a random-bytes wire, both bit
     widths, at the serving and training shapes;
  4. the probe entry point (python -m mla_tpu_torch.probe_row_merge): its
     verdict must be "supported", through scale2 and row_merge_bulk;
  5. the serving path at full width: BatchedStreamingServer on the
     streaming_inference preset with frontend.impl="pallas", random weights
     from a seeded torch.Generator through the flat weight format, 8 int16
     streams of ~20-30 s fed in uneven blocks, ticks, flushes and scores;
     the front-end kernel must run once per device step, every launch on
     the mma variant, and the scores must agree with the same server on the
     torch-ops front-end; then the same on the adpcm4 wire (and, shorter,
     adpcm2): one decode launch per device step, every one on the variant
     decode_variant picks for the wire (serial at block 64), and the scores held against the float32-wire server fed the
     codec's round trip;
  5b. the server's ring, packed tick and reload at full width, on the same
     preset and schedule: the ring (timeline_cap=64) on int16 and adpcm4,
     whose states must equal the ring-less server's bit for bit, whose
     per-level sum of weight x probability must equal the pooled state, whose
     window must match the one-shot AudioTagger.timeline, and which must keep
     the last 64 of a 70-patch stream; the packed one-upload tick
     (tick_packed) on int16 and adpcm4, states equal to the three-upload
     tick's bit for bit, its staging pinned and a buffer of other memory
     refused; a reload mid-stream to a second seeded set of
     weights (accumulators and ring kept, a stream opened afterwards equal to
     a fresh server on the new weights, prepare and commit timed); front-end
     and decode launches equal to device steps on each of these paths; then
     one f32 forward each of a VGGish-trunk model and of CompactCNN with
     norm="group" and norm="none", on the card and on the CPU (TF32 off);
  6. the training path at full width: fit() on the us8k_fused_frontend
     preset as shipped (front-end kernel at "highest", batch 64 of 4 s
     clips), cut only in num_steps / eval_every / checkpoint_every; finite
     losses, one front-end launch per train step and per eval batch, every
     launch on the mma variant, resume() restoring exactly the trained weights, and the first step's
     loss on the kernel against the torch-ops front-end; then a short fit()
     with data.staging_dtype=adpcm4 (one decode launch per train step, on
     the scan variant that block 256 picks) and its first step against float32 staging of the
     decoded clips;
  6b. the flagship program (mla_tpu_torch/entry.py, audioset_full_dp as
     shipped): entry()'s 4 x 10 s forward, finite [4, 527] probs, the
     fidelity record max |probs("default") - probs("highest")| with TF32
     off, and pallas against xla; then full-width train steps at batch
     128 x 10 s on each front-end impl: finite losses, the first step's
     loss pallas against xla, every front-end launch on mma, step times
     on the host clock and with CUDA events, peak memory, one profile;
  7. times (median of 30 after warm-up): each kernel, its plain version and
     the library call where one exists, with CUDA events (the front-end's
     two variants per mode at the serving and training shapes, and the mma
     variant at each frame tile; the probe
     kernels on inputs that are not in the L2 cache, at every case but
     [33, 7], with row_merge_generic also timed at the aligned shapes,
     where the wrapper takes row_merge_bulk; the ADPCM decode per width at
     the serving and training shapes on L2-cold wires and on a wire in the
     L2 cache, both variants, and each variant on one 64-sample unit, its
     launch floor; the mma front-end at the flagship's
     [128, 160000]); server ticks on the host clock, tick() and the packed
     tick in turns (int16 with the ring off and on, adpcm4), and one train
     step; each kernel's bound; and torch.profiler breakdowns (device busy,
     idle share, host-to-device copies per tick) of ten ticks of each kind
     and five train steps.
Launch counts are set to 0 just before each path (probe, serving on each
wire, the ring, packed and reload serving paths, training, adpcm4-staged training, the flagship forward and train
steps) is driven and read just after. The script prints the card's line
from nvidia-smi, one JSON line of per-kernel numbers, and last
{"ok": true, "device": {...}}. The full record also goes to
build/chip_smoke.json.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import shutil
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
# bf16 and TF32 on the tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_TF32_TC_FLOPS = 495e12
PEAK_BYTES = 3.35e12
TOL = {"highest": 2e-4, "bf16x3": 5e-4, "default": 1e-3}  # kernel vs plain version
BF16_SCORE_BUDGET = 2e-2  # scores, pallas vs torch-ops front-end under bf16 compute
# first-step BCE loss, pallas vs torch-ops front-end, bf16 trunk: the two
# front-ends differ by ~1e-6 in log-mel at "highest", so the losses differ
# only where that flips a bf16 rounding (3.4e-5 measured on an H100)
BF16_LOSS_BUDGET = 1e-3
MAIN_PRECISION = "default"  # the streaming_inference preset's front-end precision
VARIANTS = ("mma", "simt")  # the front-end kernel's; the main path takes mma
DECODE_VARIANTS = ("scan", "serial")  # the ADPCM decode's; decode_variant picks per wire
# (shape, rows, offset in floats of x into its buffer, the row-merge variant
# it must take); the first is the probe's own
PROBE_CASES = (((960, 160), 3, 0, "bulk"), ((4096, 1024), 4, 0, "bulk"),
               ((16384, 4096), 4, 0, "bulk"), ((33, 7), 3, 0, "generic"),
               ((960, 160), 3, 1, "generic"))
PROBE_TIMED = tuple(c for c in PROBE_CASES if c[0] != (33, 7))
TRAIN_CUT = {"train.num_steps": 30, "train.eval_every": 15,
             "train.checkpoint_every": 15, "train.log_every": 5}
ADPCM_TRAIN_CUT = {"train.num_steps": 5, "train.eval_every": 5, "train.checkpoint_every": 0,
                   "train.log_every": 1, "data.staging_dtype": "adpcm4"}
# scores, adpcm server vs float32 server fed the codec's round trip: the
# active rows' decoded samples are identical (the decode is bit-exact), so
# the two differ only where other rows' masked inputs differ (adpcm2's
# silence decodes to +-3 LSB) and a bf16 rounding flips
ADPCM_SCORE_BUDGET = 1e-3
# first-step loss, adpcm4 staging vs float32 staging of the decoded clips:
# identical inputs after the bit-exact decode
ADPCM_LOSS_BUDGET = 1e-4
# (label, shape, block): the decode kernel at the serving and training sites
ADPCM_SITES = (("serve [8, 77120]", (8, 77120), 64), ("train [64, 64000]", (64, 64000), 256))
TIMELINE_CAP = 64  # the ring's patches per stream (8 streams: ~6.5 MB)
SUM_TOL = 1e-5  # sum_t w * f of a window that covers the stream against the pooled state
LEFTOVER_TOL = 1e-4  # f32 forward on the card against the CPU, TF32 off
FLAGSHIP_BATCH = 128  # bench.py's batch of 10 s clips
FLAGSHIP_STEPS = 3  # train steps per front-end impl before the timed ones
# (substring of the CUDA symbol, kernel), the first match counting: the
# port's own kernels are launched through ctypes, outside any operator, so
# the profiler is read by name
PORT_KERNELS = (("fused_log_mel", "fused_log_mel_patches"), ("scale2_kernel", "scale2"),
                ("row_merge_bulk", "row_merge"), ("row_merge_generic", "row_merge"),
                ("adpcm_decode_scan", "adpcm_decode scan"), ("adpcm_decode", "adpcm_decode serial"))


def _probe_key(shape, rows, offset) -> str:
    return f"{list(shape)} rows {rows}" + (f" view +{offset} float" if offset else "")


def _host_median_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median host-clock time of fn() followed by torch.cuda.synchronize()."""
    times = []
    for i in range(warmup + reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _profile(fn, n: int):
    """torch.profiler over n calls of fn, after one call in the profiler's
    warm-up step, whose trace is dropped, and a pause: device records stamped
    before the window opens are dropped, and without the pause the first
    call's copies can land there. Returns (host ms per call, device-busy ms per call,
    [(operator or kernel, device ms per call)] for the top twenty and every
    kernel of the port, host-to-device copies per call, {copy name: count}),
    or busy None if the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.005)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / n
    # device activity, without the profiler's own step annotation, which
    # spans the whole window on the device timeline
    device = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
              and not ev.name.startswith("ProfilerStep")]
    copies = {}
    for ev in device:
        if "memcpy" in ev.name.lower():
            copies[ev.name] = copies.get(ev.name, 0) + 1
    htod = sum(c for k, c in copies.items() if "HtoD" in k) / n
    spans = [(ev.time_range.start, ev.time_range.end) for ev in device]
    if not spans:
        return host_ms, None, [], htod, copies
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
    for ev in device:
        for symbol, kernel in PORT_KERNELS:
            if symbol in ev.name:
                ops.append((f"kernel {kernel}", ev.time_range.elapsed_us()))
                break
    totals = {}
    for k, v in ops:
        totals[k] = totals.get(k, 0.0) + v
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])
    top = ranked[:20] + [kv for kv in ranked[20:] if kv[0].startswith("kernel ")]
    return host_ms, busy_us / 1e3 / n, [(k, v / 1e3 / n) for k, v in top], htod, copies


def _report_profile(what: str, n: int, unprofiled_ms: float, prof, tag: str) -> dict:
    host, busy, top, htod, copies = prof
    if busy is None:
        print(f"{what} profile: device time not measured (the profiler saw no device "
              f"activity) {tag}")
        return {"host_ms_profiler_on": host, "device_busy_ms": None, "idle_share": None,
                "top_ms": top, "htod_copies_per_run": htod, "copies": copies}
    # the profiler slows the host, not the device: the idle share is the
    # profiled device busy against the unprofiled time of the same work
    idle = 1 - busy / unprofiled_ms
    print(f"{what} profile ({n} runs): device busy {busy:.4f} ms per run; idle share "
          f"against the unprofiled run {idle:.4f}; host with the profiler on {host:.4f} ms "
          f"per run; host-to-device copies per run {htod:g} (copies seen: {copies}) {tag}")
    for k, v in top:
        print(f"{what} profile: {v:.4f} ms device per run under {k}")
    return {"host_ms_profiler_on": host, "device_busy_ms": busy, "idle_share": idle,
            "top_ms": top, "htod_copies_per_run": htod, "copies": copies}


def _frontend_bound(ff, trimmed_spectral_bases, fcfg, b: int, n: int) -> dict:
    """The fused front-end's least time on this card for a [b, n] batch, per
    precision mode: the larger of its bytes (waveform span once, log-mel
    once, bases once) over the memory rate and its operations over the peak
    of their route. "highest" is f32-accurate by 3xTF32 (three TF32 passes)
    on the tensor cores, the cheapest route to its accuracy, so its bound
    takes that route; the all-f32-CUDA-core bound is kept beside it."""
    _, _, frames, _, _, _ = ff._framing_plan(fcfg, n)
    cos_b, _, mel_t, n_bins = trimmed_spectral_bases(fcfg)
    k, m = cos_b.shape[0], fcfg.num_mel_bins
    dft_flops = 2 * 2 * b * frames * k * n_bins
    mel_flops = 2 * b * frames * n_bins * m
    nbytes = ff.frontend_bytes_moved(b, n, fcfg) + 4 * (2 * cos_b.size + mel_t.size)
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    # the DFT's products are three TF32 passes in "highest", one bf16 pass
    # in "default" and three in "bf16x3"; the mel product is f32 in every mode
    dft_peak_passes = {"highest": (PEAK_TF32_TC_FLOPS, 3), "default": (PEAK_BF16_TC_FLOPS, 1),
                       "bf16x3": (PEAK_BF16_TC_FLOPS, 3)}
    ops_ms = {p: (passes * dft_flops / peak + mel_flops / PEAK_F32_FLOPS) * 1e3
              for p, (peak, passes) in dft_peak_passes.items()}
    return {"bound_ms": {p: max(ops_ms[p], bytes_ms) for p in TOL},
            "bound_by": {p: "operations" if ops_ms[p] >= bytes_ms else "bytes" for p in TOL},
            "f32_cores_ms": max((dft_flops + mel_flops) / PEAK_F32_FLOPS * 1e3, bytes_ms),
            "bytes": nbytes, "bytes_ms": bytes_ms, "dft_flops": dft_flops,
            "mel_flops": mel_flops}


def _schedule(streams, rng):
    """Uneven feed blocks of 3000-40000 samples, the streams interleaved:
    [(stream, lo, hi)]."""
    schedule, pos = [], [0] * len(streams)
    while any(p < len(s) for p, s in zip(pos, streams)):
        for i, s in enumerate(streams):
            if pos[i] < len(s):
                hi = min(len(s), pos[i] + int(rng.integers(3000, 40000)))
                schedule.append((i, pos[i], hi))
                pos[i] = hi
    return schedule


def _in_turns(fns: dict, reps: int = REPS, warmup: int = 3) -> dict:
    """Host-clock times (ms, each call followed by torch.cuda.synchronize())
    of the named calls run in turns, the order reversed every round (A B,
    B A, ...): {name: median} and {name: [times]}."""
    names, times = list(fns), {k: [] for k in fns}
    for i in range(warmup + reps):
        for k in (names if i % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            if i >= warmup:
                times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}, times


def _states_equal(a, b) -> bool:
    return all(torch.equal(x, y) for sa, sb in zip(a, b) for x, y in zip(sa, sb))


def _states_max_diff(a, b) -> float:
    return max(float((x - y).abs().nan_to_num().max()) for sa, sb in zip(a, b)
               for x, y in zip(sa, sb))


def _drive(srv, streams, schedule, packed: bool = False):
    """Feed the streams in the schedule's uneven blocks with ticks between
    (the packed tick if ``packed``), drain, flush every stream, then replace
    the last stream by a lone sub-patch one; returns the scores of all nine
    streams."""
    tick = srv.tick_packed if packed else srv.tick
    sids = [srv.open() for _ in streams]
    for step, (i, lo, hi) in enumerate(schedule):
        srv.feed(sids[i], streams[i][lo:hi])
        if step % 5 == 4:
            tick()
    while tick():
        pass
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
    from mla_tpu_torch import probe_row_merge
    from mla_tpu_torch.config import FrontendConfig, get_config
    from mla_tpu_torch.data import adpcm
    from mla_tpu_torch.data.audio_io import pcm16_quantize
    from mla_tpu_torch.data.sampler import BalancedSampler
    from mla_tpu_torch.data.synthetic import make_dataset
    from mla_tpu_torch.models.convert import flat_to_state_dict, state_dict_to_flat
    from mla_tpu_torch.models.trunk import CompactCNN
    from mla_tpu_torch.models.zoo import build_model, init_weights
    from mla_tpu_torch.entry import entry, flagship_config, flagship_forward
    from mla_tpu_torch.ops import _build
    from mla_tpu_torch.ops import adpcm as ad
    from mla_tpu_torch.ops import attention_pool as ap
    from mla_tpu_torch.ops import frontend as fe
    from mla_tpu_torch.ops import fused_frontend as ff
    from mla_tpu_torch.ops import row_merge as rm
    from mla_tpu_torch.ops.frontend import trimmed_spectral_bases
    from mla_tpu_torch.serve.server import BatchedStreamingServer
    from mla_tpu_torch.serve.streaming import _samples_per_patches
    from mla_tpu_torch.train import loop
    from mla_tpu_torch.train.state import create_train_state, make_train_step
    from mla_tpu_torch.utils.cuda_timing import device_median_ms, l2_cold

    record = {}
    t_start = time.perf_counter()

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
    tag = f"({card})"

    # 2. build: one nvcc per source, all started together
    sources = {"fused_frontend": ff._SIGNATURES, "row_merge": rm._SIGNATURES,
               "adpcm": ad._SIGNATURES}

    def build(src):
        t0 = time.perf_counter()
        _build.load(src, sources[src])
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        futures = {src: pool.submit(build, src) for src in sources}
        build_s = {src: f.result() for src, f in futures.items()}
    print(f"build: {len(sources)} sources in parallel, {time.perf_counter() - t0:.2f} s")
    for src, s in build_s.items():
        print(f"build: csrc/{src}.cu {s:.2f} s")
        ptxas_log = _build.library_path(src).with_suffix(".log")
        if ptxas_log.exists():
            print(ptxas_log.read_text().strip())
    record["build_s"] = build_s

    # 3. kernels vs their plain versions on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    cfg = FrontendConfig()
    geo = dataclasses.replace(cfg, example_window_seconds=0.5, example_hop_seconds=0.5)
    # 22.05 kHz: window 551 (not a multiple of 4), 349 mel-active bins (more
    # than one per thread), > 48 KB of shared memory per block
    sr22 = dataclasses.replace(cfg, sample_rate=22050)
    cases = [("serve [8, 77120]", (8, 77120), cfg), ("train [64, 64000]", (64, 64000), cfg),
             ("10 s batch [4, 160000]", (4, 160000), cfg), ("1-D [160000]", (160000,), cfg),
             ("0.5 s patches [2, 64000]", (2, 64000), geo),
             ("22.05 kHz [2, 88200]", (2, 88200), sr22),
             # the flagship's batch (bench.py's 128 x 10 s): BM 64, 16 tiles per
             # clip, a ragged last tile
             ("flagship [128, 160000]", (FLAGSHIP_BATCH, 160000), flagship_config().frontend)]
    # errs[variant]["<case> <precision>"]: max |kernel - plain version|
    errs = {v: {} for v in VARIANTS}
    for label, shape, c in cases:
        wav = (torch.randn(shape, generator=gen) * 0.1).cuda()
        for prec, tol in TOL.items():
            ref = ff.fused_log_mel_patches_reference(wav, c, prec)
            for variant in VARIANTS:
                before = dict(ff.LAUNCHES_BY_VARIANT)
                out = ff.fused_log_mel_patches(wav, c, prec, _variant=variant)
                torch.cuda.synchronize()
                if ff.LAUNCHES_BY_VARIANT[variant] != before[variant] + 1:
                    raise RuntimeError(f"{label} {prec}: the {variant} variant did not launch")
                if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
                    raise RuntimeError(f"kernel {variant} {label} {prec}: shape "
                                       f"{tuple(out.shape)} or non-finite")
                err = float((out - ref).abs().max())
                errs[variant][f"{label} {prec}"] = err
                print(f"kernel vs plain, {variant}, {label}, {prec}: max |diff| {err:.3e} "
                      f"(tol {tol:g})")
                if err > tol:
                    raise RuntimeError(f"kernel {variant} disagrees with its plain version: "
                                       f"{label} {prec} {err}")
    golden = np.load(os.path.join(ROOT, "tests", "golden", "frontend_golden.npz"))
    for variant in VARIANTS:
        out = ff.fused_log_mel_patches(torch.from_numpy(golden["wav"]).cuda(), cfg, "highest",
                                       _variant=variant)
        torch.cuda.synchronize()
        err = float(np.abs(out.cpu().numpy() - golden["patches"]).max())
        errs[variant]["golden highest"] = err
        print(f"kernel vs tests/golden/frontend_golden.npz, {variant}, highest: max |diff| "
              f"{err:.3e} (tol 2e-4)")
        if err > 2e-4:
            raise RuntimeError(f"kernel {variant} disagrees with the front-end golden: {err}")

    probe_errs = {"scale2": {}, "row_merge": {}}
    for shape, rows, offset, variant in PROBE_CASES:
        key = _probe_key(shape, rows, offset)
        # a contiguous view `offset` floats into its buffer
        x = torch.randn(shape[0] * shape[1] + offset, generator=gen).cuda()[offset:].view(shape)
        before = dict(rm.LAUNCHES)
        got = {"scale2": rm.scale2(x), "row_merge": rm.row_merge(x, rows)}
        torch.cuda.synchronize()
        launched = [k for k, v in rm.LAUNCHES.items() if v != before[k]]
        named = rm.row_merge_variant(shape, rows, x.data_ptr(), got["row_merge"].data_ptr())
        if named != variant or launched != ["scale2", f"row_merge_{named}"]:
            raise RuntimeError(f"{key}: launched {launched}; row_merge_variant names {named}, "
                               f"the case expects {variant}")
        want = {"scale2": rm.scale2_reference(x), "row_merge": rm.row_merge_reference(x, rows)}
        for k in got:
            if got[k].shape != want[k].shape:
                raise RuntimeError(f"{k} {key}: shape {tuple(got[k].shape)}")
            probe_errs[k][key] = float((got[k] - want[k]).abs().max())
            if not torch.equal(got[k], want[k]):
                raise RuntimeError(f"{k} {key} is not bit-exact")
            kernel = "scale2" if k == "scale2" else f"row_merge_{named}"
            print(f"kernel vs plain, {k} {key}: {kernel}, bit-exact")
        del x, got, want
    record["probe_max_abs_err"] = probe_errs

    # the ADPCM decode, both variants: bit-exact against the golden wires,
    # its plain version on the card and the host decoder, per width at both
    # sites, and on a wire of random bytes
    codecs = {4: (adpcm.adpcm4_encode, adpcm.adpcm4_decode, "adpcm_wire.npz"),
              2: (adpcm.adpcm2_encode, adpcm.adpcm2_decode, "adpcm2_wire.npz")}
    prng = np.random.default_rng(SEED)
    adpcm_wires = {}  # (bits, site label) -> the wire on the card, for the timing
    # adpcm_errs[variant][case]: max |kernel - plain version| (0.0: bit-exact)
    adpcm_errs = {v: {} for v in DECODE_VARIANTS}

    def check_decode(what, wire, n, block, bits, want):
        plain = ad.adpcm_decode_reference(wire, n, block, bits)
        for variant in DECODE_VARIANTS:
            before = dict(ad.LAUNCHES_BY_VARIANT)
            got = ad.adpcm_decode(wire, n, block, bits, _variant=variant)
            torch.cuda.synchronize()
            if ad.LAUNCHES_BY_VARIANT != {**before, variant: before[variant] + 1}:
                raise RuntimeError(f"adpcm_decode {what}: the {variant} variant did not launch")
            if got.shape == plain.shape:
                adpcm_errs[variant][what] = float((got - plain).abs().max())
            for against, w in (("its plain version", plain), ("the reference", want)):
                if got.shape != w.shape or not torch.equal(got, w):
                    err = float((got - w).abs().max()) if got.shape == w.shape else None
                    raise RuntimeError(f"adpcm_decode {variant} {what} is not bit-exact against "
                                       f"{against} (shape {tuple(got.shape)}, max |diff| {err})")
            print(f"kernel vs plain, adpcm_decode {variant} {what}: bit-exact (and against the "
                  f"reference)")

    for bits, (enc, dec, golden_file) in codecs.items():
        g = np.load(os.path.join(ROOT, "tests", "golden", golden_file))
        for blk in (64, 256):
            check_decode(f"{bits}-bit golden block {blk}", torch.from_numpy(g[f"wire{blk}"]).cuda(),
                         g["x"].size, blk, bits, torch.from_numpy(g[f"dec{blk}"]).cuda())
        for label, shape, blk in ADPCM_SITES:
            pcm = pcm16_quantize(0.3 * prng.standard_normal(shape))
            wire_h = enc(pcm, block=blk)
            wire = torch.from_numpy(wire_h).cuda()
            check_decode(f"{bits}-bit {label} block {blk}", wire, shape[1], blk, bits,
                         torch.from_numpy(dec(wire_h, n=shape[1], block=blk)).cuda())
            adpcm_wires[bits, label] = wire
        # random bytes: header indices past 88 (which the host decoder does
        # not take) and predictors at the int16 edges, which encoded audio
        # never carries; the reference is the plain version on the CPU, which
        # the CPU tests hold against the JAX decoders on such wires
        junk = torch.from_numpy(
            prng.integers(0, 256, (8, adpcm.wire_length(77120, 64, bits))).astype(np.uint8))
        check_decode(f"{bits}-bit random bytes [8, 77120] block 64", junk.cuda(), 77120, 64, bits,
                     ad.adpcm_decode_reference(junk, 77120, 64, bits).cuda())
    record["adpcm_max_abs_err"] = adpcm_errs

    # 4. the probe entry point
    for k in rm.LAUNCHES:
        rm.LAUNCHES[k] = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        probe_row_merge.main()
    torch.cuda.synchronize()
    probe_launches = dict(rm.LAUNCHES)
    probe_line = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"probe: {json.dumps(probe_line)}; launches {probe_launches}")
    if probe_line["verdict"] != "supported" or probe_line["platform"] != "cuda":
        raise RuntimeError(f"row-merge probe on the card: {probe_line}")
    if probe_launches["scale2"] < 1 or probe_launches["row_merge_bulk"] < 1:
        raise RuntimeError(f"the probe did not go through scale2 and row_merge_bulk: "
                           f"{probe_launches}")
    record.update(probe=probe_line, probe_launches=probe_launches)

    # 5. the serving path at full width
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
    schedule = _schedule(streams, rng)
    srv = BatchedStreamingServer(scfg, state_dict, max_streams=8, chunk_patches=5,
                                 transfer_dtype="int16")
    srv.warmup()
    ff.LAUNCHES = 0
    ff.LAUNCHES_BY_VARIANT.update(mma=0, simt=0)
    d0 = srv.dispatches
    scores = _drive(srv, streams, schedule)
    torch.cuda.synchronize()
    serve_launches, dispatches = ff.LAUNCHES, srv.dispatches - d0
    serve_by_variant = dict(ff.LAUNCHES_BY_VARIANT)
    print(f"serving path: {dispatches} device steps, fused_log_mel_patches launches "
          f"{serve_launches} {serve_by_variant}")
    if serve_launches != dispatches or serve_launches < 1:
        raise RuntimeError(f"kernel launches {serve_launches} != device steps {dispatches}")
    if serve_by_variant != {"mma": serve_launches, "simt": 0}:
        raise RuntimeError(f"serving launches not all on the mma variant: {serve_by_variant}")
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
    print(f"serving path scores, pallas vs xla front-end: max |diff| {score_err:.3e} "
          f"(bf16 budget {BF16_SCORE_BUDGET:g})")
    if score_err > BF16_SCORE_BUDGET:
        raise RuntimeError(f"pallas and xla servers disagree: {score_err}")
    record.update(main_path_dispatches=dispatches, main_path_launches=serve_launches,
                  score_err_vs_xla=score_err)

    # the same serving path on the adpcm wires: float32 feeds encoded at feed
    # time, the wire decoded on the card once per device step; held against
    # the float32-wire server fed the codec's round trip of the same audio.
    # adpcm2 runs shorter: four streams of 12 s.
    adpcm_serve = {}
    asrv = None
    for wire_name, wstreams in (("adpcm4", streams),
                                ("adpcm2", [s[:12 * sr] for s in streams[:4]])):
        bits = int(wire_name[-1])
        enc, dec, _ = codecs[bits]
        wschedule = schedule if wire_name == "adpcm4" else _schedule(wstreams, rng)
        wsrv = BatchedStreamingServer(scfg, state_dict, max_streams=8, chunk_patches=5,
                                      transfer_dtype=wire_name)
        wsrv.warmup()
        ad.LAUNCHES = ff.LAUNCHES = 0
        ad.LAUNCHES_BY_VARIANT.update(scan=0, serial=0)
        ff.LAUNCHES_BY_VARIANT.update(mma=0, simt=0)
        d0 = wsrv.dispatches
        wscores = _drive(wsrv, wstreams, wschedule)
        torch.cuda.synchronize()
        steps, dec_launches = wsrv.dispatches - d0, ad.LAUNCHES
        dec_by_variant = dict(ad.LAUNCHES_BY_VARIANT)
        fe_by_variant = dict(ff.LAUNCHES_BY_VARIANT)
        print(f"serving path, {wire_name} wire: {steps} device steps, adpcm_decode launches "
              f"{dec_launches} {dec_by_variant}, fused_log_mel_patches launches {ff.LAUNCHES} "
              f"{fe_by_variant}")
        if dec_launches != steps or steps < 1:
            raise RuntimeError(f"{wire_name}: decode launches {dec_launches} != device steps {steps}")
        picked = ad.decode_variant(bits, adpcm.SERVE_BLOCK)
        if dec_by_variant != {**dict.fromkeys(DECODE_VARIANTS, 0), picked: steps}:
            raise RuntimeError(f"{wire_name}: decode launches {dec_by_variant} != {steps} on "
                               f"{picked}")
        if fe_by_variant != {"mma": steps, "simt": 0}:
            raise RuntimeError(f"{wire_name}: front-end launches {fe_by_variant} != {steps} on mma")
        if not np.isfinite(wscores).all() or wscores.min() < 0 or wscores.max() > 1:
            raise RuntimeError(f"{wire_name}: bad scores")
        round_trip = [dec(enc(s, block=adpcm.SERVE_BLOCK), n=len(s), block=adpcm.SERVE_BLOCK)
                      for s in wstreams]
        fsrv = BatchedStreamingServer(scfg, state_dict, max_streams=8, chunk_patches=5,
                                      transfer_dtype="float32")
        fscores = _drive(fsrv, round_trip, wschedule)
        werr = float(np.abs(wscores - fscores).max())
        print(f"serving path, {wire_name} wire: scores vs the float32 server on the round-tripped "
              f"audio, max |diff| {werr:.3e} (budget {ADPCM_SCORE_BUDGET:g})")
        if wire_name == "adpcm4":  # the codec's own effect, not a check
            print(f"serving path, adpcm4 wire: scores vs the int16 server on the original "
                  f"audio, max |diff| {float(np.abs(wscores - scores).max()):.3e}")
        if werr > ADPCM_SCORE_BUDGET:
            raise RuntimeError(f"{wire_name} server disagrees with the float32 server: {werr}")
        adpcm_serve[wire_name] = {"device_steps": steps, "decode_launches": dec_launches,
                                  "decode_launches_by_variant": dec_by_variant,
                                  "frontend_launches": fe_by_variant["mma"],
                                  "score_err_vs_round_trip": werr, "streams": len(wstreams)}
        if wire_name == "adpcm4":
            asrv, adpcm4_scores = wsrv, wscores  # held against below, and timed
        del fsrv
    record["adpcm_serving"] = adpcm_serve

    # 5b. the ring, the packed tick and reload on the same serving path.
    # Launch counts are set to 0 before each path and read after it.
    def zero_counts():
        ad.LAUNCHES = ff.LAUNCHES = 0
        ad.LAUNCHES_BY_VARIANT.update(scan=0, serial=0)
        ff.LAUNCHES_BY_VARIANT.update(mma=0, simt=0)

    def check_launches(path, steps, adpcm_wire):
        """Front-end launches on mma = device steps; decode launches on the
        serving wire's variant = device steps on an adpcm wire, else 0."""
        fe_l, dec_l = dict(ff.LAUNCHES_BY_VARIANT), dict(ad.LAUNCHES_BY_VARIANT)
        want_dec = dict.fromkeys(DECODE_VARIANTS, 0)
        if adpcm_wire:
            want_dec[ad.decode_variant(4, adpcm.SERVE_BLOCK)] = steps
        print(f"{path}: {steps} device steps, fused_log_mel_patches launches {fe_l}, "
              f"adpcm_decode launches {dec_l}")
        if steps < 1 or fe_l != {"mma": steps, "simt": 0} or dec_l != want_dec:
            raise RuntimeError(f"{path}: launches {fe_l} / {dec_l} for {steps} device steps")
        return {"device_steps": steps, "frontend_launches": fe_l, "decode_launches": dec_l}

    new_paths = {}  # path -> its launch record
    ring, ring_srv = {}, {}
    for wire_name, base, base_scores in (("int16", srv, scores), ("adpcm4", asrv, adpcm4_scores)):
        rsrv = BatchedStreamingServer(scfg, state_dict, max_streams=8, chunk_patches=5,
                                      transfer_dtype=wire_name, timeline_cap=TIMELINE_CAP)
        rsrv.warmup(packed=True)
        zero_counts()
        d0 = rsrv.dispatches
        rscores = _drive(rsrv, streams, schedule)
        torch.cuda.synchronize()
        new_paths[f"serve_ring_{wire_name}"] = check_launches(
            f"ring, {wire_name} wire", rsrv.dispatches - d0, wire_name == "adpcm4")
        # a side output: every state bit as without the ring
        if not _states_equal(rsrv.states, base.states) or not np.array_equal(rscores, base_scores):
            raise RuntimeError(f"ring, {wire_name}: states differ from the server without the "
                               f"ring by {_states_max_diff(rsrv.states, base.states)}")
        # stream 0 (20 patches, slot 0): the window covers it, so per level
        # sum_t w * f is the pooled state
        start, levels = rsrv.timeline_from(rsrv.states, rsrv.tl, 0)
        pooled = [ap.stream_finalize(st)[0].cpu().numpy() for st in rsrv.states]
        sum_err = max(float(np.abs((w * f).sum(axis=0) - p).max())
                      for (w, f), p in zip(levels, pooled))
        n0 = levels[0][0].shape[0]
        # the one-shot readout of the same audio (as the wire decodes it) on the card
        if wire_name == "int16":
            audio0 = pcm16_quantize(streams[0]).astype(np.float32) / 32768.0
        else:
            enc4, dec4, _ = codecs[4]
            audio0 = dec4(enc4(streams[0], block=adpcm.SERVE_BLOCK), n=len(streams[0]),
                          block=adpcm.SERVE_BLOCK)
        with torch.inference_mode():
            one = rsrv.model.timeline(fe.apply_frontend(torch.from_numpy(audio0).cuda()[None],
                                                        scfg.frontend))
        one_err = {k: max(float(np.abs(lv[i] - o[i][0].float().cpu().numpy()).max())
                          for lv, o in zip(levels, one)) for i, k in enumerate(("w", "f"))}
        print(f"ring, {wire_name} wire: states and scores bit-equal to the server without the "
              f"ring; stream 0 window start {start}, {n0} patches, {len(levels)} levels; max "
              f"|sum_t w*f - pooled| {sum_err:.3e} (tol {SUM_TOL:g}); against the one-shot "
              f"AudioTagger.timeline on the card: weights {one_err['w']:.3e}, probs "
              f"{one_err['f']:.3e} (bf16 budget {BF16_SCORE_BUDGET:g})")
        if start != 0 or n0 != one[0][0].shape[1] or sum_err > SUM_TOL \
                or max(one_err.values()) > BF16_SCORE_BUDGET:
            raise RuntimeError(f"ring, {wire_name}: start {start}, {n0} patches, sum {sum_err}, "
                               f"one-shot {one_err}")
        ring[wire_name] = {"sum_err": sum_err, "oneshot_err": one_err, "patches": n0,
                           **new_paths[f"serve_ring_{wire_name}"]}
        ring_srv[wire_name] = rsrv

    # a 70-patch stream: the ring keeps its last 64
    rsrv = ring_srv["int16"]
    zero_counts()
    d0 = rsrv.dispatches
    long_sid = rsrv.open()
    n_long = 70
    rsrv.feed(long_sid, np.tile(streams[3], 4)[:_samples_per_patches(scfg.frontend, n_long)])
    rsrv.drain()
    rsrv.flush(long_sid)
    start, levels = rsrv.timeline(long_sid)
    torch.cuda.synchronize()
    new_paths["serve_ring_wrap"] = check_launches("ring wrap", rsrv.dispatches - d0, False)
    count = int(rsrv.tl.count[long_sid])
    print(f"ring wrap: a {n_long}-patch stream, count {count}, window start {start}, "
          f"{levels[0][0].shape[0]} patches kept (cap {TIMELINE_CAP})")
    if count != n_long or start != count - TIMELINE_CAP or levels[0][0].shape[0] != TIMELINE_CAP:
        raise RuntimeError(f"ring wrap: count {count}, start {start}")
    rsrv.close(long_sid)
    ring["wrap"] = {"count": count, "start": start}

    # the packed one-upload tick through the same schedule, against the
    # three-upload tick's states
    packed_rec = {}
    for wire_name, base, base_scores in (("int16", srv, scores), ("adpcm4", asrv, adpcm4_scores)):
        psrv = BatchedStreamingServer(scfg, state_dict, max_streams=8, chunk_patches=5,
                                      transfer_dtype=wire_name)
        psrv.warmup(packed=True)
        zero_counts()
        d0 = psrv.dispatches
        pscores = _drive(psrv, streams, schedule, packed=True)
        torch.cuda.synchronize()
        rec = check_launches(f"packed tick, {wire_name} wire", psrv.dispatches - d0,
                             wire_name == "adpcm4")
        diff = _states_max_diff(psrv.states, base.states)
        same = _states_equal(psrv.states, base.states) and np.array_equal(pscores, base_scores)
        print(f"packed tick, {wire_name} wire: states against the three-upload tick's: "
              f"{'bit-equal' if same else 'NOT bit-equal'}, max |diff| {diff:.3e}; packed "
              f"buffer {psrv.packed_nbytes} bytes per tick")
        if not same:
            raise RuntimeError(f"packed tick, {wire_name}: states differ by {diff}")
        # staging is pinned memory, and a buffer of other memory is refused
        # rather than copied from pageable memory
        if not psrv.packed_buffer().base.is_pinned():
            raise RuntimeError("packed_buffer() did not hand out pinned memory")
        try:
            psrv.put_packed(np.zeros(psrv.packed_nbytes, np.uint8))
            raise RuntimeError("put_packed took a buffer that packed_buffer() did not make")
        except ValueError:
            pass
        new_paths[f"serve_packed_{wire_name}"] = rec
        packed_rec[wire_name] = {"bit_equal": same, "packed_nbytes": psrv.packed_nbytes, **rec}
        del psrv

    # reload mid-stream to a second seeded set of weights, on the int16 ring server
    model2 = build_model(scfg.model, device="cpu", seed=SEED + 1)
    state_dict2 = flat_to_state_dict(state_dict_to_flat(model2.state_dict()), model2)
    zero_counts()
    d0 = rsrv.dispatches
    a = rsrv.open()
    half = len(streams[1]) // 2
    rsrv.feed(a, streams[1][:half])
    rsrv.drain()
    torch.cuda.synchronize()

    def rows(r):
        return [t[a].clone() for st in r.states for t in st] + [t[a].clone() for t in r.tl]

    kept = rows(rsrv)
    t0 = time.perf_counter()
    build_model(scfg.model, device="cpu")  # the part of prepare_reload that builds a module
    build_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    staged = rsrv.prepare_reload(state_dict2)
    torch.cuda.synchronize()
    prepare_ms = (time.perf_counter() - t0) * 1e3
    old_model = rsrv.model  # held, so the commit is timed apart from the old model's release
    t0 = time.perf_counter()
    rsrv.commit_reload(staged)
    commit_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    del old_model
    release_ms = (time.perf_counter() - t0) * 1e3
    if not all(torch.equal(x, y) for x, y in zip(kept, rows(rsrv))):
        raise RuntimeError("reload changed the open stream's accumulators or ring")
    rsrv.feed(a, streams[1][half:])
    rsrv.drain()
    rsrv.flush(a)
    a_scores = rsrv.scores(a)
    a_start, a_levels = rsrv.timeline(a)
    rsrv.close(a)
    b = rsrv.open()
    rsrv.feed(b, streams[2])
    rsrv.drain()
    rsrv.flush(b)
    b_scores = rsrv.scores(b)
    rsrv.close(b)
    torch.cuda.synchronize()
    new_paths["serve_reload"] = check_launches("reload", rsrv.dispatches - d0, False)
    fresh = BatchedStreamingServer(scfg, state_dict2, max_streams=8, chunk_patches=5,
                                   transfer_dtype="int16", timeline_cap=TIMELINE_CAP)
    r = fresh.open()
    fresh.feed(r, streams[2])
    fresh.drain()
    fresh.flush(r)
    fresh_scores = fresh.scores(r)
    reload_err = float(np.abs(b_scores - fresh_scores).max())
    print(f"reload: prepare_reload {prepare_ms:.4f} ms (a model build on the CPU alone, PyTorch's "
          f"default init: {build_ms:.4f} ms), commit_reload {commit_ms:.6f} ms, then the old "
          f"model's release {release_ms:.6f} ms, host clock; the open stream's accumulators "
          f"and ring kept bit for bit; its scores after the "
          f"swap in [{a_scores.min():.4f}, {a_scores.max():.4f}], window {a_levels[0][0].shape[0]} "
          f"patches; a stream opened after it (slot {b}) against a fresh server on the new "
          f"weights (slot {r}): max |diff| {reload_err:.3e}; against the old weights' scores "
          f"max |diff| {float(np.abs(b_scores - scores[2]).max()):.3e} {tag}")
    if b != r or not np.array_equal(b_scores, fresh_scores) or np.allclose(b_scores, scores[2]) \
            or not np.isfinite(a_scores).all():
        raise RuntimeError(f"reload: slot {b} / {r}, against the fresh server {reload_err}")
    reload_rec = {"prepare_ms": prepare_ms, "build_ms": build_ms, "commit_ms": commit_ms,
                  "release_ms": release_ms,
                  "fresh_err": reload_err,
                  **new_paths["serve_reload"]}
    del fresh, staged, model2
    record.update(ring=ring, packed=packed_rec, reload=reload_rec)

    # the model's leftovers: one f32 forward each on the card and on the CPU
    xl = torch.randn((2, 4, 96, 64), generator=gen)
    leftovers = {}
    vcfg = get_config("streaming_inference", {"model.trunk": "vggish",
                                              "model.compute_dtype": "float32"}).model
    nets = {"vggish AudioTagger": lambda: build_model(vcfg, device="cpu", seed=SEED)}
    for norm in ("group", "none"):
        nets[f"CompactCNN norm={norm}"] = lambda norm=norm: init_weights(
            CompactCNN(norm=norm, dtype=torch.float32),
            torch.Generator().manual_seed(SEED)).eval()
    for what, make in nets.items():
        net = make()
        x = xl if what.startswith("vggish") else xl[0]
        with torch.inference_mode():
            on_cpu = net(x)
            on_card = net.cuda()(x.cuda()).cpu()
        err = float((on_card - on_cpu).abs().max())
        leftovers[what] = {"max_abs_err": err, "shape": list(on_cpu.shape),
                           "max_abs": float(on_cpu.abs().max())}
        print(f"leftover {what}: f32 forward {list(x.shape)} -> {list(on_cpu.shape)}, card "
              f"against the CPU max |diff| {err:.3e} (tol {LEFTOVER_TOL:g}; outputs up to "
              f"{leftovers[what]['max_abs']:.4f})")
        if not torch.isfinite(on_card).all() or err > LEFTOVER_TOL:
            raise RuntimeError(f"{what}: card against CPU {err}")
        del net
    record["leftovers"] = leftovers

    # 6. the training path at full width
    tcfg = get_config("us8k_fused_frontend", TRAIN_CUT)
    ws = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(ws, ignore_errors=True)
    ff.LAUNCHES = 0
    ff.LAUNCHES_BY_VARIANT.update(mma=0, simt=0)
    t0 = time.perf_counter()
    result = loop.fit(tcfg, workspace=ws)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_launches, counts = ff.LAUNCHES, dict(result.counts)
    train_by_variant = dict(ff.LAUNCHES_BY_VARIANT)
    losses = [h["loss"] for h in result.history]
    print(f"training path: {counts['train_steps']} train steps + {counts['eval_batches']} eval "
          f"batches in {fit_s:.2f} s, fused_log_mel_patches launches {train_launches} "
          f"{train_by_variant}")
    if train_by_variant != {"mma": train_launches, "simt": 0}:
        raise RuntimeError(f"training launches not all on the mma variant: {train_by_variant}")
    print(f"training path: losses {losses}; eval {result.eval_stats}")
    if counts["train_steps"] != tcfg.train.num_steps or result.interrupted:
        raise RuntimeError(f"fit ran {counts} of {tcfg.train.num_steps} steps")
    if train_launches != counts["train_steps"] + counts["eval_batches"]:
        raise RuntimeError(f"kernel launches {train_launches} != train steps + eval batches "
                           f"{counts}")
    if not losses or not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite training loss: {losses}")
    if not result.eval_stats or not np.isfinite(result.eval_stats[-1]["mAP"]):
        raise RuntimeError(f"bad eval stats: {result.eval_stats}")
    restored, sampler_state = loop.resume(tcfg, workspace=ws)
    trained = result.state.model.state_dict()
    for k, v in restored.model.state_dict().items():
        if not torch.equal(v, trained[k]):
            raise RuntimeError(f"resume() did not restore {k} exactly")
    if restored.step != tcfg.train.num_steps or not sampler_state:
        raise RuntimeError(f"resume() restored step {restored.step}, sampler {sampler_state}")
    print(f"training path: resume() restored step {restored.step} and all "
          f"{len(trained)} tensors exactly")

    bs = tcfg.train.batch_size
    ds = make_dataset(tcfg.data, tcfg.model.n_classes, "train", "waveform")
    idx = BalancedSampler(ds.y, bs, tcfg.train.seed).next_batch()  # fit's first batch
    x1 = torch.from_numpy(np.ascontiguousarray(ds.x[idx])).cuda()
    y1 = torch.from_numpy(np.asarray(ds.y[idx], np.float32)).cuda()
    first_loss = {}
    for impl in ("pallas", "xla"):
        c = dataclasses.replace(tcfg, frontend=dataclasses.replace(tcfg.frontend, impl=impl))
        m = build_model(c.model, seed=c.train.seed)
        _, loss = make_train_step(c, m, "waveform", clip_samples=x1.shape[1])(
            create_train_state(c, m), x1, y1)
        first_loss[impl] = float(loss)
    loss_err = abs(first_loss["pallas"] - first_loss["xla"])
    print(f"training path: first-step loss pallas {first_loss['pallas']:.6f}, xla "
          f"{first_loss['xla']:.6f}, |diff| {loss_err:.3e} (bf16 budget {BF16_LOSS_BUDGET:g}); "
          f"fit's logged step-1 loss {losses[0]:.6f}")
    if loss_err > BF16_LOSS_BUDGET:
        raise RuntimeError(f"first-step loss, pallas vs xla front-end: {loss_err}")
    record.update(train_counts=counts, train_launches=train_launches, train_losses=losses,
                  train_eval=result.eval_stats, fit_s=fit_s, first_step_loss=first_loss,
                  first_step_loss_err=loss_err)

    # training on adpcm4 staging: the set staged once on the card in the wire
    # (256-sample blocks), each batch decoded inside the train step; the eval
    # set stays float32, as in the reference, so eval batches decode nothing
    acfg = get_config("us8k_fused_frontend", ADPCM_TRAIN_CUT)
    ws_a = os.path.join(ROOT, "build", "chip_smoke_train_adpcm4")
    shutil.rmtree(ws_a, ignore_errors=True)
    ad.LAUNCHES = ff.LAUNCHES = 0
    ad.LAUNCHES_BY_VARIANT.update(scan=0, serial=0)
    ff.LAUNCHES_BY_VARIANT.update(mma=0, simt=0)
    ares = loop.fit(acfg, workspace=ws_a)
    torch.cuda.synchronize()
    acounts, a_decode, a_fe = dict(ares.counts), ad.LAUNCHES, dict(ff.LAUNCHES_BY_VARIANT)
    a_dec_by_variant = dict(ad.LAUNCHES_BY_VARIANT)
    alosses = [h["loss"] for h in ares.history]
    print(f"adpcm4-staged training: {acounts['train_steps']} train steps + "
          f"{acounts['eval_batches']} eval batches, adpcm_decode launches {a_decode} "
          f"{a_dec_by_variant}, fused_log_mel_patches launches {a_fe}; losses {alosses}")
    if a_decode != acounts["train_steps"] or acounts["train_steps"] != acfg.train.num_steps:
        raise RuntimeError(f"adpcm4 staging: decode launches {a_decode} != train steps {acounts}")
    picked = ad.decode_variant(4, adpcm.DEFAULT_BLOCK)
    if a_dec_by_variant != {**dict.fromkeys(DECODE_VARIANTS, 0), picked: a_decode}:
        raise RuntimeError(f"adpcm4 staging: decode launches {a_dec_by_variant} not all on "
                           f"{picked}")
    # each decode variant is some main-path site's pick
    dec_by_path = {"serve_adpcm4": adpcm_serve["adpcm4"]["decode_launches_by_variant"],
                   "serve_adpcm2": adpcm_serve["adpcm2"]["decode_launches_by_variant"],
                   **{p: r["decode_launches"] for p, r in new_paths.items() if "adpcm4" in p},
                   "train_adpcm4": a_dec_by_variant}
    dec_launches_by_variant = {v: sum(p[v] for p in dec_by_path.values())
                               for v in DECODE_VARIANTS}
    print(f"adpcm_decode launches on the main path by variant: {dec_launches_by_variant}")
    if min(dec_launches_by_variant.values()) < 1:
        raise RuntimeError(f"a decode variant never ran on the main path: {dec_by_path}")
    if a_fe != {"mma": acounts["train_steps"] + acounts["eval_batches"], "simt": 0}:
        raise RuntimeError(f"adpcm4 staging: front-end launches {a_fe} for {acounts}")
    if not alosses or not np.isfinite(alosses).all():
        raise RuntimeError(f"adpcm4 staging: non-finite loss {alosses}")
    # its first batch, staged in the wire and as float32 of the decoded clips
    n_clip = ds.x.shape[1]
    wire1 = adpcm.adpcm4_encode(pcm16_quantize(ds.x[idx]))
    x_wire = torch.from_numpy(wire1).cuda()
    x_dec = torch.from_numpy(adpcm.adpcm4_decode(wire1, n=n_clip)).cuda()
    stage_loss = {}
    for stage, xb in (("adpcm4", x_wire), ("float32", x_dec)):
        c = get_config("us8k_fused_frontend", {**ADPCM_TRAIN_CUT, "data.staging_dtype": stage})
        m = build_model(c.model, seed=c.train.seed)
        _, loss = make_train_step(c, m, "waveform", clip_samples=n_clip)(
            create_train_state(c, m), xb, y1)
        stage_loss[stage] = float(loss)
    stage_err = abs(stage_loss["adpcm4"] - stage_loss["float32"])
    print(f"adpcm4-staged training: first-step loss {stage_loss['adpcm4']:.6f}, float32 staging "
          f"of the decoded clips {stage_loss['float32']:.6f}, |diff| {stage_err:.3e} (budget "
          f"{ADPCM_LOSS_BUDGET:g}); fit's logged step-1 loss {alosses[0]:.6f}")
    if stage_err > ADPCM_LOSS_BUDGET:
        raise RuntimeError(f"adpcm4 vs float32 staging, first-step loss: {stage_err}")
    record["adpcm4_training"] = {"counts": acounts, "decode_launches": a_decode,
                                 "decode_launches_by_variant": a_dec_by_variant,
                                 "frontend_launches": a_fe, "losses": alosses,
                                 "first_step_loss": stage_loss, "first_step_loss_err": stage_err}

    # 6b. the flagship program: entry()'s forward, its fidelity record, and
    # full-width train steps at bench.py's batch on each front-end impl
    fcfg = flagship_config()
    fn, (fmodel, fwav) = entry(seed=SEED)
    probs = fn(fmodel, fwav)
    torch.cuda.synchronize()
    if tuple(probs.shape) != (4, fcfg.model.n_classes) or not bool(torch.isfinite(probs).all()):
        raise RuntimeError(f"flagship forward: shape {tuple(probs.shape)} or non-finite")

    ff.LAUNCHES = 0
    ff.LAUNCHES_BY_VARIANT.update(mma=0, simt=0)
    probs_p = flagship_forward(flagship_config(overrides={"frontend.impl": "pallas"}))(fmodel, fwav)
    torch.cuda.synchronize()
    fwd_launches = dict(ff.LAUNCHES_BY_VARIANT)
    probs_h = flagship_forward(flagship_config(overrides={"frontend.precision": "highest"}))(fmodel, fwav)
    fidelity = float((probs - probs_h).abs().max())
    with torch.inference_mode():
        lm = {p: fe.apply_frontend(fwav, flagship_config(overrides={"frontend.precision": p}).frontend)
              for p in ("default", "highest")}
    logmel_err = float((lm["default"] - lm["highest"]).abs().max())
    pallas_err = float((probs_p - probs).abs().max())
    print(f"flagship forward (entry(), 4 x 10 s): probs {tuple(probs.shape)} in "
          f"[{float(probs.min()):.4f}, {float(probs.max()):.4f}]; fidelity, TF32 off: max "
          f"|probs(default) - probs(highest)| {fidelity:.3e} (log-mel {logmel_err:.3e}); max "
          f"|probs(pallas) - probs(xla)| {pallas_err:.3e} (bf16 budget {BF16_SCORE_BUDGET:g}); "
          f"front-end launches {fwd_launches}")
    if pallas_err > BF16_SCORE_BUDGET or fwd_launches != {"mma": 1, "simt": 0}:
        raise RuntimeError(f"flagship forward pallas vs xla: {pallas_err}, launches {fwd_launches}")
    del fmodel, lm

    frng = np.random.default_rng(SEED)
    fwav = torch.from_numpy((frng.standard_normal((FLAGSHIP_BATCH, fwav.shape[1])) * 0.1)
                            .astype(np.float32)).cuda()
    fy = torch.from_numpy((frng.random((FLAGSHIP_BATCH, fcfg.model.n_classes)) < 0.05)
                          .astype(np.float32)).cuda()
    flagship = {}
    for impl in ("xla", "pallas"):
        c = flagship_config(overrides={"frontend.impl": impl})
        m = build_model(c.model, seed=SEED)
        st = create_train_state(c, m)
        fstep = make_train_step(c, m, "waveform")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ff.LAUNCHES = 0
        ff.LAUNCHES_BY_VARIANT.update(mma=0, simt=0)
        flosses = [float(fstep(st, fwav, fy)[1]) for _ in range(FLAGSHIP_STEPS)]
        torch.cuda.synchronize()
        f_launches = dict(ff.LAUNCHES_BY_VARIANT)
        want = {"mma": FLAGSHIP_STEPS if impl == "pallas" else 0, "simt": 0}
        if f_launches != want or not np.isfinite(flosses).all():
            raise RuntimeError(f"flagship train steps, {impl}: losses {flosses}, front-end "
                               f"launches {f_launches} (want {want})")
        host_ms = _host_median_ms(lambda: fstep(st, fwav, fy), reps=5, warmup=1)
        event_ms = device_median_ms(lambda: fstep(st, fwav, fy), reps=5, inner=1, warmup=0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        flagship[impl] = {"losses": flosses, "frontend_launches": f_launches,
                          "step_ms_host": host_ms, "step_ms_events": event_ms,
                          "clips_per_s_host": FLAGSHIP_BATCH / (host_ms / 1e3),
                          "peak_memory_gb": peak}
        print(f"flagship train step, {impl} front-end, batch {FLAGSHIP_BATCH} x 10 s: losses "
              f"{flosses}; host clock {host_ms:.4f} ms, CUDA events {event_ms:.4f} ms, "
              f"{FLAGSHIP_BATCH / (host_ms / 1e3):.1f} clips/s; peak memory {peak:.2f} GB; "
              f"front-end launches {f_launches} {tag}")
        if impl == "xla":  # the preset's own front-end: the profile
            flagship["profile"] = _report_profile(
                "flagship train step", 2, host_ms, _profile(lambda: fstep(st, fwav, fy), 2), tag)
        del m, st, fstep
        torch.cuda.empty_cache()
    f_loss_err = abs(flagship["pallas"]["losses"][0] - flagship["xla"]["losses"][0])
    print(f"flagship train step: first-step loss pallas {flagship['pallas']['losses'][0]:.6f}, xla "
          f"{flagship['xla']['losses'][0]:.6f}, |diff| {f_loss_err:.3e} (bf16 budget "
          f"{BF16_LOSS_BUDGET:g})")
    if f_loss_err > BF16_LOSS_BUDGET:
        raise RuntimeError(f"flagship first-step loss, pallas vs xla: {f_loss_err}")
    record["flagship"] = {"probs_range": [float(probs.min()), float(probs.max())],
                          "fidelity_default_vs_highest": fidelity, "logmel_default_vs_highest":
                          logmel_err, "pallas_vs_xla": pallas_err, "forward_launches": fwd_launches,
                          "first_step_loss_err": f_loss_err, **flagship}

    # 7. times
    # the fused front-end at the serving and the training shape: both
    # variants per mode, the mma variant at each frame tile that fits, and
    # the plain version
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count

    def time_frontend(w, fcfg):
        kp, np_ = ff.padded_sizes(fcfg)
        _, _, used, _, _, _ = ff._framing_plan(fcfg, w.shape[1])
        t = {"ms": {v: {} for v in VARIANTS}, "plain_ms": {}, "tile": {}, "tile_ms": {}}
        for p in TOL:
            for v in VARIANTS:
                t["ms"][v][p] = device_median_ms(
                    lambda p=p, v=v: ff.fused_log_mel_patches(w, fcfg, p, _variant=v))
            t["plain_ms"][p] = device_median_ms(
                lambda p=p: ff.fused_log_mel_patches_reference(w, fcfg, p))
            t["tile"][p] = ff.tile_frames(w.shape[0], used, kp, np_, p, sm_count)
            t["tile_ms"][p] = {
                bm: device_median_ms(lambda p=p, bm=bm: ff.fused_log_mel_patches(w, fcfg, p, _bm=bm))
                for bm in ff.TILE_FRAMES if ff.mma_smem_bytes(bm, kp, np_, p) <= ff.SMEM_BYTES}
        return t

    def report_frontend(site, w, t, fb):
        shape = list(w.shape)
        print(f"bound, {site} {shape}: {fb['dft_flops'] / 1e9:.4f} GFLOP DFT + "
              f"{fb['mel_flops'] / 1e9:.4f} GFLOP mel; {fb['bytes'] / 1e6:.3f} MB at "
              f"{PEAK_BYTES / 1e12:g} TB/s = {fb['bytes_ms']:.4f} ms; highest (3xTF32 on "
              f"the tensor cores, three passes at {PEAK_TF32_TC_FLOPS / 1e12:g} TFLOP/s, mel "
              f"f32) {fb['bound_ms']['highest']:.4f} ms, default (DFT bf16 "
              f"{PEAK_BF16_TC_FLOPS / 1e12:g} TFLOP/s, mel f32) {fb['bound_ms']['default']:.4f} "
              f"ms, bf16x3 (three bf16 passes, mel f32) {fb['bound_ms']['bf16x3']:.4f} ms; "
              f"all on the f32 CUDA cores at {PEAK_F32_FLOPS / 1e12:g} TFLOP/s "
              f"{fb['f32_cores_ms']:.4f} ms (the shares below use the per-mode bounds) {tag}")
        for p in TOL:
            mma, simt, bnd = t["ms"]["mma"][p], t["ms"]["simt"][p], fb["bound_ms"][p]
            tiles = ", ".join(f"BM {bm} {ms:.4f}" for bm, ms in t["tile_ms"][p].items())
            print(f"time: fused_log_mel_patches {p} {site} {shape}: mma {mma:.4f} ms (BM "
                  f"{t['tile'][p]}), simt {simt:.4f} ms, plain version {t['plain_ms'][p]:.4f} "
                  f"ms, bound {bnd:.4f} ms ({fb['bound_by'][p]}); share of bound mma "
                  f"{bnd / mma:.4f}, simt {bnd / simt:.4f}; mma per tile: {tiles} {tag}")
            if mma >= simt:
                print(f"time: NOTE mma is not faster than simt: {p} {site} {shape}")

    wav = (torch.randn((8, srv.chunk_samples), generator=gen) * 0.1).cuda()
    b, n = wav.shape
    st = time_frontend(wav, scfg.frontend)
    sbound = _frontend_bound(ff, trimmed_spectral_bases, scfg.frontend, b, n)
    report_frontend("serving", wav, st, sbound)
    bound = sbound["bound_ms"]
    kernel_ms, plain_ms = st["ms"]["mma"], st["plain_ms"][MAIN_PRECISION]

    tprec = tcfg.frontend.precision
    w64 = (torch.randn((bs, x1.shape[1]), generator=gen) * 0.1).cuda()
    tt = time_frontend(w64, tcfg.frontend)
    tbound = _frontend_bound(ff, trimmed_spectral_bases, tcfg.frontend, *w64.shape)
    report_frontend("training", w64, tt, tbound)
    train_kernel_ms, train_plain_ms = tt["ms"]["mma"][tprec], tt["plain_ms"][tprec]

    # the probe kernels, at each timed case, beside the library call; each
    # call reads the next of enough copies of its input to fill the L2 twice,
    # so it finds its input in device memory, as the probe's one call does.
    # Where the wrapper takes row_merge_bulk, row_merge_generic (the earlier
    # design) is timed too, launched directly so that it counts no launch.
    probe_ms = {"scale2": {}, "row_merge": {}}
    for shape, rows, offset, variant in PROBE_TIMED:
        x = torch.randn(shape, generator=gen).cuda()
        nxt, n_copies = l2_cold(x, offset)
        nbytes = rm.bytes_moved(x)
        del x
        merged = (shape[0] // rows, rows * shape[1])
        key = _probe_key(shape, rows, offset)

        def generic():
            xi = nxt()
            out = torch.empty(merged, device=xi.device)
            rm._launch("mla_row_merge_generic", xi, out, *shape, rows)
            return out

        for k, kern, plain, lib in (
                ("scale2", lambda: rm.scale2(nxt()), lambda: rm.scale2_reference(nxt()),
                 lambda: torch.mul(nxt(), 2)),
                ("row_merge", lambda: rm.row_merge(nxt(), rows),
                 lambda: rm.row_merge_reference(nxt(), rows),
                 lambda: nxt().reshape(merged).clone())):
            t = {"ms": device_median_ms(kern, inner=20),
                 "plain_ms": device_median_ms(plain, inner=20),
                 "library_ms": device_median_ms(lib, inner=20),
                 "bound_ms": nbytes / PEAK_BYTES * 1e3, "bytes": nbytes,
                 "input_copies": n_copies,
                 "kernel": "scale2" if k == "scale2" else f"row_merge_{variant}"}
            if k == "row_merge" and variant == "bulk":
                t["generic_ms"] = device_median_ms(generic, inner=20)
            probe_ms[k][key] = t
            print(f"time: {k} {key}: {t['kernel']} {t['ms'] * 1e3:.3f} us, plain version "
                  f"{t['plain_ms'] * 1e3:.3f} us, library {t['library_ms'] * 1e3:.3f} us, "
                  f"bound {t['bound_ms'] * 1e3:.3f} us ({nbytes / 1e6:.4f} MB at "
                  f"{PEAK_BYTES / 1e12:g} TB/s); {t['bound_ms'] / t['ms']:.4f} of bound, "
                  f"kernel / library {t['ms'] / t['library_ms']:.4f} {tag}")
            if "generic_ms" in t:
                print(f"time: row_merge {key}: row_merge_generic {t['generic_ms'] * 1e3:.3f} us, "
                      f"{t['bound_ms'] / t['generic_ms']:.4f} of bound, kernel / library "
                      f"{t['generic_ms'] / t['library_ms']:.4f} {tag}")
        del nxt
    record.update(probe_ms=probe_ms)

    # the ADPCM decode per width at both sites, on wires that are not in the
    # L2 cache: both variants in turns (scan, serial, serial, scan; each
    # variant's time the mean of its two), and the plain version; its bound
    # is bytes (every wire byte read once, every f32 sample written once)
    adpcm_ms = {}
    for (bits, label), wire in adpcm_wires.items():
        _, (_, n_site), blk = next(site for site in ADPCM_SITES if site[0] == label)
        nxt, n_copies = l2_cold(wire)
        nbytes = ad.decode_bytes_moved(wire, n_site)

        def decode(variant):
            return device_median_ms(lambda: ad.adpcm_decode(nxt(), n_site, blk, bits,
                                                            _variant=variant), inner=20)

        turns = [(v, decode(v)) for v in ("scan", "serial", "serial", "scan")]
        by_variant = {v: statistics.mean(ms for w, ms in turns if w == v) for v in DECODE_VARIANTS}
        # one wire for every launch: it stays in the L2 cache, as a wire just
        # uploaded (the server's) or just gathered (training's) is
        warm = {v: device_median_ms(lambda v=v: ad.adpcm_decode(wire, n_site, blk, bits,
                                                                _variant=v), inner=20)
                for v in DECODE_VARIANTS}
        picked = ad.decode_variant(bits, blk)
        t = {"variant": picked, "ms": by_variant[picked], "scan_ms": by_variant["scan"],
             "serial_ms": by_variant["serial"], "turns_ms": turns, "warm_ms": warm,
             "plain_ms": device_median_ms(
                 lambda: ad.adpcm_decode_reference(nxt(), n_site, blk, bits),
                 reps=5, inner=2, warmup=1),
             "bound_ms": nbytes / PEAK_BYTES * 1e3, "bytes": nbytes, "input_copies": n_copies,
             "shape": list(wire.shape), "block": blk}
        adpcm_ms[f"{bits}-bit {label}"] = t
        faster = min(DECODE_VARIANTS, key=by_variant.get)
        print(f"time: adpcm_decode {bits}-bit {label} block {blk}: scan {t['scan_ms'] * 1e3:.3f} "
              f"us, serial {t['serial_ms'] * 1e3:.3f} us (turns "
              f"{', '.join(f'{v} {ms * 1e3:.3f}' for v, ms in turns)}), plain version "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms'] * 1e3:.3f} us ({nbytes / 1e6:.4f} MB "
              f"at {PEAK_BYTES / 1e12:g} TB/s, bytes); of bound: scan "
              f"{t['bound_ms'] / t['scan_ms']:.4f}, serial {t['bound_ms'] / t['serial_ms']:.4f}; "
              f"on a wire in the L2 cache: scan {warm['scan'] * 1e3:.3f} us, serial "
              f"{warm['serial'] * 1e3:.3f} us; the wrapper picks {picked}, {faster} was faster "
              f"L2-cold, {min(DECODE_VARIANTS, key=warm.get)} L2-warm {tag}")
        del nxt
    # the launch floor: each variant on one 64-sample unit, the same
    # protocol (the 35- or 19-byte wire stays in the L2 cache; rotating
    # copies of it would take millions)
    adpcm_floor_ms = {}
    for bits, (enc, _, _) in codecs.items():
        one = torch.from_numpy(enc(pcm16_quantize(0.3 * prng.standard_normal(64)), block=64)).cuda()
        serving = adpcm_ms[f"{bits}-bit {ADPCM_SITES[0][0]}"]
        for v in DECODE_VARIANTS:
            adpcm_floor_ms[f"{v} {bits}-bit"] = floor = device_median_ms(
                lambda v=v: ad.adpcm_decode(one, 64, 64, bits, _variant=v), inner=20)
            print(f"time: adpcm_decode {v}, one 64-sample unit ({one.numel()} bytes), {bits}-bit: "
                  f"{floor * 1e3:.3f} us, the launch floor; the serving site reads "
                  f"{serving[f'{v}_ms'] / floor:.4f} x it {tag}")
    record.update(adpcm_ms=adpcm_ms, adpcm_floor_ms=adpcm_floor_ms)

    # the mma front-end at the flagship's site (bench.py's batch, "default")
    fw = (torch.randn((FLAGSHIP_BATCH, 10 * sr), generator=gen) * 0.1).cuda()
    fprec = fcfg.frontend.precision
    fbound = _frontend_bound(ff, trimmed_spectral_bases, fcfg.frontend, *fw.shape)
    flagship_fe = {"ms": device_median_ms(lambda: ff.fused_log_mel_patches(fw, fcfg.frontend,
                                                                           fprec)),
                   "simt_ms": device_median_ms(lambda: ff.fused_log_mel_patches(
                       fw, fcfg.frontend, fprec, _variant="simt")),
                   "plain_ms": device_median_ms(lambda: ff.fused_log_mel_patches_reference(
                       fw, fcfg.frontend, fprec)),
                   "torch_ops_ms": device_median_ms(lambda: fe.waveform_to_patches(
                       fw, fcfg.frontend)),
                   "bound_ms": fbound["bound_ms"][fprec], "bound_by": fbound["bound_by"][fprec],
                   "precision": fprec, "shape": list(fw.shape)}
    print(f"time: fused_log_mel_patches {fprec} flagship {list(fw.shape)}: mma "
          f"{flagship_fe['ms']:.4f} ms, simt {flagship_fe['simt_ms']:.4f} ms, plain version "
          f"{flagship_fe['plain_ms']:.4f} ms, torch-ops front-end (impl xla) "
          f"{flagship_fe['torch_ops_ms']:.4f} ms, bound {flagship_fe['bound_ms']:.4f} ms "
          f"({flagship_fe['bound_by']}); {flagship_fe['bound_ms'] / flagship_fe['ms']:.4f} of "
          f"bound {tag}")
    record["flagship_frontend"] = flagship_fe
    del fw

    # server ticks on the host clock: tick() and the packed tick in turns,
    # on int16 with the ring off and on (four calls in turns) and on adpcm4,
    # then a profile of ten of each: device busy, idle share, host-to-device
    # copies per tick
    n_prof = 10
    tick_audio = (0.1 * rng.standard_normal(
        srv.chunk_samples + (2 * (REPS + 3 + n_prof + 1) + 2) * srv.hop_samples)
                  ).astype(np.float32)
    ticks = {}
    for label, servers in (("int16", {"": srv, "ring ": ring_srv["int16"]}),
                           ("adpcm4", {"": asrv})):
        fns = {}
        for prefix, tsrv in servers.items():
            for _ in range(8):
                tsrv.feed(tsrv.open(), tick_audio)
            fns.update({f"{prefix}tick": tsrv.tick, f"{prefix}packed": tsrv.tick_packed})
        med, times = _in_turns(fns)
        t = {"ms": med, "times_ms": times}
        for kind, fn in fns.items():
            t[f"{kind} profile"] = prof = _report_profile(f"{label} {kind}", n_prof, med[kind],
                                                          _profile(fn, n_prof), tag)
            want = 1 if kind.endswith("packed") else 3
            if prof["htod_copies_per_run"] != want:
                raise RuntimeError(f"{label} {kind}: {prof['htod_copies_per_run']} host-to-device "
                                   f"copies per tick, want {want}: {prof['copies']}")
        print(f"time: {label} server, 8 streams x 5 patches, host clock, in turns ({REPS} each): "
              + "; ".join(f"{k} {med[k]:.4f} ms (device busy "
                          f"{t[k + ' profile']['device_busy_ms']:.4f} ms, idle share "
                          f"{t[k + ' profile']['idle_share']:.4f}, host-to-device copies "
                          f"{t[k + ' profile']['htod_copies_per_run']:g})" for k in fns)
              + f" {tag}")
        ticks[label] = t
    record["ticks"] = ticks
    tick_med, tick_prof = ticks["int16"]["ms"]["tick"], ticks["int16"]["tick profile"]
    atick_med, atick_prof = ticks["adpcm4"]["ms"]["tick"], ticks["adpcm4"]["tick profile"]
    atick_decode_ms = dict(atick_prof["top_ms"]).get(
        f"kernel adpcm_decode {ad.decode_variant(4, adpcm.SERVE_BLOCK)}")
    print(f"adpcm4 tick against the int16 tick: device busy {atick_prof['device_busy_ms']} "
          f"against {tick_prof['device_busy_ms']} ms, idle share {atick_prof['idle_share']} "
          f"against {tick_prof['idle_share']}; the decode kernel {atick_decode_ms} device ms per "
          f"tick {tag}")

    # one train step at full width, host clock, and its profile
    state = result.state
    step = make_train_step(tcfg, state.model, "waveform", clip_samples=x1.shape[1])
    torch.cuda.reset_peak_memory_stats()
    step_med = _host_median_ms(lambda: step(state, x1, y1))
    clips_s = bs / (step_med / 1e3)
    print(f"time: train step, batch {bs} x {x1.shape[1]} samples ({bs * 4} patches), host "
          f"clock: {step_med:.4f} ms, {clips_s:.1f} clips/s {tag}")
    n_steps_prof = 5
    step_prof = _report_profile("train step", n_steps_prof, step_med,
                                _profile(lambda: step(state, x1, y1), n_steps_prof), tag)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"memory: peak allocated {peak_gb:.2f} GB over the us8k train steps {tag}")
    record.update(kernel_ms=kernel_ms, plain_ms=plain_ms, frontend_serving=st,
                  frontend_training=tt, tick_ms=tick_med, bound_ms=bound,
                  bound_ms_f32_cores=sbound["f32_cores_ms"], bytes=sbound["bytes"],
                  dft_flops=sbound["dft_flops"], mel_flops=sbound["mel_flops"],
                  max_abs_err=errs, tick_profile=tick_prof, train_step_ms=step_med,
                  train_clips_per_s=clips_s, train_step_profile=step_prof,
                  train_frontend={"ms": train_kernel_ms, "plain_ms": train_plain_ms,
                                  "precision": tprec, "shape": list(w64.shape), **tbound},
                  frontend_launches={"serve": serve_by_variant, "train": train_by_variant},
                  peak_memory_gb=peak_gb, adpcm4_tick_ms=atick_med,
                  adpcm4_tick_profile=atick_prof)

    main_probe = _probe_key(*PROBE_CASES[0][:3])
    # the front-end kernel's launches on every path that takes it
    fe_by_path = {"serve": serve_by_variant, "train": train_by_variant,
                  "serve_adpcm4": {"mma": adpcm_serve["adpcm4"]["frontend_launches"], "simt": 0},
                  "serve_adpcm2": {"mma": adpcm_serve["adpcm2"]["frontend_launches"], "simt": 0},
                  **{p: r["frontend_launches"] for p, r in new_paths.items()},
                  "train_adpcm4": a_fe, "flagship_forward": fwd_launches,
                  "flagship_train": flagship["pallas"]["frontend_launches"]}
    kernels = [{
        "name": "fused_log_mel_patches",
        "variant": "mma",
        "route": "cuda",
        "source": "mla_tpu_torch/csrc/fused_frontend.cu",
        "replaces": "mla_tpu/ops/pallas_frontend.py:154",
        "launches": sum(v["mma"] + v["simt"] for v in fe_by_path.values()),
        "launches_by_path": {k: v["mma"] + v["simt"] for k, v in fe_by_path.items()},
        "launches_by_variant": {v: sum(p[v] for p in fe_by_path.values()) for v in VARIANTS},
        "max_abs_err": errs["mma"][f"serve [8, 77120] {MAIN_PRECISION}"],
        "max_abs_err_by_case": errs["mma"],
        "simt_max_abs_err_by_case": errs["simt"],
        "ms": kernel_ms[MAIN_PRECISION],
        "kernel_ms": kernel_ms,
        "simt_ms": st["ms"]["simt"],
        "tile": st["tile"],
        "kernel_ms_by_tile": st["tile_ms"],
        "plain_ms": plain_ms,
        "plain_ms_by_precision": st["plain_ms"],
        "bound_ms": bound[MAIN_PRECISION],
        "bound_ms_by_precision": bound,
        "bound_ms_f32_cores": sbound["f32_cores_ms"],
        "bound_by": sbound["bound_by"][MAIN_PRECISION],
        "library_ms": None,
        "library_note": "no single PyTorch call computes framing, DFT magnitude, mel "
                        "product and log together",
        "precision": MAIN_PRECISION,
        "shape": [b, n],
        "train": {"shape": list(w64.shape), "precision": tprec, "ms": train_kernel_ms,
                  "plain_ms": train_plain_ms, "bound_ms": tbound["bound_ms"][tprec],
                  "bound_ms_f32_cores": tbound["f32_cores_ms"],
                  "bound_by": tbound["bound_by"][tprec],
                  "max_abs_err": errs["mma"][f"train [64, 64000] {tprec}"],
                  "kernel_ms": tt["ms"]["mma"], "simt_ms": tt["ms"]["simt"],
                  "plain_ms_by_precision": tt["plain_ms"], "tile": tt["tile"],
                  "kernel_ms_by_tile": tt["tile_ms"],
                  "bound_ms_by_precision": tbound["bound_ms"]},
        "flagship": flagship_fe,
        "tick_ms": tick_med,
        "train_step_ms": step_med,
    }]
    # the ADPCM decode's two kernels, each timed at the main-path site whose
    # wire decode_variant gives it: scan at adpcm4 training, serial at adpcm4
    # serving
    for v, symbol, site in (("scan", "adpcm_decode_scan", "4-bit train [64, 64000]"),
                            ("serial", "adpcm_decode", "4-bit serve [8, 77120]")):
        at = adpcm_ms[site]
        kernels.append({
            "name": symbol,
            "variant": v,
            "route": "cuda",
            "source": "mla_tpu_torch/csrc/adpcm.cu",
            "replaces": "mla_tpu/data/adpcm.py:435",
            "replaces_note": "_decode_jnp (4-bit) and _decode2_jnp (:379, 2-bit), a lax.scan, "
                             "not a pallas_call: a port-only kernel",
            "launches": dec_launches_by_variant[v],
            "launches_by_path": {p: c[v] for p, c in dec_by_path.items()},
            "max_abs_err": max(adpcm_errs[v].values()),
            "max_abs_err_by_case": adpcm_errs[v],
            "ms": at[f"{v}_ms"],
            "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "library_note": "no PyTorch call decodes IMA ADPCM",
            "site": site,
            "shape": at["shape"],
            "block": at["block"],
            "ms_by_case": {k: c[f"{v}_ms"] for k, c in adpcm_ms.items()},
            "l2_warm_ms_by_case": {k: c["warm_ms"][v] for k, c in adpcm_ms.items()},
            "picked_by_case": {k: c["variant"] for k, c in adpcm_ms.items()},
            "launch_floor_ms_by_bits": {b: adpcm_floor_ms[f"{v} {b}-bit"] for b in codecs},
            "plain_ms_by_case": {k: c["plain_ms"] for k, c in adpcm_ms.items()},
            "bound_ms_by_case": {k: c["bound_ms"] for k, c in adpcm_ms.items()},
        })
    for k, line in (("scale2", 33), ("row_merge", 28)):
        t = probe_ms[k][main_probe]
        by_variant = {"scale2": probe_launches["scale2"]} if k == "scale2" else {
            v: probe_launches[f"row_merge_{v}"] for v in ("bulk", "generic")}
        kernels.append({
            "name": k,
            "route": "cuda",
            "source": "mla_tpu_torch/csrc/row_merge.cu",
            "replaces": f"scripts/probe_mosaic_reshape.py:{line}",
            "launches": sum(by_variant.values()),
            "launches_by_variant": by_variant,
            "max_abs_err": max(probe_errs[k].values()),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": t["library_ms"],
            "library_call": "torch.mul(x, 2)" if k == "scale2" else "x.reshape(320, 480).clone()",
            "shape": list(PROBE_CASES[0][0]),
            "kernel_by_shape": {s: v["kernel"] for s, v in probe_ms[k].items()},
            "ms_by_shape": {s: v["ms"] for s, v in probe_ms[k].items()},
            "plain_ms_by_shape": {s: v["plain_ms"] for s, v in probe_ms[k].items()},
            "library_ms_by_shape": {s: v["library_ms"] for s, v in probe_ms[k].items()},
            "bound_ms_by_shape": {s: v["bound_ms"] for s, v in probe_ms[k].items()},
            **({"generic_ms_by_shape": {s: v["generic_ms"] for s, v in probe_ms[k].items()
                                        if "generic_ms" in v}} if k == "row_merge" else {}),
        })
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as fh:
        json.dump({**record, "kernels": kernels}, fh, indent=1)
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
