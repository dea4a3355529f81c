#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``mla_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing its last line:
  1. device: the card's name, power limit and compute capability (9, 0), and
     whether h5py, tensorboard, tensorflow, matplotlib and sklearn import on
     this machine;
  2. build: every kernel source in mla_tpu_torch/csrc (fused_frontend.cu,
     row_merge.cu, adpcm.cu, norm_act.cu), one nvcc each, and the two host libraries
     (native/serve_front.cpp, native/audio_ingest.cpp), one g++ each, all
     started together, timed, with nvcc's ptxas report; data/native.py must
     load the ingest library, which from then on carries every wav read,
     resample and ADPCM encode;
  3. each kernel against its plain torch version on the card: the fused
     front-end at the serving, training and flagship ([128, 160000]) shapes
     and a few others, per precision mode, one launch each, and against the
     front-end golden file (TF32 off); the row-merge probe's kernels
     bit-exact at five cases (three aligned shapes up to [16384, 4096], an
     odd [33, 7], and a view that starts one float into its buffer), each
     case launching the row-merge variant (row_merge_bulk or
     row_merge_generic) that row_merge_variant names;
     the ADPCM decode kernel, both variants (scan, the warp-parallel scan
     the wrapper picks for 4-bit codes in blocks of 256, and serial, one
     lane per block, which it picks for the rest), bit-exact against
     its plain version, the golden wires (tests/golden/adpcm_wire.npz,
     adpcm2_wire.npz), the host decoder and a random-bytes wire, both bit
     widths, at the serving and training shapes;
  3b. the batch-norm + ReLU kernels (csrc/norm_act.cu) at the flagship's
     eight block shapes, tag (1,280 patches, eval: apply, apply_pool) and
     train (2,560: stats, apply, backward_reduce, backward_dx and the pooled
     apply_pool, backward_reduce_pool, backward_dx_pool), channels-last bf16:
     the elementwise kernels bit-exact against their plain versions (the
     pooled ones against apply then F.max_pool2d, and dx of the pooled dy
     routed by the max pool's backward), the reductions within 1e-5 of their
     f64 sums and bit-identical run to run; each timed against its byte
     bound beside the plain version and F.batch_norm + relu (+ F.max_pool2d
     for the pooled ones: library_ms); the eight blocks as the main path
     runs them (each stage's last pooled); then the launches of a flagship
     forward (4 apply + 4 apply_pool) and train step (8 stats, 4 of each
     other kernel and 4 of its pooled version);
  4. the probe entry point (python -m mla_tpu_torch.probe_row_merge): its
     verdict must be "supported", through scale2 and row_merge_bulk;
  5. the serving path at full width: BatchedStreamingServer on the
     streaming_inference preset with frontend.impl="pallas", random weights
     from a seeded torch.Generator through the flat weight format, 8 int16
     streams of ~20-30 s fed in uneven blocks, ticks, flushes and scores;
     the front-end kernel must run once per device step, and the scores
     must agree with the same server on the torch-ops front-end; then the
     same on the adpcm4 wire (and, shorter, adpcm2): one decode launch per
     device step, every one on the variant decode_variant picks for the
     wire (serial at block 64), and the scores held against the
     float32-wire server fed the codec's round trip;
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
  5c. the serving fronts on the same preset and weights: the stdlib HTTP
     front (int16 wire, ring on) and the native C++ front (native/
     serve_front.cpp, built by g++ beside the kernels in phase 2; adpcm4
     wire), each under eight client threads posting their streams in 1 s
     sync bodies through the port's TagClient (a /v1/tag one-shot rides
     along on the stdlib front): every request 2xx, scores against a
     direct-drive server fed the same bytes (1e-3), front-end and decode
     launches equal to device steps, latency p50 / p99, audio seconds per
     wall second, ticks and streams per tick, the tick thread's host ms per
     step, and a profiled soak of ten ticks; a reload mid-soak on the native
     front (no failed request, a stream opened after it against a fresh
     server on the new weights, the longest gap between ticks); then
     `python -m mla_tpu_torch serve --native` in a subprocess, tagged by
     `python -m mla_tpu_torch tag`, against a direct server;
  6. the training path at full width: fit() on the us8k_fused_frontend
     preset as shipped (front-end kernel at "highest", batch 64 of 4 s
     clips), cut only in num_steps / eval_every / checkpoint_every; finite
     losses, one front-end launch per train step and per eval batch,
     resume() restoring exactly the trained weights, and the first step's
     loss on the kernel against the torch-ops front-end; then a short fit()
     with data.staging_dtype=adpcm4 (one decode launch per train step, on
     the scan variant that block 256 picks) and its first step against float32 staging of the
     decoded clips;
  6b. the flagship program (mla_tpu_torch/entry.py, audioset_full_dp as
     shipped): entry()'s 4 x 10 s forward, finite [4, 527] probs, the
     fidelity record max |probs("default") - probs("highest")| with TF32
     off, and pallas against xla; then full-width train steps at batch
     128 x 10 s on each front-end impl: finite losses, the first step's
     loss pallas against xla, front-end launches, peak memory (the step's
     time is the audioset-train-b256 cell's);
  5d. export on the card (mla_tpu_torch/serve/export.py), same preset and
     weights: the one-shot artifact at batch 8 x 10 s on float32 and adpcm4,
     against the eager forward of the decoded clips (1e-3), and the
     streaming pair at 8 streams x 5-patch chunks with the ring
     (timeline_cap 64) on int16 and adpcm4, scores and timelines against the
     live server on the torch-ops front-end fed the same audio (1e-3) and
     scores against the pallas servers of phase 5 (2e-2); each artifact
     written to disk and loaded fresh; the ADPCM artifacts launch the
     decode kernel once per call, on serial, and no front-end kernel (the
     exporter takes the torch-ops front-end, as the reference's does); host
     ms per chunk call; a card artifact loaded with device="cpu" runs once;
  6c. the training leftovers: fit() on us8k_fused_frontend with mixup,
     SpecAugment and data.pipeline="grain" (the DataLoader pipeline, two
     workers), finite losses, one front-end launch per step and eval
     batch (phase 7 times the augmented step in turns with the plain one and
     profiles five); the flagship train step with
     remat_trunk off and on (first-step loss within 1e-3, running
     statistics equal, peak memory, step ms); evaluate_sed on 64
     synthetic_events clips of 10 s at the streaming preset's width;
  7. times (median of 30 after warm-up): each kernel, its plain version and
     the library call where one exists, with CUDA events (the front-end per
     mode at the serving and training shapes, at the frame tile tile_frames
     picks and at each tile; the probe kernels on inputs that are not in
     the L2 cache, at every case but [33, 7], with row_merge_generic also
     timed at the aligned shapes, where the wrapper takes row_merge_bulk;
     the ADPCM decode per width at the serving and training shapes on
     L2-cold wires and on a wire in the L2 cache, both variants, and each
     variant on one 64-sample unit, its launch floor; the front-end at the
     flagship's [128, 160000]); server ticks on the host clock, tick() and
     the packed tick in turns (int16 with the ring off and on, adpcm4), and one train
     step; each kernel's bound; and torch.profiler breakdowns (device busy,
     idle share, host-to-device copies per tick) of ten ticks of each kind
     and five train steps;
  8a. the doctor: `python -m mla_tpu_torch doctor` as a subprocess, its
     report printed; no-device, a card other than (9, 0), a check in error or
     a build that does not load fails the phase, a degraded verdict is
     printed with its reasons (GEMM TFLOPS and repeat spread, fetch RTT,
     TF32 flags);
  8b. the parity harness: parity.run_all() in process on the card, every
     check line printed, none failed (metrics_vs_sklearn may be skipped
     where sklearn does not import), frontend_pallas through one front-end
     launch, and the caller's TF32 flags (turned on for it) read the same after;
     then `python -m mla_tpu_torch parity` as a subprocess, exit 0;
  8c. fit() on us8k_fused_frontend as shipped, cut to 10 steps, with
     train.tensorboard: the event file read back with EventAccumulator has
     the tags, steps and values (as f32) of scalars.csv; one front-end
     launch per step and eval batch;
  8d. the same preset streamed on the adpcm4 wire (data.device_resident
     false: each batch gathered and encoded on the host, uploaded, decoded
     by the scan kernel), 10 steps: finite losses, one native encode, one
     scan decode and one front-end launch per step (plus one front-end
     launch per eval batch); then its step in turns with the same step on the numpy encoder and with
     the resident adpcm4 step on the same batch, host ms, device busy and
     idle share of each (the card's side of an out-of-core set);
  9. the checkpoint verbs, as subprocesses (`python -m mla_tpu_torch ...`),
     most at once: weights --out from phase 6's trained workspace (exactly
     the keys and arrays of state_dict_to_flat), weights --load into a
     fresh workspace and eval on both (identical stats; eval in process:
     one front-end launch per eval batch); eval --per_class --calibrate
     --events --sweep (a CSV row and a threshold per class, events and events_sweep
     stats); infer on a 30 s wav at full width with frontend.impl="pallas"
     and phase 5's weights (loaded by weights --load), one-shot and --stream
     with --timeline and --events, and --wav_dir over three clips of other
     lengths: the top-k bit-equal to tag_clip / StreamingTagger in process,
     the same runs through the CLI in process with one front-end launch per
     device step; embed bit-equal to AudioTagger.embed(apply_frontend(...))
     (one front-end launch), extract bit-equal to waveform_to_patches,
     summary and configs equal to their in-process text; profile (3 traced steps of
     us8k_fused_frontend): a trace file and the reference's JSON keys, its
     mean_step_ms beside phase 7's untraced step; the native ingest library:
     both ADPCM encoders bit-exact against numpy at [64, 64000] block 256
     and [8, 77120] block 64, wav decode and the 44.1 -> 16 kHz resample
     within 1e-6 of scipy, host ms each. prep, infer --plot and the AudioSet
     packer need h5py, matplotlib and tensorflow and are not run here;
  10. parallelism on the one card (the machine has one device, so meshes
     name cuda:0 more than once and two ranks share it): the stream-sharded
     server (8 streams over [cuda:0] x 2, int16 and adpcm4, ring 64, by tick()
     and the packed tick) against the unsharded server, f32 with TF32 off
     within rtol 1e-4 / atol 1e-5 and the preset's bf16 within the bf16
     budget, one front-end launch (and on adpcm4 one serial decode) per shard and
     device step, the ticks timed in turns and profiled; serve --native
     --shard_streams tagged by tag; tag_clip_time_sharded of a 60 s clip over
     [cuda:0] x 4 against tag_clip, one front-end launch; the train verb on one NCCL
     rank under torch.distributed.run, its losses against the plain fit's
     (bit-equal); two gloo ranks (this script with --dp-worker) against one
     process at the global batch: us8k in f32 (3 steps, losses; 1 step,
     gradients against a one-ulp control; 1 step at the CPU tests' widths,
     gradients and parameters strictly) and audioset_full_dp as shipped (2 x
     128 against 256, losses within 1e-3, step time and idle share per rank).
  11. tensor parallelism on the one card: the rule's sharded names on the
     flagship and serving trees at model 2 (15 each) and the bytes a rank
     holds; fit with train.model_parallel=2 on two gloo ranks against one
     process (us8k as shipped, 3 steps and an eval, each step's loss within
     2x the furthest of eight one-ulp input controls of one process at that
     step, at least 1e-4, one front-end launch per step and eval batch a rank; us8k f32 with TF32 off, one
     step, gradients against the one-ulp control; audioset_full_dp at a
     global batch of 128, losses within 1e-3, step ms, idle share, peak
     memory and the collectives' host ms a rank) and on a (2, 2) grid of four
     ranks (us8k f32, one step, against the control); the server over weights
     sharded over [cuda:0] x (1, 2) and x (2, 2) (a tensor-parallel replica
     per data row; int16 and adpcm4, tick() and the packed tick, ring 64)
     against the unsharded server, f32 with TF32 off within 1e-6 and bf16
     within 1e-3, one front-end launch per data row and device step; a reload of
     sharded weights keeping the layout; the ticks in turns and profiled;
     entry.dryrun_multichip(8) on the card.
Launch counts are set to 0 just before each path (probe, serving on each
wire, the ring, packed and reload serving paths, the two fronts' soaks and the
reload soak, each exported artifact's run, training, adpcm4-staged
training, the flagship forward and train steps, the augmented fit, the SED
harness, the parity harness, the TensorBoard fit, the streamed fit,
phase 9's in-process eval, infer (one-shot, streamed, folder) and embed, and
phase 10's sharded servers, context-parallel scoring and each rank's fits,
phase 11's fits and tensor-parallel servers)
is driven and read just after. The script prints the card's line
from nvidia-smi, one JSON line of per-kernel numbers, and last
{"ok": true, "device": {...}}. The full record also goes to
build/chip_smoke.json.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import csv
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
FLAGSHIP_STEPS = 3  # train steps per front-end impl
# (substring of the CUDA symbol, kernel), the first match counting: the
# port's own kernels are launched through ctypes, outside any operator, so
# the profiler is read by name
PORT_KERNELS = (("fused_log_mel", "fused_log_mel_patches"), ("scale2_kernel", "scale2"),
                ("row_merge_bulk", "row_merge"), ("row_merge_generic", "row_merge"),
                ("adpcm_decode_scan", "adpcm_decode scan"), ("adpcm_decode", "adpcm_decode serial"))


# the flagship's trunk blocks: (H, W, C) of each conv's output for one
# 96 x 64 patch, two blocks a stage; the tag cell's forward is 128 clips x
# 10 patches, the train cell's step 256 x 10
NORM_ACT_BLOCKS = ((96, 64, 64), (96, 64, 64), (48, 32, 128), (48, 32, 128),
                   (24, 16, 256), (24, 16, 256), (12, 8, 512), (12, 8, 512))
NORM_ACT_PATCHES = {"tag": 1280, "train": 2560}


def _norm_act_phase(tag) -> dict:
    """Phase 3b: the batch-norm + ReLU kernels (csrc/norm_act.cu) at the
    flagship's block shapes, tag (eval: apply, apply_pool) and train (stats,
    apply, backward_reduce, backward_dx and their pooled versions),
    channels-last bf16 as the convolutions leave them: each against its
    plain version on the card (the elementwise kernels bit-exact given the
    same vectors, apply_pool against apply then F.max_pool2d, the reductions
    within f32 summation-order error, and bit-identical from run to run),
    each timed against its byte bound beside the plain version and
    F.batch_norm + relu, + F.max_pool2d for the pooled kernels (library_ms:
    the port never calls it); the eight blocks' sums as the main path runs
    them (each stage's second block pooled); then the launches of a
    flagship forward (128 x 10 s: 4 apply + 4 apply_pool) and of a flagship
    train step (8 stats; 4 each of apply, backward_reduce, backward_dx and
    of their pooled versions)."""
    import torch.nn.functional as F

    from mla_tpu_torch.entry import flagship_config, flagship_forward
    from mla_tpu_torch.models.zoo import build_model
    from mla_tpu_torch.ops import norm_act as na
    from mla_tpu_torch.train.state import create_train_state, make_train_step
    from mla_tpu_torch.utils.cuda_timing import device_median_ms

    t_phase = time.perf_counter()
    ops = torch.ops.mla_tpu_torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rec = {"shapes": {}}
    for size, patches in NORM_ACT_PATCHES.items():
        for h, w, c in sorted(set(NORM_ACT_BLOCKS), key=lambda b: -b[0]):
            key = f"{size} [{patches}, {c}, {h}, {w}]"
            x = (torch.randn((patches, c, h, w), generator=gen, device="cuda") * 2 + 0.5).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            weight = torch.rand(c, generator=gen, device="cuda") + 0.5
            bias = torch.randn(c, generator=gen, device="cuda") * 0.5
            mean = torch.randn(c, generator=gen, device="cuda") * 0.1 + 0.5
            var = torch.rand(c, generator=gen, device="cuda") + 3.5
            rstd = torch.rsqrt(var + 1e-5)
            scale = rstd * weight
            r = {"bytes": {k: na.bytes_moved(x, k) for k in na.LAUNCHES}}
            r["bound_ms"] = {k: b / PEAK_BYTES * 1e3 for k, b in r["bytes"].items()}
            # the elementwise kernels equal their plain versions bit for bit,
            # apply_pool the library's max pool of apply's output too
            y = ops.norm_act_apply(x, mean, scale, bias)
            yp = ops.norm_act_apply_pool(x, mean, scale, bias)
            if not (torch.equal(y, na.apply_reference(x, mean, scale, bias))
                    and torch.equal(yp, F.max_pool2d(y, 2, 2))
                    and torch.equal(yp, na.apply_pool_reference(x, mean, scale, bias))):
                raise RuntimeError(f"norm_act apply / apply_pool at {key} is not bit-exact "
                                   f"against the plain version")
            r["ms"] = {"apply": device_median_ms(lambda: ops.norm_act_apply(x, mean, scale, bias)),
                       "apply_pool": device_median_ms(
                           lambda: ops.norm_act_apply_pool(x, mean, scale, bias))}
            r["plain_ms"] = {"apply": device_median_ms(
                lambda: na.apply_reference(x, mean, scale, bias), reps=5, inner=2),
                "apply_pool": device_median_ms(
                lambda: na.apply_pool_reference(x, mean, scale, bias), reps=5, inner=2)}
            r["library_ms"] = {"apply": device_median_ms(
                lambda: torch.relu(F.batch_norm(x, mean, var, weight, bias, False, 0.0, 1e-5)),
                reps=5, inner=2), "apply_pool": device_median_ms(
                lambda: F.max_pool2d(torch.relu(
                    F.batch_norm(x, mean, var, weight, bias, False, 0.0, 1e-5)), 2, 2),
                reps=5, inner=2)}
            if size == "train":
                dy = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
                dy = dy.contiguous(memory_format=torch.channels_last)
                # the reductions against f64 sums of the same terms, as a share
                # of the sum of the terms' magnitudes, beside the plain version's
                xd = x.double()
                exact = torch.stack([xd.sum(dim=(0, 2, 3)), (xd * xd).sum(dim=(0, 2, 3))])
                mag = torch.stack([xd.abs().sum(dim=(0, 2, 3)), exact[1]])
                del xd
                g, xhat = na._gate_and_xhat(dy, x, mean, rstd, scale, bias)
                gd, gxd = g.double(), (g * xhat).double()
                bexact = torch.stack([gd.sum(dim=(0, 2, 3)), gxd.sum(dim=(0, 2, 3))])
                bmag = torch.stack([gd.abs().sum(dim=(0, 2, 3)), gxd.abs().sum(dim=(0, 2, 3))])
                del g, xhat, gd, gxd

                def sum_err(got, want, scale_):
                    return float(((got.double() - want).abs() / scale_.clamp_min(1e-30)).max())

                sums = ops.norm_act_stats(x)
                bsums = ops.norm_act_backward_reduce(dy, x, mean, rstd, scale, bias)
                errs = {"stats": sum_err(sums, exact, mag),
                        "stats_plain": sum_err(na.stats_reference(x), exact, mag),
                        "backward_reduce": sum_err(bsums, bexact, bmag),
                        "backward_reduce_plain": sum_err(
                            na.backward_reduce_reference(dy, x, mean, rstd, scale, bias), bexact,
                            bmag)}
                repeat = (torch.equal(sums, ops.norm_act_stats(x)) and torch.equal(
                    bsums, ops.norm_act_backward_reduce(dy, x, mean, rstd, scale, bias)))
                cb, cc = bsums[0] / x[:, 0].numel(), bsums[1] / x[:, 0].numel()
                dx = ops.norm_act_backward_dx(dy, x, mean, rstd, scale, bias, cb, cc)
                dx_exact = torch.equal(dx, na.backward_dx_reference(dy, x, mean, rstd, scale,
                                                                     bias, cb, cc))
                # the pooled backward: dy at the pooled size, against the
                # unpooled kernels' plain versions of dy routed by the max
                # pool's own backward
                dyp = torch.randn((patches, c, h // 2, w // 2), generator=gen, device="cuda")
                dyp = dyp.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
                routed = na._route(dyp, x, mean, scale, bias)
                g, xhat = na._gate_and_xhat(routed, x, mean, rstd, scale, bias)
                gd, gxd = g.double(), (g * xhat).double()
                pexact = torch.stack([gd.sum(dim=(0, 2, 3)), gxd.sum(dim=(0, 2, 3))])
                pmag = torch.stack([gd.abs().sum(dim=(0, 2, 3)), gxd.abs().sum(dim=(0, 2, 3))])
                del g, xhat, gd, gxd
                psums = ops.norm_act_backward_reduce_pool(dyp, x, mean, rstd, scale, bias)
                errs["backward_reduce_pool"] = sum_err(psums, pexact, pmag)
                repeat = repeat and torch.equal(
                    psums, ops.norm_act_backward_reduce_pool(dyp, x, mean, rstd, scale, bias))
                dx_exact = dx_exact and torch.equal(
                    ops.norm_act_backward_dx_pool(dyp, x, mean, rstd, scale, bias, cb, cc),
                    na.backward_dx_reference(routed, x, mean, rstd, scale, bias, cb, cc))
                del routed
                r.update(sum_err=errs, repeats_bit_for_bit=repeat, dx_bit_exact=dx_exact)
                if (max(errs["stats"], errs["backward_reduce"], errs["backward_reduce_pool"])
                        > 1e-5 or not repeat or not dx_exact):
                    raise RuntimeError(f"norm_act train kernels at {key}: {r}")
                r["ms"].update(
                    stats=device_median_ms(lambda: ops.norm_act_stats(x)),
                    backward_reduce=device_median_ms(
                        lambda: ops.norm_act_backward_reduce(dy, x, mean, rstd, scale, bias)),
                    backward_dx=device_median_ms(
                        lambda: ops.norm_act_backward_dx(dy, x, mean, rstd, scale, bias, cb, cc)),
                    backward_reduce_pool=device_median_ms(
                        lambda: ops.norm_act_backward_reduce_pool(dyp, x, mean, rstd, scale, bias)),
                    backward_dx_pool=device_median_ms(
                        lambda: ops.norm_act_backward_dx_pool(dyp, x, mean, rstd, scale, bias, cb,
                                                              cc)))
                r["plain_ms"].update(
                    stats=device_median_ms(lambda: na.stats_reference(x), reps=5, inner=2),
                    backward_reduce=device_median_ms(lambda: na.backward_reduce_reference(
                        dy, x, mean, rstd, scale, bias), reps=5, inner=2),
                    backward_dx=device_median_ms(lambda: na.backward_dx_reference(
                        dy, x, mean, rstd, scale, bias, cb, cc), reps=5, inner=2),
                    backward_reduce_pool=device_median_ms(lambda: na.backward_reduce_pool_reference(
                        dyp, x, mean, rstd, scale, bias), reps=5, inner=2),
                    backward_dx_pool=device_median_ms(lambda: na.backward_dx_pool_reference(
                        dyp, x, mean, rstd, scale, bias, cb, cc), reps=5, inner=2))
                # the train block, forward and forward + backward: the fused op
                # against F.batch_norm + relu in train mode
                xg = x.detach().requires_grad_(True)
                wg, bg = weight.clone().requires_grad_(True), bias.clone().requires_grad_(True)

                def fused_step():
                    out = na.norm_relu_train(xg, wg, bg, 1e-5)[0]
                    out.backward(dy)

                def library_step():
                    out = torch.relu(F.batch_norm(xg, None, None, wg, bg, True, 0.0, 1e-5))
                    out.backward(dy)

                def fused_pool_step():
                    out = na.norm_relu_train(xg, wg, bg, 1e-5, pool=True)[0]
                    out.backward(dyp)

                def library_pool_step():
                    out = F.max_pool2d(torch.relu(
                        F.batch_norm(xg, None, None, wg, bg, True, 0.0, 1e-5)), 2, 2)
                    out.backward(dyp)

                r["ms"]["train_forward_backward"] = device_median_ms(fused_step, reps=5, inner=2)
                r["library_ms"]["train_forward_backward"] = device_median_ms(
                    library_step, reps=5, inner=2)
                r["ms"]["train_forward_backward_pool"] = device_median_ms(
                    fused_pool_step, reps=5, inner=2)
                r["library_ms"]["train_forward_backward_pool"] = device_median_ms(
                    library_pool_step, reps=5, inner=2)
                del dy, dyp, xg, wg, bg
            r["roofline"] = {k: r["bound_ms"][k] / ms for k, ms in r["ms"].items()
                             if k in r["bound_ms"]}
            rec["shapes"][key] = r
            print(f"norm_act {key}: ms {json.dumps(r['ms'])}; bound ms "
                  f"{json.dumps({k: round(v, 5) for k, v in r['bound_ms'].items()})}; share of "
                  f"the byte bound {json.dumps({k: round(v, 4) for k, v in r['roofline'].items()})}"
                  f"; plain ms {json.dumps(r['plain_ms'])}; library ms "
                  f"{json.dumps(r['library_ms'])} {tag}")
            del x, y, yp
            torch.cuda.empty_cache()
    # the eight blocks of a tag forward: apply against its bound, in all
    blocks = {size: [rec["shapes"][f"{size} [{p}, {c}, {h}, {w}]"] for h, w, c in NORM_ACT_BLOCKS]
              for size, p in NORM_ACT_PATCHES.items()}
    for size, rs in blocks.items():
        tot = {k: sum(r["ms"][k] for r in rs) for k in rs[0]["ms"] if k in rs[0]["bound_ms"]}
        bound = {k: sum(r["bound_ms"][k] for r in rs) for k in tot}
        eight = rec[f"{size}_eight_blocks"] = {
            "ms": tot, "bound_ms": bound,
            "plain_ms": {k: sum(r["plain_ms"][k] for r in rs) for k in tot},
            "library_ms": {k: sum(r["library_ms"][k] for r in rs) for k in rs[0]["library_ms"]},
            "roofline": {k: bound[k] / tot[k] for k in tot}}
        print(f"norm_act, the eight blocks of a {size} step: {json.dumps(eight)} {tag}")
        # as the main path runs them: each stage's second block pooled
        main = {"ms": {}, "bound_ms": {}}
        for b, r in enumerate(rs):
            for k in ("apply", "stats", "backward_reduce", "backward_dx"):
                run = f"{k}_pool" if b % 2 and k != "stats" else k
                if run in r["ms"]:
                    for field in ("ms", "bound_ms"):
                        main[field][k] = main[field].get(k, 0.0) + r[field][run]
        main["roofline"] = {k: main["bound_ms"][k] / main["ms"][k] for k in main["ms"]}
        rec[f"{size}_main_path"] = main
        print(f"norm_act, the eight blocks as the main path runs them ({size}): "
              f"{json.dumps(main)} {tag}")

    # the main path's launches: a flagship forward at 128 x 10 s, a train step
    cfg = flagship_config()
    model = build_model(cfg.model, seed=SEED)
    n = int(round(cfg.data.clip_seconds * cfg.frontend.sample_rate))
    wav = torch.randn((FLAGSHIP_BATCH, n), generator=gen, device="cuda") * 0.1
    labels = (torch.rand((FLAGSHIP_BATCH, cfg.model.n_classes), generator=gen, device="cuda")
              < 0.05).float()
    for k in na.LAUNCHES:
        na.LAUNCHES[k] = 0
    model.eval()
    flagship_forward(cfg)(model, wav)
    torch.cuda.synchronize()
    fwd = dict(na.LAUNCHES)
    for k in na.LAUNCHES:
        na.LAUNCHES[k] = 0
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, "waveform")
    loss = float(step(state, wav, labels)[1])
    torch.cuda.synchronize()
    train = dict(na.LAUNCHES)
    rec["launches"] = {"flagship_forward": fwd, "flagship_train_step": train}
    print(f"norm_act launches: flagship forward {fwd}; flagship train step {train} (loss "
          f"{loss:.6f})")
    want_fwd = {**dict.fromkeys(na.LAUNCHES, 0), "apply": 4, "apply_pool": 4}
    want_train = {"apply": 4, "stats": 8, "backward_reduce": 4, "backward_dx": 4,
                  "apply_pool": 4, "backward_reduce_pool": 4, "backward_dx_pool": 4}
    if fwd != want_fwd or train != want_train or not np.isfinite(loss):
        raise RuntimeError(f"norm_act launches on the main path: forward {fwd} (want {want_fwd}),"
                           f" train step {train} (want {want_train}), loss {loss}")
    del model, state, step
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 3b: {rec['phase_s']:.1f} s {tag}")
    return rec


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


def _device_busy_us(device_events) -> float:
    """The union of the device intervals of a profiler's device records, µs."""
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in device_events):
        if cur_e is None or s > cur_e:
            busy_us += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy_us + (0 if cur_e is None else cur_e - cur_s)


def _device_work(prof) -> list:
    """A profiler's device records that are work: without the profiler's
    step annotation, which spans the whole window, and without a span's
    range on the device timeline (``record_function``: the program's
    ``mla.*`` spans), which also covers the gaps between its kernels. The
    program's span store is emptied: nothing here reads it."""
    from mla_tpu_torch.utils import profiling

    profiling.clear()
    return [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and not ev.name.startswith("ProfilerStep")]


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
    device = _device_work(prof)
    copies = {}
    for ev in device:
        if "memcpy" in ev.name.lower():
            copies[ev.name] = copies.get(ev.name, 0) + 1
    htod = sum(c for k, c in copies.items() if "HtoD" in k) / n
    if not device:
        return host_ms, None, [], htod, copies
    busy_us = _device_busy_us(device)
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


FRONT_POST_S = 1  # seconds of audio per sync POST in the fronts phase
FRONT_SCORE_BUDGET = 1e-3  # scores through a front against direct drive of the same bytes
FRONT_TIMEOUT_S = 60  # every client request's timeout in the fronts phase
FRONT_PROFILE_TICKS = 10  # ticks in each front's profiled soak
FRONT_REPEATS = 2  # measured soaks per front from client threads, and from the client process
CLI_TIMEOUT_S = 300  # the serve subprocess's start, and the tag subprocess


class _TimedLock:
    """A front's ``dev`` lock that records how long each acquire waited and
    on which thread: the tick thread's, or a handler's (open, flush,
    snapshot, reload commit) waiting for a step."""

    def __init__(self, lock):
        import threading

        self.lock, self.waits, self._thread_name = lock, [], threading.current_thread

    def __enter__(self):
        t0 = time.perf_counter()
        self.lock.acquire()
        self.waits.append((self._thread_name().name, (time.perf_counter() - t0) * 1e3))
        return self

    def __exit__(self, *exc):
        self.lock.release()


def _lock_waits(waits) -> dict:
    """Handler threads' waits for ``dev`` (ms): count, median, p99, max."""
    ms = [w for name, w in waits if "tick" not in name]
    if not ms:
        return {"n": 0}
    return {"n": len(ms), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "max_ms": max(ms)}


def _step_stamps(srv) -> list:
    """Wrap the server's packed step (the front's tick thread calls it) to
    record each call's host-clock (start, end); returns the list it fills."""
    stamps, step = [], srv._packed_step

    def timed(*args):
        t0 = time.perf_counter()
        out = step(*args)
        stamps.append((t0, time.perf_counter()))
        return out

    timed.__wrapped__ = step
    srv._packed_step = timed
    return stamps


def _wire_bodies(client_mod, wire, audio):
    """One stream's audio as the client sends it: 1 s bodies in the wire,
    then the final partial block (adpcm), encoded by the port's client."""
    enc = client_mod._WireEncoder(wire)
    step = FRONT_POST_S * 16000
    bodies = [enc.encode(audio[lo:lo + step]) for lo in range(0, len(audio), step)]
    return [b for b in bodies + [enc.encode(np.zeros(0, np.int16), final=True)] if b]


def _run_clients(fn, n, timeout=FRONT_TIMEOUT_S * 4):
    """fn(i) on n threads; raises with the first error; every thread joined."""
    import threading

    errs = []

    def wrap(i):
        try:
            fn(i)
        except Exception as e:  # re-raised below, on the calling thread
            errs.append((i, e))

    ts = [threading.Thread(target=wrap, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    if any(t.is_alive() for t in ts):
        raise RuntimeError("fronts: a client thread did not finish")
    if errs:
        raise RuntimeError(f"fronts: client {errs[0][0]} failed: {errs[0][1]!r}") from errs[0][1]


def _soak(client_mod, base, wire, bodies, names, on_first_close=None, timeline=False):
    """One client thread per stream: open, post its bodies (sync, timed), flush,
    read all scores (and the timeline), close. ``on_first_close(client)``
    runs on its own thread once the first stream has closed (a slot is
    free). Returns (per-stream score vectors, latencies ms, wall s, extra)."""
    import threading

    n = len(bodies)
    lat = [[] for _ in range(n)]
    scores = [None] * n
    closed = threading.Event()
    extra = {}

    def stream(i):
        c = client_mod.TagClient(base, timeout=FRONT_TIMEOUT_S)
        try:
            with c.stream(wire=wire) as s:
                for body in bodies[i]:
                    t0 = time.perf_counter()
                    s.feed_wire(body)
                    lat[i].append((time.perf_counter() - t0) * 1e3)
                s.flush()
                top = s.scores(top_k=len(names))
                if timeline:
                    extra.setdefault("timelines", {})[i] = s.timeline(top_k=5)
            v = np.zeros(len(names), np.float32)
            for label, prob in top:
                v[names.index(label)] = prob
            scores[i] = v
        finally:
            c.close()
            closed.set()

    side = []
    if on_first_close is not None:
        def ride():
            if not closed.wait(FRONT_TIMEOUT_S * 4):
                raise RuntimeError("no stream closed")
            c = client_mod.TagClient(base, timeout=FRONT_TIMEOUT_S)
            try:
                extra["side"] = on_first_close(c)
            finally:
                c.close()
        side = [ride]
    t0 = time.perf_counter()
    _run_clients(lambda i: stream(i) if i < n else side[0](), n + len(side))
    wall = time.perf_counter() - t0
    return scores, [x for li in lat for x in li], wall, extra


def _remote_soak(base, wire, bodies, names):
    """``_soak`` in a client process of its own (a spawned worker), so the
    server's process runs only the front and the clients' Python competes
    with it for cores, not for its interpreter lock."""
    from mla_tpu_torch.serve import client as client_mod

    return _soak(client_mod, base, wire, bodies, names)


def _direct_scores(make_server, wire, bodies, names):
    """Direct drive: a BatchedStreamingServer fed each stream's exact bytes,
    drained with ticks, flushed; returns the score vectors."""
    d = make_server()
    sids = [d.open() for _ in bodies]
    for sid, bs in zip(sids, bodies):
        for b in bs:
            if wire == "int16":
                d.feed(sid, np.frombuffer(b, "<i2"))
            else:
                d.feed(sid, np.frombuffer(b, np.uint8), wire=True)
    while d.tick_packed():
        pass
    for sid in sids:
        d.flush(sid)
    out = [d.scores(sid) for sid in sids]
    for sid in sids:
        d.close(sid)
    return out


def _profiled_soak(client_mod, base, wire, bodies, ticks_fn, tag):
    """Eight client threads post 1 s bodies round their streams until the
    front has ticked FRONT_PROFILE_TICKS more times, under torch.profiler:
    (ticks, device busy ms per tick, idle share of the window)."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    stop = threading.Event()

    def stream(i):
        c = client_mod.TagClient(base, timeout=FRONT_TIMEOUT_S)
        try:
            with c.stream(wire=wire) as s:
                k = 0
                while not stop.is_set():
                    s.feed_wire(bodies[i][k % (len(bodies[i]) - 1)])  # whole bodies only
                    k += 1
        finally:
            c.close()

    t_before = ticks_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        waiter = threading.Thread(target=lambda: _run_clients(stream, len(bodies)))
        waiter.start()
        deadline = time.monotonic() + FRONT_TIMEOUT_S
        while ticks_fn() - t_before < FRONT_PROFILE_TICKS and time.monotonic() < deadline:
            time.sleep(0.002)
        stop.set()
        waiter.join(timeout=FRONT_TIMEOUT_S * 4)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ticks = ticks_fn() - t_before
    if waiter.is_alive() or ticks < FRONT_PROFILE_TICKS:
        raise RuntimeError(f"fronts profile: {ticks} ticks in {wall_ms:.1f} ms")
    device = _device_work(prof)
    if not device:
        print(f"fronts profile: device time not measured (the profiler saw no device "
              f"activity) {tag}")
        return {"ticks": ticks, "wall_ms": wall_ms, "device_busy_ms_per_tick": None,
                "idle_share": None}
    busy_ms = _device_busy_us(device) / 1e3
    return {"ticks": ticks, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_ms_per_tick": busy_ms / ticks, "idle_share": 1 - busy_ms / wall_ms}


def _fronts(scfg, state_dict, state_dict2, streams, zero_counts, check_launches, tag):
    """The fronts phase: the stdlib HTTP front (int16, ring on) and the
    native C++ front (adpcm4) at full width under eight client threads,
    scores held against direct drive of the same bytes, launches against
    device steps; a reload mid-soak on the native front; then the `serve`
    and `tag` verbs in subprocesses. Returns (record, {path: launches})."""
    from mla_tpu_torch.data.audio_io import write_wav
    from mla_tpu_torch.data.labels import labels_for
    from mla_tpu_torch.serve import client as client_mod
    from mla_tpu_torch.serve.http import create_server
    from mla_tpu_torch.serve.native_front import create_native_server
    from mla_tpu_torch.serve.server import BatchedStreamingServer

    import threading

    names = labels_for(scfg.data.dataset, scfg.model.n_classes)
    rec, paths = {}, {}
    kw = dict(port=0, max_streams=8, chunk_patches=5)
    audio_s = sum(len(s) for s in streams) / 16000

    def summarize(front, run, direct):
        err = max(float(np.abs(a - b).max()) for a, b in zip(run["scores"], direct))
        lat, wall, ticks, step_ms = run["lat"], run["wall"], run["ticks"], run["step_ms"]
        r = {"clients": run["where"], "max_abs_err_vs_direct": err, "requests": len(lat),
             "latency_p50_ms": float(np.percentile(lat, 50)),
             "latency_p99_ms": float(np.percentile(lat, 99)),
             "audio_s_per_wall_s": audio_s / wall, "wall_s": wall, "ticks": ticks,
             "streams_per_tick": run["ticked"] / ticks,
             "step_host_ms_mean": statistics.mean(step_ms),
             "step_host_ms_median": statistics.median(step_ms)}
        print(f"fronts, {front}, clients in {run['where']}: {len(lat)} sync POSTs of "
              f"{FRONT_POST_S} s, all 2xx; latency p50 {r['latency_p50_ms']:.4f} ms, p99 "
              f"{r['latency_p99_ms']:.4f} ms (host clock); {audio_s:.1f} s of audio in "
              f"{wall:.4f} s = {r['audio_s_per_wall_s']:.2f} audio s per wall s; {ticks} ticks, "
              f"{r['streams_per_tick']:.4f} streams per tick; the tick thread's _packed_step "
              f"host ms mean {r['step_host_ms_mean']:.4f}, median {r['step_host_ms_median']:.4f};"
              f" scores against direct drive of the same bytes max |diff| {err:.3e} (budget "
              f"{FRONT_SCORE_BUDGET:g}) {tag}")
        if err > FRONT_SCORE_BUDGET or not all(np.isfinite(v).all() for v in run["scores"]):
            raise RuntimeError(f"fronts, {front}: scores against direct drive {err}")
        return r

    def measure(base, wire, bodies, server, counters, first_run):
        """FRONT_REPEATS soaks from client threads in this process (the
        first with ``first_run``'s extras), then FRONT_REPEATS from the
        client process; each with its ticks and the tick thread's steps."""
        stamps = _step_stamps(server)
        runs = []
        for where in ("threads", "process"):
            for _ in range(FRONT_REPEATS):
                stamps.clear()
                t0, ts0 = counters()
                if where == "threads":
                    scores, lat, wall, extra = _soak(client_mod, base, wire, bodies, names,
                                                     **(first_run if not runs else {}))
                else:
                    scores, lat, wall, extra = pool.apply_async(
                        _remote_soak, (base, wire, bodies, names)).get(FRONT_TIMEOUT_S * 4)
                t1, ts1 = counters()
                runs.append({"where": where, "scores": scores, "lat": lat, "wall": wall,
                             "extra": extra, "ticks": t1 - t0, "ticked": ts1 - ts0,
                             "step_ms": [(e - s0) * 1e3 for s0, e in stamps]})
        server._packed_step = server._packed_step.__wrapped__
        return runs

    # the clients of the "process" soaks: one spawned worker for both fronts
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        # the stdlib front, int16 wire, the ring on; one /v1/tag rides along
        bodies = [_wire_bodies(client_mod, "int16", s) for s in streams]
        srv = create_server(scfg, state_dict, transfer_dtype="int16",
                            timeline_cap=TIMELINE_CAP, **kw)
        server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
        server_thread.start()
        base = "http://%s:%d" % srv.server_address[:2]
        st = srv.state
        st.ticker.dev = dev = _TimedLock(st.ticker.dev)
        try:
            zero_counts()
            d0 = st.server.dispatches
            one_shot_audio = streams[0][:10 * 16000]
            runs = measure(base, "int16", bodies, st.server,
                           lambda: (st.ticker.ticks, st.ticker.ticked_streams),
                           dict(timeline=True, on_first_close=lambda c: c.tag(
                               one_shot_audio, top_k=5, wire="int16")))
            torch.cuda.synchronize()
            paths["fronts_stdlib_int16"] = check_launches(
                "fronts, stdlib front, int16", st.server.dispatches - d0, False)
            extra = runs[0]["extra"]
            if len(extra.get("side", [])) != 5 or len(extra["timelines"]) != len(streams) \
                    or any(not 0 < len(t["probs"]) <= TIMELINE_CAP
                           for t in extra["timelines"].values()):
                raise RuntimeError(f"fronts, stdlib: one-shot {extra.get('side')} or timelines")
            direct = _direct_scores(lambda: BatchedStreamingServer(
                scfg, state_dict, max_streams=8, chunk_patches=5, transfer_dtype="int16",
                timeline_cap=TIMELINE_CAP), "int16", bodies, names)
            rec["stdlib_int16"] = {
                "runs": [summarize("stdlib front, int16, ring 64", r, direct) for r in runs],
                "one_shot_top": extra["side"], "dev_lock_waits": _lock_waits(dev.waits),
                **paths["fronts_stdlib_int16"]}
            print(f"fronts, stdlib front: handler threads' waits for the dev lock over the soaks "
                  f"{rec['stdlib_int16']['dev_lock_waits']} {tag}")
            rec["stdlib_int16"]["profile"] = prof = _profiled_soak(
                client_mod, base, "int16", bodies, lambda: st.ticker.ticks, tag)
            print(f"fronts, stdlib front, int16: profiled soak {prof} {tag}")
        finally:
            srv.shutdown()
            srv.server_close()
            server_thread.join(timeout=30)

        # the native front, adpcm4 wire: the C++ fast path, the decode on the card
        bodies = [_wire_bodies(client_mod, "adpcm4", s) for s in streams]
        nsrv = create_native_server(scfg, state_dict, transfer_dtype="adpcm4",
                                    reload_fn=lambda: (state_dict2, {"weights": "seed 1"}),
                                    **kw)
        base = "http://%s:%d" % nsrv.server_address
        nsrv.dev = dev = _TimedLock(nsrv.dev)
        try:
            zero_counts()
            d0 = nsrv.srv.dispatches
            runs = measure(base, "adpcm4", bodies, nsrv.srv,
                           lambda: (nsrv.ticker.ticks, nsrv.ticker.ticked_streams), {})
            torch.cuda.synchronize()
            paths["fronts_native_adpcm4"] = check_launches(
                "fronts, native front, adpcm4", nsrv.srv.dispatches - d0, True)

            def direct_adpcm4(sd):
                return lambda: BatchedStreamingServer(scfg, sd, max_streams=8,
                                                      chunk_patches=5, transfer_dtype="adpcm4")

            direct = _direct_scores(direct_adpcm4(state_dict), "adpcm4", bodies, names)
            rec["native_adpcm4"] = {
                "runs": [summarize("native front, adpcm4", r, direct) for r in runs],
                "dev_lock_waits": _lock_waits(dev.waits), **paths["fronts_native_adpcm4"]}
            print(f"fronts, native front: worker threads' waits for the dev lock over the soaks "
                  f"{rec['native_adpcm4']['dev_lock_waits']} {tag}")
            dev.waits.clear()
            rec["native_adpcm4"]["profile"] = prof = _profiled_soak(
                client_mod, base, "adpcm4", bodies, lambda: nsrv.ticker.ticks, tag)
            print(f"fronts, native front, adpcm4: profiled soak {prof} {tag}")

            # a reload mid-soak: six streams keep posting; a stream opened after
            # the reload is held against a fresh server on the new weights
            soak_bodies = bodies[:6]
            stamps = _step_stamps(nsrv.srv)
            zero_counts()
            d0 = nsrv.srv.dispatches
            posted = [0]
            reload_out = {}

            def reload_then_stream(c):
                deadline = time.monotonic() + FRONT_TIMEOUT_S
                while posted[0] < 6 * 8 and time.monotonic() < deadline:  # ~a third of the posts
                    time.sleep(0.001)
                t_a = time.perf_counter()
                reload_out["reply"] = c.reload()
                t_b = time.perf_counter()
                reload_out["window"] = (t_a, t_b)
                try:
                    with c.stream(wire="adpcm4") as s:
                        for body in bodies[2]:
                            s.feed_wire(body)
                        s.flush()
                        top = s.scores(top_k=len(names))
                finally:
                    c.close()
                v = np.zeros(len(names), np.float32)
                for label, prob in top:
                    v[names.index(label)] = prob
                return v

            def soak_stream(i):
                if i == 6:
                    reload_out["after"] = reload_then_stream(client_mod.TagClient(
                        base, timeout=FRONT_TIMEOUT_S))
                    return
                c = client_mod.TagClient(base, timeout=FRONT_TIMEOUT_S)
                try:
                    with c.stream(wire="adpcm4") as s:
                        for body in soak_bodies[i]:
                            s.feed_wire(body)
                            posted[0] += 1
                        s.flush()
                        s.scores()
                finally:
                    c.close()

            _run_clients(soak_stream, 7)
            torch.cuda.synchronize()
            paths["fronts_native_reload_adpcm4"] = check_launches(
                "fronts, native front, reload soak, adpcm4", nsrv.srv.dispatches - d0, True)
            fresh = _direct_scores(direct_adpcm4(state_dict2), "adpcm4", [bodies[2]], names)[0]
            reload_err = float(np.abs(reload_out["after"] - fresh).max())
            old_err = float(np.abs(reload_out["after"] - direct[2]).max())
            t_a, t_b = reload_out["window"]
            starts = [s0 for s0, _ in stamps]
            gaps = [(b - a, a, b) for a, b in zip(starts, starts[1:])]
            around = [g for g, a, b in gaps if b >= t_a and a <= t_b + 0.05]
            elsewhere = [g for g, a, b in gaps if not (b >= t_a and a <= t_b + 0.05)]
            rec["native_reload"] = r = {
                "reply": reload_out["reply"], "reload_request_ms": (t_b - t_a) * 1e3,
                "max_abs_err_vs_fresh": reload_err, "max_abs_err_vs_old_weights": old_err,
                "ticks": len(stamps),
                "max_tick_gap_around_reload_ms": max(around) * 1e3 if around else None,
                "max_tick_gap_elsewhere_ms": max(elsewhere) * 1e3 if elsewhere else None,
                "dev_lock_waits": _lock_waits(dev.waits),
                "median_tick_gap_ms": (statistics.median(g for g, _, _ in gaps) * 1e3
                                       if gaps else None),
                **paths["fronts_native_reload_adpcm4"]}
            print(f"fronts, native front, reload mid-soak: POST /v1/reload "
                  f"{r['reload_request_ms']:.4f} ms, reply {r['reply']}; every request 2xx; "
                  f"longest gap between tick starts around the reload "
                  f"{r['max_tick_gap_around_reload_ms']} ms, elsewhere in the soak "
                  f"{r['max_tick_gap_elsewhere_ms']} ms, median {r['median_tick_gap_ms']} ms "
                  f"({r['ticks']} ticks); a stream opened after it against a fresh server on "
                  f"the new weights max |diff| {reload_err:.3e} (budget "
                  f"{FRONT_SCORE_BUDGET:g}), against the old weights' scores {old_err:.3e}; "
                  f"worker threads' waits for the dev lock {r['dev_lock_waits']} {tag}")
            if reload_out["reply"] != {"reloaded": True, "weights": "seed 1"} \
                    or reload_err > FRONT_SCORE_BUDGET or old_err < 10 * FRONT_SCORE_BUDGET:
                raise RuntimeError(f"fronts, reload: {r}")
        finally:
            nsrv.server_close()
    finally:
        pool.terminate()
        pool.join()

    # the entry points: `serve --native` in a subprocess, tagged by `tag`
    clip = os.path.join(ROOT, "build", "fronts_clip.wav")
    os.makedirs(os.path.dirname(clip), exist_ok=True)
    write_wav(clip, streams[1][:10 * 16000], 16000)
    env = {**os.environ, "PYTHONPATH": ROOT}
    err_path = os.path.join(ROOT, "build", "fronts_serve.err")
    t_cli = time.perf_counter()
    with open(err_path, "w") as err_fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mla_tpu_torch", "serve", "--native", "--transfer_dtype",
             "adpcm4", "--checkpoint", "random", "--port", "0", "--set", "frontend.impl=pallas"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err_fh, text=True)
        try:
            import select

            ready, _, _ = select.select([proc.stdout], [], [], CLI_TIMEOUT_S)
            line = proc.stdout.readline() if ready else ""
            if not line.startswith("serving multi_level_attention on http://"):
                raise RuntimeError(f"serve did not start: {line!r}; stderr "
                                   f"{open(err_path).read()[-2000:]}")
            serve_s = time.perf_counter() - t_cli
            url = line.split(" on ")[1].split("/v1")[0]
            out = subprocess.run([sys.executable, "-m", "mla_tpu_torch", "tag", "--url", url,
                                  "--wav", clip], cwd=ROOT, env=env, capture_output=True,
                                 text=True, timeout=CLI_TIMEOUT_S)
            if out.returncode != 0:
                raise RuntimeError(f"tag failed: {out.stderr[-2000:]}")
            top = json.loads(out.stdout.strip().splitlines()[-1])["top_k"]
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
            proc.stdout.close()
    # the same clip through a direct server on the same seeded weights
    from mla_tpu_torch.data.audio_io import load_wav_16k

    body = client_mod._WireEncoder("adpcm4").encode(load_wav_16k(clip), final=True)
    want = _direct_scores(direct_adpcm4(state_dict), "adpcm4", [[body]], names)[0]
    cli_err = max(abs(p - float(want[names.index(n)])) for n, p in top)
    rec["cli"] = {"line": line.strip(), "top_k": top, "serve_start_s": serve_s,
                  "max_abs_err_vs_direct": cli_err, "s": time.perf_counter() - t_cli}
    print(f"fronts, entry points: `{line.strip()}` after {serve_s:.2f} s; `tag` printed {top}; "
          f"against a direct server on the same seeded weights max |diff| {cli_err:.3e} "
          f"(budget {FRONT_SCORE_BUDGET:g}); the server terminated")
    if len(top) != 5 or cli_err > FRONT_SCORE_BUDGET:
        raise RuntimeError(f"fronts, entry points: {rec['cli']}")
    return rec, paths


EXPORT_SCORE_BUDGET = 1e-3  # artifacts against the live xla server / eager forward, same bytes
EXPORT_SECONDS = 10.0  # the one-shot artifacts' clip length (batch 8)
EXPORT_WIRES = ("int16", "adpcm4")  # the streaming pair's wires


def _export(scfg, state_dict, streams, pallas_scores, zero_counts, tag):
    """The export phase: the one-shot artifact at batch 8 x 10 s on float32
    and adpcm4 and the streaming pair at 8 streams x 5-patch chunks with the
    ring (timeline_cap 64) on int16 and adpcm4, each exported on the card,
    written to disk and loaded fresh. Scores and timelines against the live
    server on the torch-ops front-end ("xla") fed the same bytes (1e-3) and
    scores against the "pallas" servers of phase 5 (2e-2); the one-shot
    against the eager forward of the decoded clips; decode launches = chunk
    calls (serial) on adpcm4; host ms per chunk call; a card artifact loaded
    with device="cpu". Returns (record, {path: decode launches by variant})."""
    from mla_tpu_torch.data import adpcm
    from mla_tpu_torch.data.audio_io import pcm16_quantize
    from mla_tpu_torch.ops import adpcm as ad
    from mla_tpu_torch.ops import frontend as fe
    from mla_tpu_torch.ops import fused_frontend as ff
    from mla_tpu_torch.serve import export as ex
    from mla_tpu_torch.serve.server import BatchedStreamingServer
    from mla_tpu_torch.serve.streaming import _model_with_weights, _whole_patches

    out_dir = os.path.join(ROOT, "build", "chip_smoke_export")
    shutil.rmtree(out_dir, ignore_errors=True)
    xcfg = dataclasses.replace(scfg, frontend=dataclasses.replace(scfg.frontend, impl="xla"))
    rec, dec_paths = {"oneshot": {}, "streaming": {}}, {}
    blk = adpcm.SERVE_BLOCK

    def wire_of(x, wire):
        """float32 samples [..., n] -> the wire's bytes as the server's feed takes them."""
        pcm = pcm16_quantize(x)
        return pcm if wire == "int16" else adpcm.adpcm4_encode(pcm, block=blk)

    # the one-shot forward at batch 8 x 10 s, against the eager forward of
    # the same (decoded) clips on the same weights
    n = int(EXPORT_SECONDS * scfg.frontend.sample_rate)
    clips = np.stack([s[:n] for s in streams])
    model = _model_with_weights(scfg, state_dict, torch.device("cuda"))
    for wire in ("float32", "adpcm4"):
        path = os.path.join(out_dir, f"oneshot_{wire}.mlxt")
        t0 = time.perf_counter()
        meta = ex.export_forward(scfg, state_dict, path, batch=len(clips),
                                 seconds=EXPORT_SECONDS, input_dtype=wire)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fn = ex.load_exported(path)
        load_s = time.perf_counter() - t0
        x = clips if wire == "float32" else wire_of(clips, wire)
        decoded = clips if wire == "float32" else adpcm.adpcm4_decode(x, n=n, block=blk)
        zero_counts()
        probs = fn(x)
        torch.cuda.synchronize()
        launches = {"decode": dict(ad.LAUNCHES_BY_VARIANT), "frontend": ff.LAUNCHES}
        with torch.inference_mode():
            want = model(fe.waveform_to_patches(torch.from_numpy(decoded).cuda(), scfg.frontend)
                         ).float().cpu().numpy()
        err = float(np.abs(probs - want).max())
        host_ms = _host_median_ms(lambda: fn(x), reps=10, warmup=2)
        want_dec = {"scan": 0, "serial": 1 if wire == "adpcm4" else 0}
        print(f"export one-shot, {wire}, batch {len(clips)} x {EXPORT_SECONDS:g} s: export "
              f"{export_s:.2f} s, {os.path.getsize(path) / 1e6:.2f} MB, load {load_s:.2f} s; "
              f"probs {probs.shape} against the eager forward max |diff| {err:.3e} (budget "
              f"{EXPORT_SCORE_BUDGET:g}); adpcm_decode launches {launches['decode']}, "
              f"fused_log_mel_patches launches {launches['frontend']}; host ms per call "
              f"{host_ms:.4f} {tag}")
        if probs.shape != (len(clips), scfg.model.n_classes) or not np.isfinite(probs).all() \
                or err > EXPORT_SCORE_BUDGET:
            raise RuntimeError(f"export one-shot {wire}: shape {probs.shape}, err {err}")
        if launches["decode"] != want_dec or launches["frontend"]:
            raise RuntimeError(f"export one-shot {wire}: launches {launches}, want decode "
                               f"{want_dec} and no front-end kernel (the torch-ops front-end)")
        if wire == "adpcm4":
            dec_paths["export_oneshot_adpcm4"] = launches["decode"]
        rec["oneshot"][wire] = {"export_s": export_s, "load_s": load_s, "err_vs_eager": err,
                                "bytes": os.path.getsize(path), "host_ms": host_ms,
                                "launches": launches}
    del model

    # the streaming pair: every stream's wire cut into chunk calls at the hop;
    # a stream's last call carries its tail padded with silence (n_valid its
    # whole patches), and a stream that has ended rides along with n_valid 0
    for wire in EXPORT_WIRES:
        path = os.path.join(out_dir, f"stream_{wire}.mlxt")
        t0 = time.perf_counter()
        meta = ex.export_streaming(scfg, state_dict, path, streams=len(streams), chunk_patches=5,
                                   input_dtype=wire, timeline_cap=TIMELINE_CAP)
        export_s = time.perf_counter() - t0
        art = ex.load_exported_streaming(path)
        # wire units (samples, or adpcm bytes) per `per` samples
        unit, per = (1, 1) if wire == "int16" else (adpcm.wire_block_bytes(blk, 4), blk)
        cu = meta.get("wire_length") or meta["chunk_samples"]
        hu = meta["hop_samples"] // per * unit
        silence = (np.zeros(cu, np.int16) if wire == "int16"
                   else np.tile(adpcm.adpcm4_encode(np.zeros(blk, np.int16), block=blk),
                                cu // unit))
        calls = []
        for s in streams:
            w, rows, off = wire_of(s, wire), [], 0
            while off + cu <= len(w):
                rows.append((w[off: off + cu], meta["chunk_patches"]))
                off += hu
            tail = w[off:]  # its whole patches count from the samples, not the padded block
            rows.append((np.concatenate([tail, silence[len(tail):]]),
                         _whole_patches(scfg.frontend, len(s) - off // unit * per)))
            calls.append(rows)
        n_calls = max(len(r) for r in calls)
        state = art.init_state()
        zero_counts()
        call_ms = []
        for k in range(n_calls):
            batch = np.stack([r[k][0] if k < len(r) else silence for r in calls])
            n_valid = np.array([r[k][1] if k < len(r) else 0 for r in calls], np.int32)
            t0 = time.perf_counter()
            state = art.chunk(state, batch, n_valid)
            torch.cuda.synchronize()
            call_ms.append((time.perf_counter() - t0) * 1e3)
        scores = art.finalize(state)
        launches = {"decode": dict(ad.LAUNCHES_BY_VARIANT), "frontend": ff.LAUNCHES}
        want_dec = {"scan": 0, "serial": n_calls if wire == "adpcm4" else 0}
        xsrv = BatchedStreamingServer(xcfg, state_dict, max_streams=len(streams), chunk_patches=5,
                                      transfer_dtype=wire, timeline_cap=TIMELINE_CAP)
        sids = [xsrv.open() for _ in streams]
        for sid, s in zip(sids, streams):  # encoded at feed time to the same wire bytes
            xsrv.feed(sid, s)
        xsrv.drain()
        for sid in sids:
            xsrv.flush(sid)
        live = np.stack([xsrv.scores(sid) for sid in sids])
        score_err = float(np.abs(scores - live).max())
        tl_err = 0.0
        for i, sid in enumerate(sids):
            start, levels = art.timeline(state, i)
            want_start, want_levels = xsrv.timeline(sid)
            if start != want_start or len(levels) != len(want_levels) \
                    or levels[0][0].shape != want_levels[0][0].shape:
                raise RuntimeError(f"export stream {wire}: stream {i} window start {start} / "
                                   f"{want_start}, shapes differ")
            tl_err = max([tl_err] + [float(np.abs(a - b).max()) for lv, wl in
                                     zip(levels, want_levels) for a, b in zip(lv, wl)])
        pallas = pallas_scores[wire][: len(streams)]
        pallas_err = float(np.abs(scores - pallas).max())
        med_ms = statistics.median(call_ms[1:])
        print(f"export streaming, {wire}, {len(streams)} streams x 5 patches, ring "
              f"{TIMELINE_CAP}: export {export_s:.2f} s, {os.path.getsize(path) / 1e6:.2f} MB; "
              f"{n_calls} chunk calls, host ms per call median {med_ms:.4f} (first {call_ms[0]:.2f}); "
              f"scores against the live xla server max |diff| {score_err:.3e}, timelines "
              f"{tl_err:.3e} (budget {EXPORT_SCORE_BUDGET:g}); against the pallas server "
              f"{pallas_err:.3e} (budget {BF16_SCORE_BUDGET:g}); adpcm_decode launches "
              f"{launches['decode']} {tag}")
        if not np.isfinite(scores).all() or score_err > EXPORT_SCORE_BUDGET \
                or tl_err > EXPORT_SCORE_BUDGET or pallas_err > BF16_SCORE_BUDGET:
            raise RuntimeError(f"export stream {wire}: scores {score_err}, timelines {tl_err}, "
                               f"pallas {pallas_err}")
        if launches["decode"] != want_dec or launches["frontend"]:
            raise RuntimeError(f"export stream {wire}: launches {launches}, want decode {want_dec}")
        if wire == "adpcm4":
            dec_paths["export_stream_adpcm4"] = launches["decode"]
        rec["streaming"][wire] = {"export_s": export_s, "bytes": os.path.getsize(path),
                                  "chunk_calls": n_calls, "chunk_host_ms": med_ms,
                                  "chunk_host_ms_all": call_ms, "err_vs_live_xla": score_err,
                                  "timeline_err_vs_live_xla": tl_err,
                                  "err_vs_pallas_server": pallas_err, "launches": launches}
        del xsrv, art

    # a card artifact on the CPU: the move pass carries the program, its
    # weights and its constants
    path = os.path.join(out_dir, "oneshot_small_int16.mlxt")
    ex.export_forward(scfg, state_dict, path, batch=1, seconds=2.0, input_dtype="int16")
    x = pcm16_quantize(streams[0][: 2 * scfg.frontend.sample_rate])[None]
    on_card = ex.load_exported(path)(x)
    t0 = time.perf_counter()
    on_cpu = ex.load_exported(path, device="cpu")(x)
    cpu_s = time.perf_counter() - t0
    cpu_err = float(np.abs(on_cpu - on_card).max())
    print(f"export: a card artifact (int16, 1 x 2 s) loaded with device='cpu' ran in "
          f"{cpu_s:.2f} s, probs finite {bool(np.isfinite(on_cpu).all())}, against the card max "
          f"|diff| {cpu_err:.3e} (bf16 on two devices)")
    if on_cpu.shape != on_card.shape or not np.isfinite(on_cpu).all():
        raise RuntimeError(f"the card artifact on the CPU: {on_cpu}")
    rec["cpu_load"] = {"seconds": cpu_s, "err_vs_card": cpu_err}
    return rec, dec_paths


# the augmented us8k fit: as shipped, cut only in steps, with mixup,
# SpecAugment and the DataLoader pipeline with two workers
AUG_TRAIN_CUT = {"train.num_steps": 10, "train.eval_every": 10, "train.checkpoint_every": 0,
                 "train.log_every": 1, "train.mixup_alpha": 0.5, "train.spec_augment": True,
                 "data.pipeline": "grain", "data.grain_workers": 2}
REMAT_STEPS = 3  # timed flagship train steps per remat setting, after the checked first
SED_CLIPS = 64  # the synthetic_events eval set of the SED phase, 10 s clips


def _train_leftovers(state_dict, fwav, fy, zero_counts, tag):
    """The training leftovers at full width: fit() on us8k_fused_frontend
    with mixup, SpecAugment and the DataLoader pipeline (finite losses, one
    front-end launch per step and eval batch; phase 7 times the
    augmented step against the plain one); the flagship train step with remat_trunk off and on (first-step
    loss within 1e-3, running statistics equal, peak memory and step ms);
    evaluate_sed on a synthetic_events eval set at the streaming preset's
    width. Returns (record, {path: front-end launches})."""
    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.entry import flagship_config
    from mla_tpu_torch.models.zoo import build_model
    from mla_tpu_torch.ops import fused_frontend as ff
    from mla_tpu_torch.train import loop
    from mla_tpu_torch.train.sed_eval import evaluate_sed
    from mla_tpu_torch.train.state import create_train_state, make_train_step

    rec, fe_paths = {}, {}
    acfg = get_config("us8k_fused_frontend", AUG_TRAIN_CUT)
    ws = os.path.join(ROOT, "build", "chip_smoke_train_aug")
    shutil.rmtree(ws, ignore_errors=True)
    zero_counts()
    t0 = time.perf_counter()
    res = loop.fit(acfg, workspace=ws)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts, fe_l = dict(res.counts), ff.LAUNCHES
    losses = [h["loss"] for h in res.history]
    print(f"augmented training (mixup {acfg.train.mixup_alpha}, SpecAugment, DataLoader pipeline "
          f"with {acfg.data.grain_workers} workers): {counts['train_steps']} train steps + "
          f"{counts['eval_batches']} eval batches in {fit_s:.2f} s, fused_log_mel_patches "
          f"launches {fe_l}; losses {losses}")
    if counts["train_steps"] != acfg.train.num_steps or not losses \
            or not np.isfinite(losses).all():
        raise RuntimeError(f"augmented fit: {counts}, losses {losses}")
    if fe_l != counts["train_steps"] + counts["eval_batches"]:
        raise RuntimeError(f"augmented fit: front-end launches {fe_l} for {counts}")
    fe_paths["train_augmented"] = fe_l
    rec["augmented_fit"] = {"counts": counts, "losses": losses, "fit_s": fit_s,
                            "frontend_launches": fe_l}

    # the flagship train step, remat_trunk off and on, from the same weights
    # and batch
    remat = {}
    for on in (False, True):
        c = flagship_config(overrides={"model.remat_trunk": on})
        m = build_model(c.model, seed=SEED)
        st = create_train_state(c, m)
        fstep = make_train_step(c, m, "waveform")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        first = float(fstep(st, fwav, fy)[1])
        stats = {k: v.clone() for k, v in m.state_dict().items() if "running" in k}
        step_ms = _host_median_ms(lambda: fstep(st, fwav, fy), reps=REMAT_STEPS, warmup=0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        remat[on] = {"first_loss": first, "stats": stats, "step_ms_host": step_ms,
                     "peak_memory_gb": peak}
        print(f"flagship train step, remat_trunk={on}, batch {FLAGSHIP_BATCH} x 10 s: first loss "
              f"{first:.6f}; host clock {step_ms:.4f} ms (median of {REMAT_STEPS}); peak memory "
              f"{peak:.2f} GB {tag}")
        del m, st, fstep
    loss_err = abs(remat[True]["first_loss"] - remat[False]["first_loss"])
    stats_diff = max(float((remat[True]["stats"][k] - v).abs().max())
                     for k, v in remat[False]["stats"].items())
    print(f"flagship remat: first-step loss |diff| {loss_err:.3e} (budget {BF16_LOSS_BUDGET:g}); "
          f"running statistics max |diff| {stats_diff:.3e} over {len(remat[False]['stats'])} "
          f"tensors (must be equal)")
    if loss_err > BF16_LOSS_BUDGET or stats_diff != 0.0:
        raise RuntimeError(f"remat against no remat: loss {loss_err}, statistics {stats_diff}")
    rec["remat"] = {str(on).lower(): {k: v for k, v in r.items() if k != "stats"}
                    for on, r in remat.items()}
    rec["remat"].update(first_loss_err=loss_err, stats_max_diff=stats_diff)
    torch.cuda.empty_cache()

    # the SED harness at full width on random weights (no quality claim)
    ecfg = get_config("streaming_inference", {"frontend.impl": "pallas",
                                              "data.dataset": "synthetic_events",
                                              "data.clip_seconds": 10.0,
                                              "data.n_eval_clips": SED_CLIPS})
    zero_counts()
    t0 = time.perf_counter()
    sed = evaluate_sed(ecfg, state_dict, batch_size=32)
    torch.cuda.synchronize()
    sed_s = time.perf_counter() - t0
    fe_l = ff.LAUNCHES
    print(f"SED harness: evaluate_sed on {SED_CLIPS} synthetic_events clips of 10 s, "
          f"{ecfg.model.n_classes} classes, batch 32: {sed_s:.2f} s wall; F1 {sed['f1']:.4f}, "
          f"error rate {sed['error_rate']:.4f}, {sed['n_est_events']} events detected against "
          f"{sed['n_ref_events']}; fused_log_mel_patches launches {fe_l} (random weights: no "
          f"quality claim) {tag}")
    if not all(np.isfinite(sed[k]) for k in ("f1", "error_rate", "precision", "recall")) \
            or sed["n_clips"] != SED_CLIPS or fe_l != 2:
        raise RuntimeError(f"SED harness: {sed}, launches {fe_l}")
    fe_paths["sed_eval"] = fe_l
    rec["sed"] = {**sed, "wall_s": sed_s}
    return rec, fe_paths


# phases 8c and 8d: us8k_fused_frontend as shipped, cut only in steps and
# cadence; 8c with the TensorBoard sink, 8d streamed (not device-resident)
# on the adpcm4 wire, each batch encoded on the host, uploaded and decoded
TB_TRAIN_CUT = {"train.num_steps": 10, "train.eval_every": 10, "train.checkpoint_every": 0,
                "train.log_every": 1, "train.tensorboard": True}
STREAM_TRAIN_CUT = {"train.num_steps": 10, "train.eval_every": 10,
                    "train.checkpoint_every": 0, "train.log_every": 1,
                    "data.device_resident": False, "data.staging_dtype": "adpcm4"}
STREAM_REPS = 10  # streamed and resident steps timed in turns (a streamed step encodes ~0.3 s)


def _module_main(args, timeout):
    """`python -m mla_tpu_torch <args>` from the checkout: (exit code, stdout)."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    r = subprocess.run([sys.executable, "-m", "mla_tpu_torch", *args], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode not in (0, 1):
        raise RuntimeError(f"python -m mla_tpu_torch {' '.join(args)}: exit {r.returncode}\n"
                           f"{r.stderr[-4000:]}")
    return r.returncode, r.stdout


def _doctor_parity_logging(zero_counts, tag):
    """Phases 8a-8d: the doctor verb (a subprocess; no-device, a card other
    than sm_90 or a check that errs fails the phase, degraded is printed
    with its reasons); the parity harness in process on the card (every
    check passes, frontend_pallas through one front-end launch, the caller's TF32
    flags back after it) and the parity verb as a subprocess (exit 0); a
    TensorBoard fit whose event file equals scalars.csv, one front-end launch per
    step and eval batch; a streamed adpcm4 fit, one scan decode and one front-end
    launch per step, then its step in turns with the resident adpcm4 step
    (host ms, profiles, idle share). Returns (record, {path: front-end
    launches}, {path: decode launches by variant})."""
    from mla_tpu_torch import _device, parity
    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.data import adpcm, native
    from mla_tpu_torch.data.audio_io import pcm16_quantize
    from mla_tpu_torch.data.ooc import take_rows
    from mla_tpu_torch.data.sampler import BalancedSampler
    from mla_tpu_torch.data.synthetic import make_dataset
    from mla_tpu_torch.ops import adpcm as ad
    from mla_tpu_torch.ops import fused_frontend as ff
    from mla_tpu_torch.train import loop
    from mla_tpu_torch.train.state import make_train_step

    rec, fe_paths, dec_paths = {}, {}, {}

    # 8a. the doctor
    t0 = time.perf_counter()
    rc, out = _module_main(["doctor"], timeout=600)
    report = json.loads(out.strip().splitlines()[-1])
    verdict = report["verdict"]
    print(f"doctor: exit {rc}, verdict {verdict['status']} in {time.perf_counter() - t0:.1f} s; "
          f"reasons {verdict['reasons']}")
    print(f"doctor: devices {report['devices']}; versions {report.get('versions')}")
    for key in ("fetch_rtt", "synchronize", "compile", "matmul_precision", "gemm"):
        print(f"doctor: {key} {json.dumps(report.get(key))}")
    caps = [tuple(d.get("capability", ())) for d in report["devices"]]
    errors = [k for k, v in report.items() if isinstance(v, dict) and "error" in v]
    if verdict["status"] == "no-device" or caps[:1] != [(9, 0)] or errors \
            or not report["compile"]["builds_ok"]:
        raise RuntimeError(f"doctor: {verdict}, capabilities {caps}, checks in error {errors}, "
                           f"builds {report['compile'].get('builds')}")
    gemm = report["gemm"]
    print(f"doctor: f32 GEMM {gemm['n']}^3 x {gemm['iters']} at the default flags: "
          f"{gemm['tflops']:.4f} TFLOP/s, repeat spread {gemm['rel_spread']:.4f} (times "
          f"{gemm['times_s']} s); fetch RTT median {report['fetch_rtt']['median_ms']:.4f} ms "
          f"{tag}")
    rec["doctor"] = {"exit": rc, **report}

    # 8b. the parity harness: in process on the card, then the verb. The
    # caller's TF32 flags (set on here) must read the same after it.
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    flags = _device.tf32_flags()
    zero_counts()
    t0 = time.perf_counter()
    results = parity.run_all()
    torch.cuda.synchronize()
    parity_s = time.perf_counter() - t0
    fe_l = ff.LAUNCHES
    after = _device.tf32_flags()
    torch.set_float32_matmul_precision("highest")  # back to the script's own setting
    torch.backends.cudnn.allow_tf32 = False
    for r in results:
        print(f"parity: {json.dumps(r)}")
    failed = [r for r in results if r["pass"] is False]
    skipped = [r["check"] for r in results if r["pass"] is None]
    print(f"parity: {len(results)} checks in {parity_s:.2f} s, skipped {skipped}; "
          f"fused_log_mel_patches launches {fe_l}; TF32 flags before {flags}, after {after} "
          f"{tag}")
    if failed or fe_l != 1 or after != flags:
        raise RuntimeError(f"parity: failed {failed}, launches {fe_l}, flags {flags} -> {after}")
    fe_paths["parity"] = fe_l
    rc, out = _module_main(["parity"], timeout=600)
    print(f"parity verb: exit {rc}")
    for line in out.strip().splitlines():
        print(f"parity verb: {line}")
    if rc != 0:
        raise RuntimeError(f"the parity verb exited {rc}")
    rec["parity"] = {"results": results, "s": parity_s, "skipped": skipped,
                     "tf32_before": flags, "tf32_after": after, "verb_exit": rc}

    # 8c. fit with the TensorBoard sink: the event file against scalars.csv
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    tcfg = get_config("us8k_fused_frontend", TB_TRAIN_CUT)
    ws = os.path.join(ROOT, "build", "chip_smoke_train_tb")
    shutil.rmtree(ws, ignore_errors=True)
    zero_counts()
    res = loop.fit(tcfg, workspace=ws)
    torch.cuda.synchronize()
    counts, fe_l = dict(res.counts), ff.LAUNCHES
    with open(os.path.join(ws, "scalars.csv"), newline="") as fh:
        rows = list(csv.DictReader(fh))
    want = {}
    for r in rows:
        want.setdefault(r["key"], []).append((int(r["step"]),
                                              float(np.float32(float(r["value"])))))
    ea = EventAccumulator(os.path.join(ws, "tensorboard", tcfg.name), size_guidance={"scalars": 0})
    ea.Reload()
    got = {t: [(e.step, float(np.float32(e.value))) for e in ea.Scalars(t)]
           for t in ea.Tags()["scalars"]}
    print(f"TensorBoard fit: {counts['train_steps']} train steps + {counts['eval_batches']} "
          f"eval batches, fused_log_mel_patches launches {fe_l}; event file tags "
          f"{sorted(got)}, {sum(len(v) for v in got.values())} scalars against "
          f"{len(rows)} CSV rows; losses {[h['loss'] for h in res.history]}")
    if got != want or not rows:
        raise RuntimeError(f"TensorBoard events differ from scalars.csv: {got} against {want}")
    if counts["train_steps"] != tcfg.train.num_steps \
            or fe_l != counts["train_steps"] + counts["eval_batches"]:
        raise RuntimeError(f"TensorBoard fit: {counts}, launches {fe_l}")
    fe_paths["train_tensorboard"] = fe_l
    rec["tensorboard_fit"] = {"counts": counts, "frontend_launches": fe_l,
                              "tags": sorted(got), "scalars": sum(len(v) for v in got.values())}

    # 8d. the streamed adpcm4 feed: what an out-of-core set puts on the card
    scfg = get_config("us8k_fused_frontend", STREAM_TRAIN_CUT)
    ws = os.path.join(ROOT, "build", "chip_smoke_train_streamed")
    shutil.rmtree(ws, ignore_errors=True)
    zero_counts()
    native_before = dict(native.CALLS)
    t0 = time.perf_counter()
    res = loop.fit(scfg, workspace=ws)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts, fe_l, dec_l = dict(res.counts), ff.LAUNCHES, \
        dict(ad.LAUNCHES_BY_VARIANT)
    native_encodes = native.CALLS["adpcm4_encode"] - native_before["adpcm4_encode"]
    losses = [h["loss"] for h in res.history]
    picked = ad.decode_variant(4, adpcm.DEFAULT_BLOCK)
    print(f"streamed adpcm4 fit: {counts['train_steps']} train steps + {counts['eval_batches']} "
          f"eval batches in {fit_s:.2f} s, adpcm_decode launches {dec_l}, fused_log_mel_patches "
          f"launches {fe_l}, native adpcm4 encodes {native_encodes}; losses {losses}")
    if counts["train_steps"] != scfg.train.num_steps or not np.isfinite(losses).all() \
            or dec_l != {**dict.fromkeys(("scan", "serial"), 0), picked: counts["train_steps"]} \
            or fe_l != counts["train_steps"] + counts["eval_batches"]:
        raise RuntimeError(f"streamed adpcm4 fit: {counts}, decode {dec_l}, front-end {fe_l}, "
                           f"losses {losses}")
    # the host encoder is the native library's (phase 9f holds it bit-exact
    # against numpy): one call per streamed batch, none falling back unseen
    if native_encodes != counts["train_steps"]:
        raise RuntimeError(f"streamed adpcm4 fit: {native_encodes} native encodes for "
                           f"{counts['train_steps']} steps")
    fe_paths["train_streamed_adpcm4"] = fe_l
    dec_paths["train_streamed_adpcm4"] = dec_l
    # its step in turns with the resident adpcm4 step phase 6 runs: the same
    # batch, streamed (gather on the host, encode, upload) or gathered from
    # the wire staged on the card
    ds = make_dataset(scfg.data, scfg.model.n_classes, "train", "waveform")
    idx = BalancedSampler(ds.y, scfg.train.batch_size, scfg.train.seed).next_batch()
    wire_all = torch.from_numpy(loop._encode(ds.x, "adpcm4")).cuda()
    idx_t = torch.from_numpy(np.asarray(idx, np.int64)).cuda()
    y = torch.from_numpy(np.asarray(ds.y[idx], np.float32)).cuda()
    state = res.state
    step = make_train_step(scfg, state.model, "waveform", clip_samples=ds.x.shape[1])

    def streamed():  # the fit's feed: the native encoder
        x = torch.from_numpy(loop._encode(take_rows(ds, idx), "adpcm4")).cuda()
        step(state, x, y)

    def numpy_encode():  # the numpy encoder, the streamed feed before the native one
        return adpcm.numpy_encode(pcm16_quantize(take_rows(ds, idx)), adpcm.DEFAULT_BLOCK, 4)

    def streamed_numpy():
        step(state, torch.from_numpy(numpy_encode()).cuda(), y)

    def resident():
        step(state, wire_all.index_select(0, idx_t), y)

    if not np.array_equal(loop._encode(take_rows(ds, idx), "adpcm4"), numpy_encode()):
        raise RuntimeError("streamed adpcm4 batch: the native wire differs from numpy's")
    feeds = {"streamed": streamed, "streamed_numpy": streamed_numpy, "resident": resident}
    turns, _ = _in_turns(feeds, reps=STREAM_REPS, warmup=2)
    n_prof = 5
    profs = {k: _report_profile(f"{k} adpcm4 train step", n_prof, turns[k],
                                _profile(fn, n_prof), tag) for k, fn in feeds.items()}
    encode_ms = _host_median_ms(lambda: loop._encode(take_rows(ds, idx), "adpcm4"),
                                reps=STREAM_REPS, warmup=1)
    encode_numpy_ms = _host_median_ms(numpy_encode, reps=STREAM_REPS, warmup=1)
    print(f"time: adpcm4 train step, batch {scfg.train.batch_size} x {ds.x.shape[1]} samples, "
          f"host clock in turns ({STREAM_REPS} each): streamed {turns['streamed']:.4f} ms "
          f"(host gather + native encode alone {encode_ms:.4f} ms), streamed on the numpy "
          f"encoder {turns['streamed_numpy']:.4f} ms (gather + encode {encode_numpy_ms:.4f} "
          f"ms), resident {turns['resident']:.4f} ms; device busy "
          f"{profs['streamed']['device_busy_ms']} / {profs['streamed_numpy']['device_busy_ms']} "
          f"/ {profs['resident']['device_busy_ms']} ms; idle share "
          f"{profs['streamed']['idle_share']} / {profs['streamed_numpy']['idle_share']} / "
          f"{profs['resident']['idle_share']} {tag}")
    rec["streamed_adpcm4"] = {"counts": counts, "fit_s": fit_s, "losses": losses,
                              "decode_launches": dec_l, "frontend_launches": fe_l,
                              "native_encodes": native_encodes, "turns_ms": turns,
                              "encode_ms": encode_ms, "encode_numpy_ms": encode_numpy_ms,
                              "profiles": profs}
    del wire_all, state, step
    torch.cuda.empty_cache()
    return rec, fe_paths, dec_paths


# phase 9: the checkpoint verbs and the host ingest library
VERBS_DIR = os.path.join(ROOT, "build", "chip_smoke_verbs")
INFER_SECONDS = 30  # the infer verb's clip, written with scipy from a seeded generator
DIR_CLIPS = {"a.wav": 4.0, "sub/b.wav": 12.5, "sub/c.wav": 0.7}  # --wav_dir, three lengths
VERB_TIMEOUT_S = 600
NATIVE_CASES = ((64, 64000, 256), (8, 77120, 64))  # the training and serving sites


def _module_jobs(jobs: dict) -> dict:
    """Every job at once, each a list of `python -m mla_tpu_torch <args>`
    commands run in order from the checkout: {name: [stdout per command]};
    an exit other than 0 raises."""
    env = {**os.environ, "PYTHONPATH": ROOT}

    def run(commands):
        outs = []
        for args in commands:
            r = subprocess.run([sys.executable, "-m", "mla_tpu_torch", *args], cwd=ROOT,
                               env=env, capture_output=True, text=True,
                               timeout=VERB_TIMEOUT_S)
            if r.returncode != 0:
                raise RuntimeError(f"python -m mla_tpu_torch {' '.join(args)}: exit "
                                   f"{r.returncode}\n{r.stderr[-4000:]}")
            outs.append(r.stdout)
        return outs

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(run, commands) for k, commands in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def _verb_in_process(argv) -> str:
    """One verb through the port's CLI in this process: its stdout."""
    from mla_tpu_torch.__main__ import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    if rc:
        raise RuntimeError(f"mla_tpu_torch {' '.join(argv)}: exit {rc}")
    return buf.getvalue()


def _checkpoint_verbs(serve_state_dict, packages, train_step_ms, zero_counts, tag):
    """Phase 9: the checkpoint verbs on the card as subprocesses, beside the
    same work in process (launch counts read there), and the native ingest
    library against numpy and scipy. Returns (record, {path: front-end
    launches})."""
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.data import adpcm, audio_io, native
    from mla_tpu_torch.data.labels import labels_for
    from mla_tpu_torch.models.convert import state_dict_to_flat
    from mla_tpu_torch.models.zoo import AudioTagger
    from mla_tpu_torch.ops import fused_frontend as ff
    from mla_tpu_torch.ops.frontend import apply_frontend, waveform_to_patches
    from mla_tpu_torch.serve import streaming
    from mla_tpu_torch.train import loop

    rec, fe_paths = {}, {}
    t_phase = time.perf_counter()
    shutil.rmtree(VERBS_DIR, ignore_errors=True)
    os.makedirs(VERBS_DIR)

    def d(rel):
        return os.path.join(VERBS_DIR, rel)

    def frontend_launches(path, n):
        fe_l = ff.LAUNCHES
        if fe_l != n:
            raise RuntimeError(f"{path}: front-end launches {fe_l}, want {n}")
        fe_paths[path] = fe_l
        return fe_l

    print("phase 9: not run on the card: prep, infer --plot and the AudioSet packer "
          f"(h5py {packages.get('h5py')}, matplotlib {packages.get('matplotlib')}, tensorflow "
          f"{packages.get('tensorflow')} on this machine); the CPU tests hold them against JAX")

    # the serving weights of phase 5 as a step-0 checkpoint of a streaming
    # workspace (weights --load, in process: host work only), and the clips
    us8k = ["--config", "us8k_fused_frontend"]
    train_ws = os.path.join(ROOT, "build", "chip_smoke_train")
    sws, snpz = d("ws_streaming"), d("streaming.npz")
    np.savez(snpz, **state_dict_to_flat(serve_state_dict))
    print(f"weights --load (in process): "
          f"{_verb_in_process(['weights', '--workspace', sws, '--load', snpz]).strip()}")
    icfg = get_config("streaming_inference", {"frontend.impl": "pallas"})
    pallas = ["--workspace", sws, "--set", "frontend.impl=pallas"]
    rng = np.random.default_rng(SEED + 9)
    sr = icfg.frontend.sample_rate
    t = np.arange(INFER_SECONDS * sr) / sr
    wav = (0.05 * rng.standard_normal(t.shape) + 0.4 * np.sin(2 * np.pi * 700 * t)
           * ((t % 8) < 4)).astype(np.float32)
    clip = d("clip30.wav")
    wavfile.write(clip, sr, audio_io.pcm16_quantize(wav))
    for rel, secs in DIR_CLIPS.items():
        os.makedirs(os.path.dirname(d(f"clips/{rel}")), exist_ok=True)
        wavfile.write(d(f"clips/{rel}"), sr, audio_io.pcm16_quantize(
            0.3 * rng.standard_normal(int(secs * sr)).astype(np.float32)))
    wav = audio_io.load_wav_16k(clip, sr)  # what the verbs read

    def tl_flags(k):
        return ["--timeline", d(f"{k}.csv"), "--events", d(f"{k}.json")]

    loaded_ws = d("ws_loaded")
    jobs = {  # the round trip's two commands in turn, beside the other verbs
        "weights": [["weights", *us8k, "--workspace", train_ws, "--out", d("us8k.npz")],
                    ["weights", *us8k, "--workspace", loaded_ws, "--load", d("us8k.npz")]],
        "eval_trained": [["eval", *us8k, "--workspace", train_ws]],
        "eval_flags": [["eval", *us8k, "--workspace", train_ws, "--per_class", d("pc.csv"),
                        "--calibrate", d("thr.json"), "--events", "--sweep"]],
        "infer": [["infer", "--wav", clip, *tl_flags("one_shot"), *pallas]],
        "infer_stream": [["infer", "--wav", clip, "--stream", *tl_flags("stream"), *pallas]],
        "infer_dir": [["infer", "--wav_dir", d("clips"), "--timeline", d("tl_dir"),
                       "--events", d("dir.json"), *pallas]],
        "embed": [["embed", "--wav", clip, "--out", d("emb.npy"), *pallas]],
        "extract": [["extract", "--wav", clip, "--out", d("patches.npy"), "--config",
                     "streaming_inference"]],
        "summary": [["summary", "--config", "streaming_inference"]],
        "configs": [["configs"]],
    }
    t0 = time.perf_counter()
    outs = _module_jobs(jobs)
    out = {k: v[-1] for k, v in outs.items()}
    verbs_s = {"verbs at once": time.perf_counter() - t0}
    print(f"phase 9: {sum(map(len, jobs.values()))} verb commands as subprocesses, "
          f"{len(jobs)} at once, in {verbs_s['verbs at once']:.1f} s")

    # 9a. the weights round trip, then eval on the loaded workspace alone
    t0 = time.perf_counter()
    out_e = _module_jobs({"eval": [["eval", *us8k, "--workspace", loaded_ws]]})["eval"][0]
    verbs_s["eval on the loaded workspace"] = time.perf_counter() - t0
    out_w, out_l = outs["weights"]
    print(f"weights --out: {out_w.strip()}")
    restored, _ = loop.resume(get_config("us8k_fused_frontend"), train_ws, device="cpu")
    want = state_dict_to_flat(restored.model.state_dict())
    with np.load(d("us8k.npz")) as z:
        got = {k: z[k] for k in z.files}
    if set(got) != set(want) or any(not np.array_equal(got[k], want[k]) for k in want):
        raise RuntimeError(f"weights --out: keys {sorted(set(got) ^ set(want))} differ from "
                           "state_dict_to_flat, or an array differs")
    print(f"weights --load: {out_l.strip()}")
    print(f"eval (trained workspace): {out['eval_trained'].strip()}")
    print(f"eval (loaded workspace):  {out_e.strip()}")
    if out["eval_trained"] != out_e:
        raise RuntimeError("eval prints other stats after the weights round trip")
    ecfg = get_config("us8k_fused_frontend")
    zero_counts()
    line = _verb_in_process(["eval", *us8k, "--workspace", loaded_ws])
    torch.cuda.synchronize()
    n_batches = -(-ecfg.data.n_eval_clips // ecfg.train.batch_size)
    fe_l = frontend_launches("eval_verb", n_batches)
    print(f"eval (in process): {n_batches} eval batches, fused_log_mel_patches launches {fe_l}")
    if line != out_e:
        raise RuntimeError(f"eval in process {line!r} against the verb's {out_e!r}")
    rec["weights_eval"] = {"npz_arrays": len(got), "stats": json.loads(line),
                           "launches": fe_l}

    # 9b. eval's output flags
    stats = json.loads(out["eval_flags"].strip().splitlines()[-1])
    with open(d("pc.csv"), newline="") as fh:
        rows = list(csv.reader(fh))
    with open(d("thr.json")) as fh:
        thr = json.load(fh)
    names_u = labels_for(ecfg.data.dataset, ecfg.model.n_classes)
    print(f"eval --per_class --calibrate --events --sweep: mAP {stats['mAP']}, events "
          f"{json.dumps(stats.get('events'))}, best swept threshold "
          f"{json.dumps((stats.get('events_sweep') or {}).get('best'))}; {len(rows) - 1} CSV "
          f"rows, {len(thr['thresholds'])} thresholds")
    if len(rows) != 1 + ecfg.model.n_classes or list(thr["thresholds"]) != names_u \
            or "events" not in stats or "events_sweep" not in stats:
        raise RuntimeError(f"eval flags: {len(rows)} CSV rows, thresholds {thr}, keys "
                           f"{sorted(stats)}")
    rec["eval_flags"] = {"stats": stats, "csv_rows": len(rows) - 1, "thresholds": thr}

    # 9c. infer: the verb's top-k against tag_clip / StreamingTagger in
    # process, bit-equal; the same runs through the CLI in process with the
    # device steps counted
    names = labels_for(icfg.data.dataset, icfg.model.n_classes)

    def top_k(scores, k=5):
        return [[names[i], float(scores[i])] for i in np.argsort(-scores)[:k]]

    def fed(tagger, block):
        for s in range(0, len(wav), block):
            tagger.feed(wav[s: s + block])
        tagger.flush()
        return tagger.scores()

    want_one = top_k(streaming.tag_clip(icfg, serve_state_dict, wav))
    want_stream = top_k(fed(streaming.StreamingTagger(icfg, serve_state_dict, timeline_cap=256),
                            sr))
    folds = [0]
    fold = streaming.StreamingTagger._fold

    def counted(self, x):
        folds[0] += 1
        return fold(self, x)

    streaming.StreamingTagger._fold = counted
    infer_rec = {}
    try:
        for path, want in (("infer", want_one), ("infer_stream", want_stream),
                           ("infer_dir", None)):
            (argv,) = jobs[path]
            got_sub = [json.loads(ln) for ln in out[path].strip().splitlines()]
            folds[0] = 0
            zero_counts()
            got_in = [json.loads(ln) for ln in _verb_in_process(argv).strip().splitlines()]
            torch.cuda.synchronize()
            steps = folds[0] + (2 if path == "infer" else 0)  # tag_clip + the timeline forward
            fe_l = frontend_launches(path, steps)
            print(f"{path}: {json.dumps(got_sub[-1])[:300]}; {steps} device steps, "
                  f"fused_log_mel_patches launches {fe_l}")
            if got_in != got_sub:
                raise RuntimeError(f"{path}: in process {got_in} against the verb's {got_sub}")
            if want is not None and got_sub[-1]["top_k"] != want:
                raise RuntimeError(f"{path}: the verb's top-k {got_sub[-1]['top_k']} against "
                                   f"{want} in process")
            if path == "infer_dir" and len(got_sub) != len(DIR_CLIPS):
                raise RuntimeError(f"infer --wav_dir: {len(got_sub)} lines for {len(DIR_CLIPS)}")
            infer_rec[path] = {"lines": got_sub, "device_steps": steps, "launches": fe_l}
    finally:
        streaming.StreamingTagger._fold = fold
    for k in ("one_shot", "stream"):
        with open(d(f"{k}.json")) as fh:
            infer_rec[f"{k}_events"] = len(json.load(fh)["events"])
    print(f"infer: events {infer_rec['one_shot_events']} one-shot, {infer_rec['stream_events']} "
          f"streamed")
    rec["infer"] = infer_rec

    # 9d. embed, extract, summary, configs
    model = streaming._model_with_weights(icfg, serve_state_dict, torch.device("cuda"))
    x = torch.from_numpy(wav)[None].cuda()
    with torch.inference_mode():
        want_emb = model.embed(apply_frontend(x, icfg.frontend))[0].float().cpu().numpy()
        want_patches = waveform_to_patches(x[0], icfg.frontend).cpu().numpy()
    emb = np.load(d("emb.npy"))
    zero_counts()
    _verb_in_process(["embed", "--wav", clip, "--out", d("emb_in.npy"), *pallas])
    torch.cuda.synchronize()
    fe_l = frontend_launches("embed", 1)
    patches = np.load(d("patches.npy"))
    print(f"embed: {out['embed'].strip()}, bit-equal to AudioTagger.embed(apply_frontend(...)): "
          f"{np.array_equal(emb, want_emb)}, in process {fe_l}; extract: "
          f"{out['extract'].strip()}, bit-equal to waveform_to_patches: "
          f"{np.array_equal(patches, want_patches)}")
    if not (np.array_equal(emb, want_emb) and np.array_equal(np.load(d("emb_in.npy")), emb)
            and np.array_equal(patches, want_patches)):
        raise RuntimeError("embed or extract differs from its in-process computation")
    with torch.device("meta"):
        n_params = sum(p.numel() for p in AudioTagger(icfg.model).parameters())
    summary = out["summary"]
    total = [ln for ln in summary.splitlines() if ln.startswith("TOTAL params")]
    print(f"summary: {total} ({n_params:,} parameters in the model); configs: "
          f"{out['configs'].split()}")
    if summary != _verb_in_process(["summary", "--config", "streaming_inference"]) \
            or out["configs"] != _verb_in_process(["configs"]) \
            or not total or int(total[0].split()[-1].replace(",", "")) != n_params:
        raise RuntimeError("summary or configs differ from their in-process text")
    rec["embed_extract_summary"] = {"embed_shape": list(emb.shape),
                                    "patches_shape": list(patches.shape), "params": n_params}

    # 9e. profile, alone on the card
    t0 = time.perf_counter()
    prof_out = _module_jobs({"profile": [["profile", *us8k, "--steps", "3", "--out",
                                          d("trace")]]})["profile"][0]
    verbs_s["profile"] = time.perf_counter() - t0
    prof = json.loads(prof_out.strip().splitlines()[-1])
    traces = sorted(f for f in os.listdir(d("trace")) if f.endswith(".json"))
    with open(d(f"trace/{traces[-1]}")) as fh:
        n_events = len(json.load(fh)["traceEvents"])
    print(f"profile: mean_step_ms {prof['mean_step_ms']} over {prof['steps']} traced steps at "
          f"batch {prof['batch']} ({prof['clips_per_sec']} clips/s; the untraced us8k step of "
          f"phase 7: {train_step_ms:.4f} ms); trace {traces[-1]} with {n_events} events; "
          f"memory keys {len(prof['memory'])}, peak allocated "
          f"{prof['memory'].get('allocated_bytes.all.peak')} B {tag}")
    if set(prof) != {"trace_dir", "steps", "batch", "mean_step_ms", "clips_per_sec", "memory"} \
            or not traces or not n_events or not prof["memory"]:
        raise RuntimeError(f"profile: {prof}, traces {traces}")
    rec["profile"] = {**prof, "trace_events": n_events, "phase7_step_ms": train_step_ms}

    # 9f. the native ingest library against numpy and scipy, host ms each
    if not native.available():
        raise RuntimeError("data/native.py: the library is not available on this machine")
    codec_rec = {}
    for rows, n, block in NATIVE_CASES:
        pcm = audio_io.pcm16_quantize(
            np.clip(rng.standard_normal((rows, n)) * 0.2, -1, 1).astype(np.float32))
        for bits in (4, 2):
            enc = native.adpcm4_encode if bits == 4 else native.adpcm2_encode
            key = f"adpcm{bits} [{rows}, {n}] block {block}"
            if not np.array_equal(enc(pcm, block), adpcm.numpy_encode(pcm, block, bits)):
                raise RuntimeError(f"{key}: the native wire differs from numpy's")
            codec_rec[key] = {
                "native_ms": _host_median_ms(lambda: enc(pcm, block)),
                "numpy_ms": _host_median_ms(lambda: adpcm.numpy_encode(pcm, block, bits),
                                            reps=5, warmup=1)}
            print(f"native {key}: bit-exact against numpy; host ms native "
                  f"{codec_rec[key]['native_ms']:.4f}, numpy {codec_rec[key]['numpy_ms']:.4f} "
                  f"(medians) {tag}")
    sr_in = 44100
    x44 = (0.3 * rng.standard_normal(10 * sr_in)).astype(np.float32)
    bio = io.BytesIO()
    wavfile.write(bio, sr_in, audio_io.pcm16_quantize(x44))
    raw = bio.getvalue()
    dec, got_sr = native.wav_decode(raw)
    _, pcm44 = wavfile.read(io.BytesIO(raw))
    dec_err = float(np.abs(dec - audio_io._pcm_to_float_mono(pcm44)).max())
    res16 = native.resample(dec, sr_in, sr)
    want16 = resample_poly(dec, 160, 441).astype(np.float32)
    res_err = float(np.abs(res16 - want16).max()) if res16.shape == want16.shape else np.inf
    wav_ms = {"decode_native_ms": _host_median_ms(lambda: native.wav_decode(raw)),
              "decode_scipy_ms": _host_median_ms(
                  lambda: audio_io._pcm_to_float_mono(wavfile.read(io.BytesIO(raw))[1])),
              "resample_native_ms": _host_median_ms(lambda: native.resample(dec, sr_in, sr)),
              "resample_scipy_ms": _host_median_ms(lambda: resample_poly(dec, 160, 441))}
    print(f"native wav_decode (10 s at 44.1 kHz int16): max |err| against scipy {dec_err:.3e}; "
          f"resample 44.1 -> 16 kHz: max |err| against resample_poly {res_err:.3e}; host ms "
          f"{json.dumps(wav_ms)} {tag}")
    if got_sr != sr_in or dec_err > 1e-6 or res_err > 1e-6:
        raise RuntimeError(f"native wav: rate {got_sr}, decode err {dec_err}, resample "
                           f"err {res_err}")
    rec["native"] = {"codecs": codec_rec, "wav_decode_err": dec_err, "resample_err": res_err,
                     **wav_ms, "calls": dict(native.CALLS)}
    rec["verbs_s"] = verbs_s
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 9: {rec['phase_s']:.1f} s (subprocess groups {json.dumps(verbs_s)})")
    return rec, fe_paths


# phase 10: parallelism on the one card (the card's machine has one device,
# so every mesh names it more than once and the data-parallel ranks share it)
PAR_TOL = dict(rtol=1e-4, atol=1e-5)  # sharded against unsharded, f32 (dryrun_multichip's)
PAR_CLIP_S = 60.0  # the context-parallel clip: 62 patches, not a multiple of 4
PAR_TIME_SHARDS = 4
DP_TIMEOUT_S = 600  # each torch.distributed.run launch
DP_US8K_STEPS = 3  # 10d: us8k in f32, 2 x 32 against 1 x 64
# us8k in f32. At full width a one-ulp change of the forward (here: the
# global batch-norm moments summed over two ranks instead of taken over one
# batch) moves the gradients of the deep convolutions by several 1e-3 of the
# tensor's largest: max pooling's argmax and ReLU's boundary flip where two
# values tie within an ulp. A one-process control shows the size of that
# alone: the same step on its input scaled by 1 + 2^-23. So the full width is
# held against that control (no further from the one-process gradients than
# the one-ulp input is, with a factor of 2), and the data-
# parallel arithmetic at the CPU test's widths and tolerance
# (tests/test_torch_dp.py): gradients within 1e-7 + GRAD_RTOL x the tensor's
# largest, parameters within 1e-5 where the gradient is more than twice that
# from 0 (its sign, and so Adam's first step, certain). Over 3 steps Adam
# carries such flips into the weights (~lr each), so there the losses are held.
DP_F32_LOSS_RTOL = 1e-3
ULP_SCALE = 1.0 + 2.0 ** -23  # the control's one-ulp change of the input
NARROW = {"model.conv_channels": "8,16", "model.convs_per_stage": 1,
          "model.embed_dim": 32, "model.hidden_units": 64}  # tests/test_torch_dp.py's
GRAD_RTOL = 2e-4  # of the tensor's largest gradient, + 1e-7
DECIDED_GRAD = 1e-6  # 100 x Adam's eps: above it the gradient decides the step
DP_FLAGSHIP = {"data.n_train_clips": 256, "data.n_eval_clips": 64, "train.num_steps": 3,
               "train.eval_every": 1000, "train.checkpoint_every": 0, "train.log_every": 1}
DP_FLAGSHIP_LOSS_RTOL = 1e-3  # bf16, 2 x 128 against 1 x 256: cuDNN's picks differ per batch
DP_STEP_REPS = 5  # timed flagship steps per process, after fit's three


def _dp_runs(ws):
    """What the data-parallel launches run: (name, config, overrides, f32 with
    TF32 off)."""
    us8k = {"model.compute_dtype": "float32", "train.eval_every": 1000,
            "train.checkpoint_every": 0, "train.log_every": 1}
    return [("us8k_f32", "us8k_fused_frontend", {**us8k, "train.num_steps": DP_US8K_STEPS},
             True),
            ("us8k_f32_step1", "us8k_fused_frontend", {**us8k, "train.num_steps": 1}, True),
            ("us8k_f32_narrow_step1", "us8k_fused_frontend",
             {**us8k, **NARROW, "train.num_steps": 1}, True),
            ("flagship", "audioset_full_dp", DP_FLAGSHIP, False)]


def _dp_fit(name, preset, overrides, f32, ws, dp_timing: bool):
    """One fit in this process (a rank or the single process): losses,
    counts, front-end launches, the final parameters' and the last step's
    gradients' path (Adam's first moment over 1 - beta1, exact after one
    step), peak memory, and for the flagship the step timed on the host
    clock and profiled."""
    from mla_tpu_torch._device import tf32_off
    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.ops import fused_frontend as ff
    from mla_tpu_torch.parallel import distributed, tensor
    from mla_tpu_torch.train import loop
    from mla_tpu_torch.train.state import make_train_step

    cfg = get_config(preset, overrides)
    rank = distributed.process_index()
    ff.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    with tf32_off() if f32 else contextlib.nullcontext():
        res = loop.fit(cfg, workspace=os.path.join(ws, name), log=False)
        torch.cuda.synchronize()
        rec = {"losses": [h["loss"] for h in res.history], "counts": dict(res.counts),
               "launches": ff.LAUNCHES,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        params = os.path.join(ws, f"{name}.params.rank{rank}.pt")
        model, opt = res.state.model, res.state.optimizer
        # whole tensors: a tensor-parallel rank gathers its shards over "model"
        grads = tensor.gather_named(model, {
            n: opt.state[p]["exp_avg"] / (1 - opt.defaults["betas"][0])
            for n, p in model.named_parameters()}) if f32 else {}
        torch.save({"params": {k: v.cpu() for k, v in tensor.full_state_dict(model).items()},
                    "grads": {k: v.cpu() for k, v in grads.items()}}, params)
        rec["params"] = params
        rec["lr"] = cfg.train.learning_rate
        if dp_timing:
            # the step on a seeded random batch (this rank's rows), timed and profiled
            dev = next(res.state.model.parameters()).device
            dp = loop.data_parallel(cfg, dev)
            rows = slice(None) if dp is None else dp.rows
            g = torch.Generator(device=dev).manual_seed(SEED)
            n = int(cfg.data.clip_seconds * cfg.frontend.sample_rate)
            x = (0.1 * torch.randn((cfg.train.batch_size, n), generator=g, device=dev))[rows]
            y = (torch.rand((cfg.train.batch_size, cfg.model.n_classes), generator=g,
                            device=dev) < 0.05).float()[rows]
            step = make_train_step(cfg, res.state.model, "waveform", clip_samples=x.shape[1],
                                   dp=dp)
            state = res.state
            times = []
            for _ in range(DP_STEP_REPS):
                t0 = time.perf_counter()
                state, _ = step(state, x, y)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            _, busy, top, _, _ = _profile(lambda: step(state, x, y), 3)
            rec["step_ms"] = statistics.median(times)
            rec["step_times_ms"] = times
            rec["device_busy_ms"] = busy
            # this process's device busy against its unprofiled step (a rank's
            # idle share includes the time the card runs the other rank's work)
            rec["idle_share"] = None if busy is None else max(0.0, 1.0 - busy / rec["step_ms"])
            rec["top_ms"] = top[:8]
            if tensor.layout_of(model) is not None:
                rec["collectives"] = _collectives_per_step(lambda: step(state, x, y))
        del res, model, opt
    torch.cuda.empty_cache()
    return rec


def _collectives_per_step(step_fn, reps: int = DP_STEP_REPS) -> dict:
    """Every ``torch.distributed.all_reduce`` of ``reps`` calls of
    ``step_fn`` (a train step) timed on the host clock, the card
    synchronized before and after each (gloo stages CUDA tensors through
    the host): calls and ms per step. The wrapper is removed after."""
    import torch.distributed as dist

    orig, acc = dist.all_reduce, {"calls": 0, "ms": 0.0, "mb": 0.0}

    def timed(t, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(t, *a, **k)
        torch.cuda.synchronize()
        acc["ms"] += (time.perf_counter() - t0) * 1e3
        acc["calls"] += 1
        acc["mb"] += t.numel() * t.element_size() / 1e6
        return out

    dist.all_reduce = timed
    try:
        for _ in range(reps):
            step_fn()
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = orig
    return {k: v / reps for k, v in acc.items()}


def _dp_worker(job_path):
    """One rank of a phase-10 data-parallel or phase-11 tensor-parallel
    launch: the group over gloo (ranks sharing one card) or NCCL, each
    run's fit, a JSON record per rank."""
    sys.path.insert(0, ROOT)
    from mla_tpu_torch.parallel import distributed

    with open(job_path) as fh:
        job = json.load(fh)
    if not distributed.initialize(backend=job["backend"]):
        raise RuntimeError("no process group: run under torch.distributed.run")
    rank = distributed.process_index()
    out = {"rank": rank, "world": distributed.process_count(),
           "device": str(torch.cuda.current_device())}
    runs = _dp_runs(job["ws"]) if "tp" not in job else _tp_runs(job["tp"])
    try:
        for name, *run in runs:
            out[name] = _dp_fit(name, *run, job["ws"], dp_timing=name.endswith("flagship"))
        with open(f"{job['out']}.rank{rank}.json", "w") as fh:
            json.dump(out, fh)
    finally:
        distributed.shutdown()
    return 0


def _launch(nproc, args, timeout=DP_TIMEOUT_S):
    """``python -m torch.distributed.run --nproc_per_node nproc args`` from
    the repo root, in its own session so a hung rank is killed with the
    launcher; returns (rc, output tail, seconds)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
           "--master_addr", "127.0.0.1", "--master_port", str(29500 + nproc)] + args
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT,
                                                "OMP_NUM_THREADS": "2"},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        import signal

        os.killpg(proc.pid, signal.SIGKILL)
        out = proc.communicate()[0]
        raise RuntimeError(f"{' '.join(args)}: no end in {timeout} s: {out[-3000:]}")
    return proc.returncode, out[-6000:], time.perf_counter() - t0


def _step1_check(ours, ref, lr) -> dict:
    """One train step against another from the same weights: the largest
    gradient difference over the CPU test's tolerance (1e-7 + GRAD_RTOL x
    the tensor's largest gradient) and its tensor; the largest parameter
    difference where the gradient is more than twice that tolerance (and
    DECIDED_GRAD) from 0, so that its sign, and with it Adam's first step,
    is certain; whether every parameter is within two Adam steps (2 lr)."""
    worst, worst_k, undecided, dec_diff, bounded = 0.0, None, 0, 0.0, True
    for k, g in ref["grads"].items():
        tol = 1e-7 + GRAD_RTOL * float(g.abs().max())
        r = float((ours["grads"][k] - g).abs().max()) / tol
        if r > worst:
            worst, worst_k = r, k
        decided = g.abs() >= max(DECIDED_GRAD, 2 * tol)
        undecided += int((~decided).sum())
        d = (ours["params"][k] - ref["params"][k]).abs()
        if decided.any():
            dec_diff = max(dec_diff, float(d[decided].max()))
        bounded &= float(d.max()) <= 2 * lr * (1 + 1e-6) + 1e-7
    return {"grad_diff_over_tol": worst, "worst_tensor": worst_k,
            "decided_param_max_abs_diff": dec_diff, "undecided_entries": undecided,
            "bounded": bounded}


def _ulp_control(preset, overrides) -> dict:
    """The one-process step on fit's first batch and on that batch scaled by
    ULP_SCALE (f32, TF32 off), each as {"params", "grads"}: how far a one-ulp
    change of the forward alone moves one step."""
    from mla_tpu_torch._device import tf32_off
    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.data.sampler import BalancedSampler
    from mla_tpu_torch.data.synthetic import make_dataset
    from mla_tpu_torch.models.zoo import build_model
    from mla_tpu_torch.train.state import create_train_state, make_train_step

    cfg = get_config(preset, overrides)
    ds = make_dataset(cfg.data, cfg.model.n_classes, "train", "waveform", cfg.frontend)
    idx = BalancedSampler(ds.y, cfg.train.batch_size, cfg.train.seed).next_batch()
    x = np.ascontiguousarray(ds.x[idx])
    y = torch.from_numpy(np.asarray(ds.y[idx], np.float32)).cuda()
    out = []
    with tf32_off():
        for xs in (x, (x * np.float32(ULP_SCALE)).astype(np.float32)):
            model = build_model(cfg.model, seed=cfg.train.seed)
            st, _ = make_train_step(cfg, model, "waveform", clip_samples=x.shape[1])(
                create_train_state(cfg, model), torch.from_numpy(xs).cuda(), y)
            opt = st.optimizer
            out.append({"params": {k: v.cpu() for k, v in model.state_dict().items()},
                        "grads": {n: (opt.state[p]["exp_avg"] / (1 - opt.defaults["betas"][0]))
                                  .cpu() for n, p in model.named_parameters()}})
            del model, st, opt
    return {"step": out[0], "scaled": out[1], "lr": cfg.train.learning_rate}


def _loss_control(preset, overrides, ref_losses) -> dict:
    """The one-process fit's train steps replayed on its own batches (the
    balanced sampler's, gathered as fit gathers a device-resident set), once
    as they are and on the input scaled by 1 + k 2^-23 for k = 1 ..
    LOSS_CONTROLS: each run's relative loss gap to ``ref_losses`` (the fit's)
    at every step, and the largest per step. In bf16 Adam carries a
    rounding-level change of the forward into losses ~1e-3 apart by step 3,
    on any tree: this is the noise a rounding-level change of the
    arithmetic (a sharded matmul's sum order) is held against."""
    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.data.sampler import BalancedSampler
    from mla_tpu_torch.data.synthetic import make_dataset
    from mla_tpu_torch.models.zoo import build_model
    from mla_tpu_torch.train.state import create_train_state, make_train_step

    cfg = get_config(preset, overrides)
    ds = make_dataset(cfg.data, cfg.model.n_classes, "train", "waveform", cfg.frontend)
    sampler = BalancedSampler(ds.y, cfg.train.batch_size, cfg.train.seed)
    idxs = [sampler.next_batch() for _ in range(cfg.train.num_steps)]
    xs = [np.ascontiguousarray(np.asarray(ds.x[i], np.float32)) for i in idxs]
    ys = [torch.from_numpy(np.asarray(ds.y[i], np.float32)).cuda() for i in idxs]
    ref = np.asarray(ref_losses)
    gaps = []
    for k in range(LOSS_CONTROLS + 1):
        model = build_model(cfg.model, seed=cfg.train.seed)
        st = create_train_state(cfg, model)
        step = make_train_step(cfg, model, "waveform", clip_samples=xs[0].shape[1])
        losses = []
        for x, y in zip(xs, ys):
            x = (x * np.float32(1.0 + k * 2.0 ** -23)).astype(np.float32) if k else x
            st, loss = step(st, torch.from_numpy(x).cuda(), y)
            losses.append(float(loss))
        gaps.append((np.abs(np.asarray(losses) - ref) / np.abs(ref)).tolist())
        del model, st, step
    return {"rel_gaps": gaps, "max_rel_by_step": np.max(gaps, axis=0).tolist()}


def _csv_losses(path):
    with open(path) as fh:
        return {int(r["step"]): float(r["value"]) for r in csv.DictReader(fh)
                if r["key"] == "loss"}


def _parallelism(scfg, state_dict, streams, schedule, zero_counts, check_launches, tag):
    """Phase 10: the stream-sharded server (10a), context-parallel scoring
    (10b), a one-rank NCCL fit through the train verb (10c), and two gloo
    ranks on the one card (10d). Returns (record, front-end launches by
    path, decode launches by path)."""
    from mla_tpu_torch._device import tf32_off
    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.data.audio_io import write_wav
    from mla_tpu_torch.ops import adpcm as ad
    from mla_tpu_torch.ops import fused_frontend as ff
    from mla_tpu_torch.parallel.mesh import make_mesh
    from mla_tpu_torch.serve.server import BatchedStreamingServer
    from mla_tpu_torch.serve.sharded import tag_clip_time_sharded
    from mla_tpu_torch.serve.streaming import tag_clip
    from mla_tpu_torch.train import loop

    t_phase = time.perf_counter()
    rec, fe_paths, dec_paths = {}, {}, {}
    f32cfg = dataclasses.replace(scfg, model=dataclasses.replace(scfg.model,
                                                                 compute_dtype="float32"))
    card = torch.device("cuda", 0)
    mesh2 = make_mesh(devices=[card] * 2)

    # 10a. the stream-sharded server: 8 streams over [cuda:0] x 2 against the
    # unsharded server on the same schedule, by tick() and by the packed tick,
    # with the ring; f32 (TF32 off) against the tolerance, the preset's bf16
    # against the bf16 budget (a shard's batch of 4 may take other cuDNN
    # algorithms than the batch of 8)
    serve = {}
    for wire in ("int16", "adpcm4"):
        for packed in (False, True):
            for label, cfg_, tol in (("f32", f32cfg, PAR_TOL), ("bf16", scfg, None)):
                key = f"{wire} {'packed' if packed else 'tick'} {label}"
                kw = dict(max_streams=8, chunk_patches=5, transfer_dtype=wire,
                          timeline_cap=TIMELINE_CAP)
                with tf32_off() if label == "f32" else contextlib.nullcontext():
                    plain = BatchedStreamingServer(cfg_, state_dict, **kw)
                    plain.warmup(packed=True)
                    want = _drive(plain, streams, schedule, packed)
                    shard = BatchedStreamingServer(cfg_, state_dict, mesh=mesh2, **kw)
                    shard.warmup(packed=True)
                    zero_counts()
                    d0 = shard.dispatches
                    got = _drive(shard, streams, schedule, packed)
                    torch.cuda.synchronize()
                steps = (shard.dispatches - d0) * len(shard._shards)
                launches = check_launches(f"10a sharded server {key} (2 shards)", steps,
                                          wire == "adpcm4")
                err = float(np.abs(got - want).max())
                ok = (np.allclose(got, want, **tol) if tol is not None
                      else err <= BF16_SCORE_BUDGET)
                serve[key] = {"max_abs_err": err, "device_steps": shard.dispatches - d0,
                              **launches}
                print(f"10a sharded server, {key}: {shard.dispatches - d0} device steps x 2 "
                      f"shards; scores against the unsharded server max |diff| {err:.3e} "
                      f"({'rtol 1e-4 atol 1e-5' if tol else f'bf16 budget {BF16_SCORE_BUDGET}'})")
                if not ok or not np.isfinite(got).all():
                    raise RuntimeError(f"10a {key}: sharded scores against unsharded {err}")
                path = f"serve_sharded_{wire}_{'packed' if packed else 'tick'}_{label}"
                fe_paths[path] = launches["frontend_launches"]
                if wire == "adpcm4":
                    dec_paths[path] = launches["decode_launches"]
                del plain, shard
    # the tick on the host clock, sharded against unsharded, in turns, and a
    # profile of ten of each (int16, ring off: phase 7's first row)
    tick_srv = {}
    for label, m in (("unsharded", None), ("sharded", mesh2)):
        s = BatchedStreamingServer(scfg, state_dict, max_streams=8, chunk_patches=5,
                                   transfer_dtype="int16", mesh=m)
        s.warmup(packed=True)
        # ticks for the turns, the profile's warm-up and its ten, and spare
        audio = (0.1 * np.random.default_rng(SEED).standard_normal(
            s.chunk_samples + (2 * (REPS + 3 + 10 + 1) + 2) * s.hop_samples)).astype(np.float32)
        for _ in range(8):
            s.feed(s.open(), audio)
        tick_srv[label] = s
    fns = {f"{k} {kind}": getattr(s, "tick_packed" if kind == "packed" else "tick")
           for k, s in tick_srv.items() for kind in ("tick", "packed")}
    med, _ = _in_turns(fns)
    tick_rec = {"ms": med}
    for k, fn in fns.items():
        tick_rec[f"{k} profile"] = _report_profile(f"10a {k}", 10, med[k], _profile(fn, 10), tag)
    print("10a ticks, int16, 8 streams x 5 patches, host clock in turns: " + "; ".join(
        f"{k} {med[k]:.4f} ms (busy {tick_rec[k + ' profile']['device_busy_ms']:.4f}, idle "
        f"{tick_rec[k + ' profile']['idle_share']:.4f})" for k in fns)
        + f"; sharded / unsharded host {med['sharded tick'] / med['unsharded tick']:.4f}, "
        f"busy {tick_rec['sharded tick profile']['device_busy_ms'] / tick_rec['unsharded tick profile']['device_busy_ms']:.4f} {tag}")  # noqa: E501
    del tick_srv
    rec["serve"], rec["ticks"] = serve, tick_rec

    # the verb: serve --native --shard_streams (every visible card: a 1-shard
    # mesh here), tagged by tag
    clip = os.path.join(ROOT, "build", "parallel_clip.wav")
    write_wav(clip, streams[2][:10 * 16000], 16000)
    env = {**os.environ, "PYTHONPATH": ROOT}
    err_path = os.path.join(ROOT, "build", "parallel_serve.err")
    with open(err_path, "w") as err_fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "mla_tpu_torch", "serve", "--native", "--shard_streams",
             "--checkpoint", "random", "--port", "0", "--set", "frontend.impl=pallas"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err_fh, text=True)
        try:
            import select

            ready, _, _ = select.select([proc.stdout], [], [], CLI_TIMEOUT_S)
            line = proc.stdout.readline() if ready else ""
            if "streams sharded over {'data': 1, 'model': 1}" not in line:
                raise RuntimeError(f"serve --shard_streams did not start: {line!r}; stderr "
                                   f"{open(err_path).read()[-2000:]}")
            url = line.split(" on ")[1].split("/v1")[0]
            out = subprocess.run([sys.executable, "-m", "mla_tpu_torch", "tag", "--url", url,
                                  "--wav", clip], cwd=ROOT, env=env, capture_output=True,
                                 text=True, timeout=CLI_TIMEOUT_S)
            if out.returncode != 0:
                raise RuntimeError(f"tag failed: {out.stderr[-2000:]}")
            top = json.loads(out.stdout.strip().splitlines()[-1])["top_k"]
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
            proc.stdout.close()
    if len(top) != 5 or not all(np.isfinite(p) for _, p in top):
        raise RuntimeError(f"serve --shard_streams + tag: {top}")
    rec["cli"] = {"line": line.strip(), "top_k": top}
    print(f"10a verbs: `{line.strip()}`; `tag` printed {top}; the server terminated")

    # 10b. context-parallel scoring: a 60 s clip over [cuda:0] x 4 against
    # tag_clip; one front-end launch for the whole clip
    sr = scfg.frontend.sample_rate
    n = int(PAR_CLIP_S * sr)
    t = np.arange(n) / sr
    clip60 = (0.3 * np.sin(2 * np.pi * 330 * t)
              + 0.05 * np.random.default_rng(SEED + 1).standard_normal(n)).astype(np.float32)
    mesh4 = make_mesh(devices=[card] * PAR_TIME_SHARDS)
    cp = {}
    for label, cfg_ in (("f32", f32cfg), ("bf16", scfg)):
        with tf32_off() if label == "f32" else contextlib.nullcontext():
            want = tag_clip(cfg_, state_dict, clip60)
            zero_counts()
            got = tag_clip_time_sharded(cfg_, state_dict, clip60, mesh4)
            torch.cuda.synchronize()
            fe_l = ff.LAUNCHES
            t0 = time.perf_counter()
            tag_clip_time_sharded(cfg_, state_dict, clip60, mesh4)
            sharded_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            tag_clip(cfg_, state_dict, clip60)
            whole_s = time.perf_counter() - t0
        err = float(np.abs(got - want).max())
        ok = (np.allclose(got, want, **PAR_TOL) if label == "f32"
              else err <= BF16_SCORE_BUDGET)
        cp[label] = {"max_abs_err": err, "frontend_launches": fe_l,
                     "sharded_host_ms": sharded_s * 1e3, "whole_host_ms": whole_s * 1e3}
        print(f"10b context-parallel {label}: {PAR_CLIP_S:g} s clip over {PAR_TIME_SHARDS} "
              f"shards of cuda:0 against tag_clip max |diff| {err:.3e}; front-end launches "
              f"{fe_l}; host {sharded_s * 1e3:.2f} ms (whole clip {whole_s * 1e3:.2f} ms, "
              f"each with its model build) {tag}")
        if not ok or fe_l != 1 or not np.isfinite(got).all():
            raise RuntimeError(f"10b {label}: {cp[label]}")
    fe_paths.update({f"context_parallel_{k}": v["frontend_launches"] for k, v in cp.items()})
    rec["context_parallel"] = cp

    # 10c. the train verb under torch.distributed.run, one rank on NCCL,
    # against the plain fit of the same steps in this process under the
    # subprocess's default TF32 flags, twice
    set_args = ["train.num_steps=10", "train.eval_every=10", "train.checkpoint_every=0",
                "train.log_every=1"]
    ws1 = os.path.join(ROOT, "build", "chip_smoke_dp1")
    shutil.rmtree(ws1, ignore_errors=True)
    rc, out, dp1_s = _launch(1, ["-m", "mla_tpu_torch", "train", "--config",
                                 "us8k_fused_frontend", "--workspace", ws1, "--set"] + set_args)
    if rc != 0:
        raise RuntimeError(f"10c: the one-rank train verb failed ({rc}): {out}")
    dp1 = _csv_losses(os.path.join(ws1, "scalars.csv"))
    cfg10 = get_config("us8k_fused_frontend", dict(a.split("=") for a in set_args))
    plain = []
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default, as in the subprocess
    try:
        for i in range(2):
            wsp = os.path.join(ROOT, "build", f"chip_smoke_plain{i}")
            shutil.rmtree(wsp, ignore_errors=True)
            zero_counts()
            res = loop.fit(cfg10, workspace=wsp, log=False)
            plain.append({h["step"]: h["loss"] for h in res.history})
            plain_fe = ff.LAUNCHES
            del res
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
    steps = sorted(dp1)
    diff = max(abs(dp1[s] - plain[0][s]) for s in steps)
    replay = max(abs(plain[1][s] - plain[0][s]) for s in steps)
    rec["one_rank"] = {"losses": [dp1[s] for s in steps], "plain": [plain[0][s] for s in steps],
                       "max_abs_diff": diff, "bit_equal": diff == 0.0,
                       "plain_replay_max_abs_diff": replay, "s": dp1_s,
                       "plain_launches": plain_fe}
    print(f"10c one NCCL rank (torch.distributed.run, the train verb, {len(steps)} logged steps "
          f"in {dp1_s:.1f} s): losses against the plain fit max |diff| {diff:.3e} "
          f"({'bit-equal' if diff == 0.0 else 'not bit-equal'}); the plain fit against itself "
          f"{replay:.3e}; its launches {plain_fe}")
    if steps != list(range(1, 11)) or not np.isfinite([dp1[s] for s in steps]).all():
        raise RuntimeError(f"10c: losses {dp1}")
    if diff > max(replay, 0.0) * 10 + 1e-6:
        raise RuntimeError(f"10c: the one-rank fit differs from the plain fit by {diff} "
                           f"(the plain fit replays within {replay})")

    # 10d. two gloo ranks on the one card, each run against the single
    # process at the global batch; the flagship's step timed before and after
    ws2 = os.path.join(ROOT, "build", "chip_smoke_dp2")
    shutil.rmtree(ws2, ignore_errors=True)
    os.makedirs(ws2)
    runs = {r[0]: r[1:] for r in _dp_runs(ws2)}
    single = {}
    torch.cuda.empty_cache()
    for name, run in runs.items():
        single[name] = _dp_fit(name + "_single", *run, ws2, dp_timing=name == "flagship")
    ulp = _ulp_control(*runs["us8k_f32_step1"][:2])
    job = os.path.join(ws2, "job.json")
    with open(job, "w") as fh:
        json.dump({"backend": "gloo", "ws": ws2, "out": os.path.join(ws2, "out")}, fh)
    torch.cuda.empty_cache()
    rc, out, dp2_s = _launch(2, [os.path.join(ROOT, "chip_smoke.py"), "--dp-worker", job])
    if rc != 0:
        raise RuntimeError(f"10d: the two gloo ranks failed ({rc}): {out}")
    ranks = []
    for r in range(2):
        with open(os.path.join(ws2, f"out.rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    after = _dp_fit("flagship_single_after", *runs["flagship"], ws2, dp_timing=True)

    def max_diff(a, b, keys):
        return max([float((a[k] - b[k]).abs().max()) for k in keys] or [0.0])

    dp = {"s": dp2_s}
    for name in runs:
        r0, r1 = ranks[0][name], ranks[1][name]
        ref = single[name]
        s0, s1, sref = (torch.load(p["params"]) for p in (r0, r1, ref))
        p0, ps = s0["params"], sref["params"]
        same = all(torch.equal(p0[k], s1["params"][k]) for k in p0)
        l0, lref = np.array(r0["losses"]), np.array(ref["losses"])
        lrel = float(np.max(np.abs(l0 - lref) / np.abs(lref)))
        # one front-end launch per step and eval batch where the preset takes the
        # kernel (us8k); the flagship ships the torch-ops front-end ("xla")
        impl = get_config(runs[name][0], runs[name][1]).frontend.impl
        want_fe = (r0["counts"]["train_steps"] + r0["counts"]["eval_batches"]
                   if impl == "pallas" else 0)
        entry = {"losses": r0["losses"], "single_losses": ref["losses"],
                 "loss_max_rel_diff": lrel, "first_loss_abs_diff": float(abs(l0[0] - lref[0])),
                 "param_max_abs_diff": max_diff(p0, ps, p0), "ranks_equal": same,
                 "launches": [r0["launches"], r1["launches"]], "counts": r0["counts"],
                 "peak_gb": [r0["peak_gb"], r1["peak_gb"]], "single_peak_gb": ref["peak_gb"]}
        print(f"10d {name}, 2 gloo ranks on cuda:0 against 1 process at the global batch: "
              f"losses {r0['losses']} against {ref['losses']} (max rel diff {lrel:.3e}); "
              f"parameters max |diff| {entry['param_max_abs_diff']:.3e}; ranks equal {same}; "
              f"front-end launches per rank {[r['launches'] for r in (r0, r1)]} (want {want_fe}, "
              f"front-end {impl!r}); peak GB per rank {r0['peak_gb']:.2f} / "
              f"{r1['peak_gb']:.2f}, single {ref['peak_gb']:.2f} {tag}")
        if not same or any(r["launches"] != want_fe for r in (r0, r1)):
            raise RuntimeError(f"10d {name}: {entry}")
        if not np.isfinite(l0).all():
            raise RuntimeError(f"10d {name}: non-finite losses {l0}")
        if name == "us8k_f32":
            if entry["first_loss_abs_diff"] > 1e-5 or lrel > DP_F32_LOSS_RTOL:
                raise RuntimeError(f"10d {name}: {entry}")
        elif name.startswith("us8k_f32"):
            entry.update(_step1_check(s0, sref, r0["lr"]))
            if name == "us8k_f32_step1":
                entry["same_as_control_step"] = _step1_check(ulp["step"], sref, ulp["lr"])
                entry["ulp_control"] = _step1_check(ulp["scaled"], ulp["step"], ulp["lr"])
            print(f"10d {name}: gradients against the single process, the largest |diff| "
                  f"over its tolerance (1e-7 + {GRAD_RTOL:g} x the tensor's largest) "
                  f"{entry['grad_diff_over_tol']:.4f} in {entry['worst_tensor']}; parameters "
                  f"where |g| is over twice that and {DECIDED_GRAD:g}: max |diff| "
                  f"{entry['decided_param_max_abs_diff']:.3e}; {entry['undecided_entries']} "
                  f"entries below, all within two Adam steps: {entry['bounded']}"
                  + (f"; the one-process step on the input x {ULP_SCALE!r} against it: "
                     f"{entry['ulp_control']['grad_diff_over_tol']:.4f} in "
                     f"{entry['ulp_control']['worst_tensor']} (the control's own step against "
                     f"the fit's: {entry['same_as_control_step']['grad_diff_over_tol']:.4f})"
                     if "ulp_control" in entry else ""))
            if not entry["bounded"] or entry["first_loss_abs_diff"] > 1e-5:
                raise RuntimeError(f"10d {name}: {entry}")
            if name == "us8k_f32_step1" and entry["grad_diff_over_tol"] > max(
                    1.0, 2 * entry["ulp_control"]["grad_diff_over_tol"]):
                raise RuntimeError(f"10d {name}: further than the one-ulp control: {entry}")
            if name == "us8k_f32_narrow_step1" and (
                    entry["grad_diff_over_tol"] > 1.0
                    or entry["decided_param_max_abs_diff"] > 1e-5):
                raise RuntimeError(f"10d {name}: {entry}")
        elif lrel > DP_FLAGSHIP_LOSS_RTOL:
            raise RuntimeError(f"10d {name}: {entry}")
        else:
            entry.update(step_ms=[r0["step_ms"], r1["step_ms"]],
                         idle_share=[r0["idle_share"], r1["idle_share"]],
                         busy_ms=[r0["device_busy_ms"], r1["device_busy_ms"]],
                         single_step_ms=[ref["step_ms"], after["step_ms"]],
                         single_idle_share=[ref["idle_share"], after["idle_share"]],
                         rank0_top_ms=r0["top_ms"])
            def share(v):
                return "not measured" if v is None else f"{v:.4f}"

            print(f"10d flagship step (batch 256): 2 gloo ranks of 128 on one card "
                  f"{r0['step_ms']:.2f} / {r1['step_ms']:.2f} ms (idle share "
                  f"{share(r0['idle_share'])} / {share(r1['idle_share'])}); one process "
                  f"{ref['step_ms']:.2f} ms before, {after['step_ms']:.2f} after (idle "
                  f"{share(ref['idle_share'])} / {share(after['idle_share'])}); rank 0's top "
                  f"device ops {r0['top_ms'][:4]}. Two processes share one card: this measures "
                  f"the code path, not scaling {tag}")
        fe_paths[f"dp_{name}_rank0"] = r0["launches"]
        fe_paths[f"dp_{name}_rank1"] = r1["launches"]
        dp[name] = entry
    rec["dp"] = dp
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 10: {rec['phase_s']:.1f} s {tag}")
    return rec, fe_paths, dec_paths


# phase 11: tensor parallelism on the one card (the model axis' ranks, or
# the single-process grid's entries, all name cuda:0)
TP_SERVE_F32_TOL = 1e-6  # TP server against the unsharded one, f32, TF32 off
TP_SERVE_BF16_BUDGET = 1e-3
# 11b, us8k bf16: each step's loss within 2x the furthest of the one-ulp
# loss controls (_loss_control) at that step of one process's, and within
# TP_US8K_LOSS_RTOL where every control is closer (step 1)
TP_US8K_LOSS_RTOL = 1e-4
LOSS_CONTROLS = 8
TP_FLAGSHIP_LOSS_RTOL = 1e-3  # 11c, bf16, the loose budget
TP_FLAGSHIP_BATCH = 128  # 11c's global batch (both ranks hold all of it on one card)
MP = "train.model_parallel"


def _tp_runs(world: int):
    """What a phase-11 launch of ``world`` ranks runs: (name, config,
    overrides, f32 with TF32 off); the single process runs the same without
    the mesh overrides."""
    base = {"train.eval_every": 1000, "train.checkpoint_every": 0, "train.log_every": 1}
    f32 = {"model.compute_dtype": "float32", "train.num_steps": 1}
    if world == 2:
        return [("tp_us8k", "us8k_fused_frontend",
                 {**base, "train.num_steps": 3, "train.eval_every": 3, MP: 2}, False),
                ("tp_us8k_f32_step1", "us8k_fused_frontend", {**base, **f32, MP: 2}, True),
                ("tp_flagship", "audioset_full_dp",
                 {**DP_FLAGSHIP, "train.batch_size": TP_FLAGSHIP_BATCH, MP: 2}, False)]
    return [("tp_grid_us8k_f32_step1", "us8k_fused_frontend",
             {**base, **f32, "train.data_parallel": 2, MP: 2}, True)]


def _single_overrides(overrides):
    return {k: v for k, v in overrides.items() if k not in (MP, "train.data_parallel")}


def _rule_bytes(cfg, mp):
    """The rule's sharded flat names of ``cfg``'s model at ``mp`` and the
    parameter and statistic bytes (f32) one rank of the model axis holds."""
    from mla_tpu_torch.models.convert import flat_shapes
    from mla_tpu_torch.models.zoo import build_model
    from mla_tpu_torch.parallel.mesh import make_mesh, param_shardings

    shapes = flat_shapes(build_model(cfg.model, device="meta").state_dict())
    mesh = make_mesh(1, mp, devices=["meta"] * mp)
    specs = param_shardings(mesh, shapes, cfg.model.hidden_units)
    whole = sum(4 * int(np.prod(s)) for s in shapes.values())
    rank = sum(4 * int(np.prod(s)) // (mp if specs[k].spec else 1) for k, s in shapes.items())
    return sorted(k for k, p in specs.items() if p.spec), whole, rank


def _tensor_parallelism(scfg, state_dict, state_dict2, streams, schedule, zero_counts,
                        check_launches, tag):
    """Phase 11: the rule on the shipped trees (11a), tensor-parallel fits
    on two gloo ranks (11b us8k, 11c the flagship) and on a (2, 2) grid of
    four (11d) against one process, the server with weights sharded over
    single-process grids (11e) and the dryrun (11f). Returns (record,
    front-end launches by path, decode launches by path)."""
    from mla_tpu_torch._device import tf32_off
    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.entry import dryrun_multichip
    from mla_tpu_torch.ops import adpcm as ad
    from mla_tpu_torch.parallel import tensor
    from mla_tpu_torch.parallel.mesh import make_mesh
    from mla_tpu_torch.serve.server import BatchedStreamingServer

    t_phase = time.perf_counter()
    rec, fe_paths, dec_paths = {}, {}, {}
    card = torch.device("cuda", 0)

    # 11a. the rule on the flagship and serving trees at mp = 2
    rule = {}
    for preset in ("audioset_full_dp", "streaming_inference"):
        names, whole, rank = _rule_bytes(get_config(preset), 2)
        rule[preset] = {"sharded": names, "whole_mb": whole / 1e6, "rank_mb": rank / 1e6}
        print(f"11a {preset} at model 2: {len(names)} sharded flat names {names}; "
              f"parameters and statistics {whole / 1e6:.3f} MB whole, {rank / 1e6:.3f} MB "
              "a rank")
        if len(names) != 15:
            raise RuntimeError(f"11a {preset}: {len(names)} sharded names")
    rec["rule"] = rule

    # 11b-11d. the fits: one process first, then the ranks
    ws = os.path.join(ROOT, "build", "chip_smoke_tp")
    shutil.rmtree(ws, ignore_errors=True)
    os.makedirs(ws)
    runs = {w: {r[0]: r[1:] for r in _tp_runs(w)} for w in (2, 4)}
    single = {}
    torch.cuda.empty_cache()
    for name, (preset, over, f32) in {**runs[2], **runs[4]}.items():
        key = (preset, json.dumps(_single_overrides(over), sort_keys=True), f32)
        if key not in single:
            single[key] = _dp_fit(name + "_single", preset, _single_overrides(over), f32, ws,
                                  dp_timing=name.endswith("flagship"))
    ulp = _ulp_control("us8k_fused_frontend", _single_overrides(runs[2]["tp_us8k_f32_step1"][1]))
    bf16_over = _single_overrides(runs[2]["tp_us8k"][1])
    loss_ctl = _loss_control("us8k_fused_frontend", bf16_over, single[
        ("us8k_fused_frontend", json.dumps(bf16_over, sort_keys=True), False)]["losses"])
    ranks = {}
    for world in (2, 4):
        job = os.path.join(ws, f"job{world}.json")
        with open(job, "w") as fh:
            json.dump({"backend": "gloo", "ws": ws, "out": os.path.join(ws, f"out{world}"),
                       "tp": world}, fh)
        torch.cuda.empty_cache()
        rc, out, secs = _launch(world, [os.path.join(ROOT, "chip_smoke.py"), "--dp-worker", job])
        if rc != 0:
            raise RuntimeError(f"11: the {world} gloo ranks failed ({rc}): {out}")
        ranks[world] = []
        for r in range(world):
            with open(os.path.join(ws, f"out{world}.rank{r}.json")) as fh:
                ranks[world].append(json.load(fh))
        rec[f"launch{world}_s"] = secs
    fits = {}
    for world in (2, 4):
        for name, (preset, over, f32) in runs[world].items():
            rs = [r[name] for r in ranks[world]]
            ref = single[(preset, json.dumps(_single_overrides(over), sort_keys=True), f32)]
            loaded = [torch.load(r["params"]) for r in rs]
            sref = torch.load(ref["params"])
            same = all(torch.equal(loaded[0]["params"][k], o["params"][k])
                       for o in loaded[1:] for k in loaded[0]["params"])
            l0, lref = np.array(rs[0]["losses"]), np.array(ref["losses"])
            lrel = float(np.max(np.abs(l0 - lref) / np.abs(lref)))
            impl = get_config(preset, over).frontend.impl
            want_fe = (rs[0]["counts"]["train_steps"] + rs[0]["counts"]["eval_batches"]
                       if impl == "pallas" else 0)
            entry = {"losses": rs[0]["losses"], "single_losses": ref["losses"],
                     "loss_max_rel_diff": lrel, "ranks_equal": same,
                     "launches": [r["launches"] for r in rs], "counts": rs[0]["counts"],
                     "peak_gb": [r["peak_gb"] for r in rs], "single_peak_gb": ref["peak_gb"]}
            print(f"11 {name}, {world} gloo ranks on cuda:0 against 1 process: losses "
                  f"{rs[0]['losses']} against {ref['losses']} (max rel diff {lrel:.3e}); ranks "
                  f"equal {same}; front-end launches per rank {entry['launches']} (want {want_fe}, "
                  f"front-end {impl!r}); peak GB per rank "
                  f"{[round(g, 3) for g in entry['peak_gb']]}, single {ref['peak_gb']:.3f} {tag}")
            if (not same or not np.isfinite(l0).all()
                    or any(r["launches"] != want_fe for r in rs)):
                raise RuntimeError(f"11 {name}: {entry}")
            if f32:
                entry.update(_step1_check(loaded[0], sref, rs[0]["lr"]))
                entry["ulp_control"] = _step1_check(ulp["scaled"], ulp["step"], ulp["lr"])
                print(f"11 {name}: gradients against the single process, the largest |diff| "
                      f"over its tolerance {entry['grad_diff_over_tol']:.4f} in "
                      f"{entry['worst_tensor']}, decided parameters max |diff| "
                      f"{entry['decided_param_max_abs_diff']:.3e}, all within two Adam steps "
                      f"{entry['bounded']}; the one-ulp control "
                      f"{entry['ulp_control']['grad_diff_over_tol']:.4f}")
                if (not entry["bounded"] or abs(l0[0] - lref[0]) > 1e-5
                        or entry["grad_diff_over_tol"] > max(
                            1.0, 2 * entry["ulp_control"]["grad_diff_over_tol"])):
                    raise RuntimeError(f"11 {name}: {entry}")
            elif name.endswith("flagship"):
                if lrel > TP_FLAGSHIP_LOSS_RTOL:
                    raise RuntimeError(f"11 {name}: {entry}")
            else:
                bound = np.maximum(TP_US8K_LOSS_RTOL, 2 * np.asarray(loss_ctl["max_rel_by_step"]))
                rel = np.abs(l0 - lref) / np.abs(lref)
                entry.update(loss_rel_by_step=rel.tolist(), loss_bound_by_step=bound.tolist(),
                             loss_control=loss_ctl)
                print(f"11 {name}: loss gaps by step {np.round(rel, 7).tolist()} against "
                      f"{np.round(bound, 7).tolist()} (the one-ulp controls' furthest x 2, at "
                      f"least {TP_US8K_LOSS_RTOL}; the control as run "
                      f"{np.round(loss_ctl['rel_gaps'][0], 7).tolist()})")
                if not (rel <= bound).all():
                    raise RuntimeError(f"11 {name}: {entry}")
            if name.endswith("flagship"):
                entry.update(step_ms=[r["step_ms"] for r in rs],
                             idle_share=[r["idle_share"] for r in rs],
                             busy_ms=[r["device_busy_ms"] for r in rs],
                             collectives=[r["collectives"] for r in rs],
                             single_step_ms=ref["step_ms"], single_idle_share=ref["idle_share"],
                             rank0_top_ms=rs[0]["top_ms"])
                print(f"11c flagship step (batch {TP_FLAGSHIP_BATCH}, model 2): ranks "
                      f"{[round(r['step_ms'], 2) for r in rs]} ms (idle share "
                      f"{[r['idle_share'] for r in rs]}, busy {entry['busy_ms']} ms), one "
                      f"process {ref['step_ms']:.2f} ms (idle {ref['idle_share']}); collectives "
                      f"a step per rank {entry['collectives']}; rank 0's top device ops "
                      f"{rs[0]['top_ms'][:5]}. Two ranks share one card: this measures the "
                      f"code path, not scaling {tag}")
            for r, rr in enumerate(rs):
                fe_paths[f"{name}_rank{r}"] = rr["launches"]
            fits[name] = entry
    rec["fits"] = fits

    # 11e. the server with weights sharded over [cuda:0] x (1, 2) and x (2, 2)
    f32cfg = dataclasses.replace(scfg, model=dataclasses.replace(scfg.model,
                                                                 compute_dtype="float32"))
    hidden = scfg.model.hidden_units
    grids = {(1, 2): make_mesh(1, 2, devices=[card] * 2),
             (2, 2): make_mesh(2, 2, devices=[card] * 4)}
    serve, plain_scores = {}, {}
    for wire in ("int16", "adpcm4"):
        for packed in (False, True):
            for label, cfg_ in (("f32", f32cfg), ("bf16", scfg)):
                kw = dict(max_streams=8, chunk_patches=5, transfer_dtype=wire,
                          timeline_cap=TIMELINE_CAP)
                with tf32_off() if label == "f32" else contextlib.nullcontext():
                    plain = BatchedStreamingServer(cfg_, state_dict, **kw)
                    plain.warmup(packed=True)
                    want = _drive(plain, streams, schedule, packed)
                    del plain
                    for grid, mesh in grids.items():
                        key = f"{grid} {wire} {'packed' if packed else 'tick'} {label}"
                        srv = BatchedStreamingServer(
                            cfg_, tensor.place_sharded(state_dict, mesh, hidden), mesh=mesh,
                            **kw)
                        if srv._tp_rows is None:
                            raise RuntimeError(f"11e {key}: the layout was not kept")
                        srv.warmup(packed=True)
                        zero_counts()
                        d0 = srv.dispatches
                        got = _drive(srv, streams, schedule, packed)
                        torch.cuda.synchronize()
                        steps = (srv.dispatches - d0) * grid[0]
                        launches = check_launches(f"11e TP server {key} ({grid[0]} data rows)",
                                                  steps, wire == "adpcm4")
                        err = float(np.abs(got - want).max())
                        ok = err <= (TP_SERVE_F32_TOL if label == "f32" else TP_SERVE_BF16_BUDGET)
                        serve[key] = {"max_abs_err": err, "device_steps": srv.dispatches - d0,
                                      **launches}
                        print(f"11e TP server {key}: {srv.dispatches - d0} device steps x "
                              f"{grid[0]} data rows; scores against the unsharded server max "
                              f"|diff| {err:.3e} (budget "
                              f"{TP_SERVE_F32_TOL if label == 'f32' else TP_SERVE_BF16_BUDGET})")
                        if not ok or not np.isfinite(got).all():
                            raise RuntimeError(f"11e {key}: scores against unsharded {err}")
                        path = (f"serve_tp_{grid[0]}x{grid[1]}_{wire}_"
                                f"{'packed' if packed else 'tick'}_{label}")
                        fe_paths[path] = launches["frontend_launches"]
                        if wire == "adpcm4":
                            dec_paths[path] = launches["decode_launches"]
                        del srv
    # a reload with sharded weights keeps the layout and matches a fresh
    # unsharded server on them (bf16, int16)
    mesh = grids[(2, 2)]
    kw = dict(max_streams=8, chunk_patches=5, transfer_dtype="int16")
    srv = BatchedStreamingServer(scfg, tensor.place_sharded(state_dict, mesh, hidden), mesh=mesh,
                                 **kw)
    t0 = time.perf_counter()
    staged = srv.prepare_reload(tensor.place_sharded(state_dict2, mesh, hidden))
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3
    srv.commit_reload(staged)
    kept = all(tensor.layout_of(m) is not None for m in srv.model)
    got = _drive(srv, streams, schedule)
    fresh = BatchedStreamingServer(scfg, state_dict2, **kw)
    want = _drive(fresh, streams, schedule)
    err = float(np.abs(got - want).max())
    serve["reload"] = {"layout_kept": kept, "max_abs_err": err, "prepare_ms": prep_ms}
    print(f"11e reload of sharded weights on the (2, 2) TP server: layout kept {kept}; scores "
          f"against a fresh unsharded server on them max |diff| {err:.3e}; prepare_reload "
          f"{prep_ms:.2f} ms {tag}")
    if not kept or err > TP_SERVE_BF16_BUDGET:
        raise RuntimeError(f"11e reload: {serve['reload']}")
    del srv, fresh
    # the tick on the host clock in turns, and profiled (int16, ring off)
    tick_srv = {}
    for label, mesh_ in (("unsharded", None), ("tp 1x2", grids[(1, 2)]),
                         ("tp 2x2", grids[(2, 2)])):
        sd = state_dict if mesh_ is None else tensor.place_sharded(state_dict, mesh_, hidden)
        s = BatchedStreamingServer(scfg, sd, mesh=mesh_, **kw)
        s.warmup(packed=True)
        audio = (0.1 * np.random.default_rng(SEED).standard_normal(
            s.chunk_samples + (2 * (REPS + 3 + 10 + 1) + 2) * s.hop_samples)).astype(np.float32)
        for _ in range(8):
            s.feed(s.open(), audio)
        tick_srv[label] = s
    fns = {k: s.tick for k, s in tick_srv.items()}
    med, _ = _in_turns(fns)
    ticks = {"ms": med}
    for k, fn in fns.items():
        ticks[f"{k} profile"] = _report_profile(f"11e {k} tick", 10, med[k], _profile(fn, 10),
                                                tag)
    print("11e ticks, int16, 8 streams x 5 patches, host clock in turns: " + "; ".join(
        f"{k} {med[k]:.4f} ms (busy {ticks[k + ' profile']['device_busy_ms']}, idle "
        f"{ticks[k + ' profile']['idle_share']})" for k in fns) + f" {tag}")
    del tick_srv
    rec["serve"], rec["ticks"] = serve, ticks

    # 11f. the dryrun's twin on the card (its adpcm4 ticks decode on the
    # card; its tiny flagship takes the torch-ops front-end)
    zero_counts()
    dry = dryrun_multichip(8)
    torch.cuda.synchronize()
    dec_paths["dryrun_multichip"] = dict(ad.LAUNCHES_BY_VARIANT)
    rec["dryrun"] = {"mesh": list(dry["mesh"]), "loss": dry["loss"],
                     "one_process_loss": dry["one_process_loss"],
                     "tensor_parallel_server": dry["tensor_parallel_server"]}
    if dry["mesh"] != (4, 2) or not dry["tensor_parallel_server"]:
        raise RuntimeError(f"11f: {rec['dryrun']}")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 11: {rec['phase_s']:.1f} s {tag}")
    return rec, fe_paths, dec_paths


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
    from mla_tpu_torch.ops import norm_act as na
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
    # what this machine offers the hdf5 reader, the TensorBoard sink, the
    # parity harness's metrics check and the verbs still to port
    record["packages"] = {}
    for mod in ("h5py", "tensorboard", "tensorflow", "matplotlib", "sklearn"):
        r = subprocess.run([sys.executable, "-c", f"import {mod}; print({mod}.__version__)"],
                           capture_output=True, text=True, timeout=120)
        found = r.stdout.strip() if r.returncode == 0 else None
        record["packages"][mod] = found
        why = (r.stderr.strip().splitlines() or ["no output"])[-1]
        print(f"package {mod}: {found or f'not importable ({why})'}")

    # 2. build: one nvcc per source and the native front's g++, all started together
    sources = {"fused_frontend": ff._SIGNATURES, "row_merge": rm._SIGNATURES,
               "adpcm": ad._SIGNATURES, "norm_act": na._SIGNATURES}

    def build(src):
        t0 = time.perf_counter()
        _build.load(src, sources[src])
        return time.perf_counter() - t0

    def build_native(lib):
        t0 = time.perf_counter()
        _build.load_native(lib)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    natives = ("serve_front", "audio_ingest")
    with concurrent.futures.ThreadPoolExecutor(len(sources) + len(natives)) as pool:
        futures = {src: pool.submit(build, src) for src in sources}
        native_futures = {lib: pool.submit(build_native, lib) for lib in natives}
        build_s = {src: f.result() for src, f in futures.items()}
        native_s = {lib: f.result() for lib, f in native_futures.items()}
    print(f"build: {len(sources)} sources, the native front and the native ingest library in "
          f"parallel, {time.perf_counter() - t0:.2f} s")
    for lib in natives:
        print(f"build: native/{lib}.cpp (g++ {' '.join(_build.GXX_FLAGS)}) {native_s[lib]:.2f} s "
              f"-> {_build.native_library_path(lib)}")
    # from here on the wav reader, the resampler and the ADPCM encoders take
    # the native library; nothing may fall back to numpy unseen
    from mla_tpu_torch.data import native

    if not native.available():
        raise RuntimeError("native/audio_ingest.cpp built but data/native.py cannot load it")
    record["native_build_s"] = native_s
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
    # errs["<case> <precision>"]: max |kernel - plain version|
    errs = {}
    for label, shape, c in cases:
        wav = (torch.randn(shape, generator=gen) * 0.1).cuda()
        for prec, tol in TOL.items():
            ref = ff.fused_log_mel_patches_reference(wav, c, prec)
            before = ff.LAUNCHES
            out = ff.fused_log_mel_patches(wav, c, prec)
            torch.cuda.synchronize()
            if ff.LAUNCHES != before + 1:
                raise RuntimeError(f"{label} {prec}: the kernel did not launch")
            if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
                raise RuntimeError(f"kernel {label} {prec}: shape {tuple(out.shape)} or "
                                   f"non-finite")
            err = float((out - ref).abs().max())
            errs[f"{label} {prec}"] = err
            print(f"kernel vs plain, {label}, {prec}: max |diff| {err:.3e} (tol {tol:g})")
            if err > tol:
                raise RuntimeError(f"kernel disagrees with its plain version: {label} {prec} "
                                   f"{err}")
    golden = np.load(os.path.join(ROOT, "tests", "golden", "frontend_golden.npz"))
    out = ff.fused_log_mel_patches(torch.from_numpy(golden["wav"]).cuda(), cfg, "highest")
    torch.cuda.synchronize()
    err = float(np.abs(out.cpu().numpy() - golden["patches"]).max())
    errs["golden highest"] = err
    print(f"kernel vs tests/golden/frontend_golden.npz, highest: max |diff| {err:.3e} "
          f"(tol 2e-4)")
    if err > 2e-4:
        raise RuntimeError(f"kernel disagrees with the front-end golden: {err}")

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

    # 3b. the batch-norm + ReLU kernels at the flagship's block shapes
    record["norm_act"] = _norm_act_phase(tag)

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
    d0 = srv.dispatches
    scores = _drive(srv, streams, schedule)
    torch.cuda.synchronize()
    serve_launches, dispatches = ff.LAUNCHES, srv.dispatches - d0
    print(f"serving path: {dispatches} device steps, fused_log_mel_patches launches "
          f"{serve_launches}")
    if serve_launches != dispatches or serve_launches < 1:
        raise RuntimeError(f"kernel launches {serve_launches} != device steps {dispatches}")
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
        d0 = wsrv.dispatches
        wscores = _drive(wsrv, wstreams, wschedule)
        torch.cuda.synchronize()
        steps, dec_launches, fe_launches = wsrv.dispatches - d0, ad.LAUNCHES, ff.LAUNCHES
        dec_by_variant = dict(ad.LAUNCHES_BY_VARIANT)
        print(f"serving path, {wire_name} wire: {steps} device steps, adpcm_decode launches "
              f"{dec_launches} {dec_by_variant}, fused_log_mel_patches launches {fe_launches}")
        if dec_launches != steps or steps < 1:
            raise RuntimeError(f"{wire_name}: decode launches {dec_launches} != device steps {steps}")
        picked = ad.decode_variant(bits, adpcm.SERVE_BLOCK)
        if dec_by_variant != {**dict.fromkeys(DECODE_VARIANTS, 0), picked: steps}:
            raise RuntimeError(f"{wire_name}: decode launches {dec_by_variant} != {steps} on "
                               f"{picked}")
        if fe_launches != steps:
            raise RuntimeError(f"{wire_name}: front-end launches {fe_launches} != {steps}")
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
                                  "frontend_launches": fe_launches,
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

    def check_launches(path, steps, adpcm_wire):
        """Front-end launches = device steps; decode launches on the
        serving wire's variant = device steps on an adpcm wire, else 0."""
        fe_l, dec_l = ff.LAUNCHES, dict(ad.LAUNCHES_BY_VARIANT)
        want_dec = dict.fromkeys(DECODE_VARIANTS, 0)
        if adpcm_wire:
            want_dec[ad.decode_variant(4, adpcm.SERVE_BLOCK)] = steps
        print(f"{path}: {steps} device steps, fused_log_mel_patches launches {fe_l}, "
              f"adpcm_decode launches {dec_l}")
        if steps < 1 or fe_l != steps or dec_l != want_dec:
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

    # 5c. the serving fronts at full width, and the serve / tag verbs
    fronts, front_paths = _fronts(scfg, state_dict, state_dict2, streams, zero_counts,
                                  check_launches, tag)
    new_paths.update(front_paths)
    record["fronts"] = fronts

    # 5d. export on the card: the one-shot and streaming artifacts, written,
    # loaded fresh and held against the live servers
    export_rec, export_dec = _export(scfg, state_dict, streams,
                                     {"int16": scores, "adpcm4": adpcm4_scores}, zero_counts, tag)
    record["export"] = export_rec

    # 6. the training path at full width
    tcfg = get_config("us8k_fused_frontend", TRAIN_CUT)
    ws = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(ws, ignore_errors=True)
    ff.LAUNCHES = 0
    t0 = time.perf_counter()
    result = loop.fit(tcfg, workspace=ws)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    train_launches, counts = ff.LAUNCHES, dict(result.counts)
    losses = [h["loss"] for h in result.history]
    print(f"training path: {counts['train_steps']} train steps + {counts['eval_batches']} eval "
          f"batches in {fit_s:.2f} s, fused_log_mel_patches launches {train_launches}")
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
    ares = loop.fit(acfg, workspace=ws_a)
    torch.cuda.synchronize()
    acounts, a_decode, a_fe = dict(ares.counts), ad.LAUNCHES, ff.LAUNCHES
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
    dec_by_path = {**export_dec,
                   "serve_adpcm4": adpcm_serve["adpcm4"]["decode_launches_by_variant"],
                   "serve_adpcm2": adpcm_serve["adpcm2"]["decode_launches_by_variant"],
                   **{p: r["decode_launches"] for p, r in new_paths.items() if "adpcm4" in p},
                   "train_adpcm4": a_dec_by_variant}
    dec_launches_by_variant = {v: sum(p[v] for p in dec_by_path.values())
                               for v in DECODE_VARIANTS}
    print(f"adpcm_decode launches on the main path by variant: {dec_launches_by_variant}")
    if min(dec_launches_by_variant.values()) < 1:
        raise RuntimeError(f"a decode variant never ran on the main path: {dec_by_path}")
    if a_fe != acounts["train_steps"] + acounts["eval_batches"]:
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
    # full-width train steps at bench.py's batch on each front-end impl (the
    # step's time is the audioset-train-b256 cell's to measure)
    fcfg = flagship_config()
    fn, (fmodel, fwav) = entry(seed=SEED)
    probs = fn(fmodel, fwav)
    torch.cuda.synchronize()
    if tuple(probs.shape) != (4, fcfg.model.n_classes) or not bool(torch.isfinite(probs).all()):
        raise RuntimeError(f"flagship forward: shape {tuple(probs.shape)} or non-finite")

    ff.LAUNCHES = 0
    probs_p = flagship_forward(flagship_config(overrides={"frontend.impl": "pallas"}))(fmodel, fwav)
    torch.cuda.synchronize()
    fwd_launches = ff.LAUNCHES
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
    if pallas_err > BF16_SCORE_BUDGET or fwd_launches != 1:
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
        flosses = [float(fstep(st, fwav, fy)[1]) for _ in range(FLAGSHIP_STEPS)]
        torch.cuda.synchronize()
        f_launches = ff.LAUNCHES
        want = FLAGSHIP_STEPS if impl == "pallas" else 0
        if f_launches != want or not np.isfinite(flosses).all():
            raise RuntimeError(f"flagship train steps, {impl}: losses {flosses}, front-end "
                               f"launches {f_launches} (want {want})")
        peak = torch.cuda.max_memory_allocated() / 1e9
        flagship[impl] = {"losses": flosses, "frontend_launches": f_launches,
                          "peak_memory_gb": peak}
        print(f"flagship train step, {impl} front-end, batch {FLAGSHIP_BATCH} x 10 s: losses "
              f"{flosses}; peak memory {peak:.2f} GB; front-end launches {f_launches} {tag}")
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

    # 6c. the training leftovers: augmented fit on the DataLoader pipeline,
    # the flagship step with remat, the SED harness
    leftovers, leftover_fe = _train_leftovers(state_dict, fwav, fy, zero_counts, tag)
    record["train_leftovers"] = leftovers

    # 7. times
    # the fused front-end at the serving and the training shape: per mode,
    # at the frame tile tile_frames picks and at each tile that fits, and
    # the plain version
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count

    def time_frontend(w, fcfg):
        kp, np_ = ff.padded_sizes(fcfg)
        _, _, used, _, _, _ = ff._framing_plan(fcfg, w.shape[1])
        t = {"ms": {}, "plain_ms": {}, "tile": {}, "tile_ms": {}}
        for p in TOL:
            t["ms"][p] = device_median_ms(lambda p=p: ff.fused_log_mel_patches(w, fcfg, p))
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
            ms, bnd = t["ms"][p], fb["bound_ms"][p]
            tiles = ", ".join(f"BM {bm} {ms:.4f}" for bm, ms in t["tile_ms"][p].items())
            print(f"time: fused_log_mel_patches {p} {site} {shape}: {ms:.4f} ms (BM "
                  f"{t['tile'][p]}), plain version {t['plain_ms'][p]:.4f} ms, bound {bnd:.4f} "
                  f"ms ({fb['bound_by'][p]}); share of bound {bnd / ms:.4f}; per tile: {tiles} "
                  f"{tag}")

    wav = (torch.randn((8, srv.chunk_samples), generator=gen) * 0.1).cuda()
    b, n = wav.shape
    st = time_frontend(wav, scfg.frontend)
    sbound = _frontend_bound(ff, trimmed_spectral_bases, scfg.frontend, b, n)
    report_frontend("serving", wav, st, sbound)
    bound = sbound["bound_ms"]
    kernel_ms, plain_ms = st["ms"], st["plain_ms"][MAIN_PRECISION]

    tprec = tcfg.frontend.precision
    w64 = (torch.randn((bs, x1.shape[1]), generator=gen) * 0.1).cuda()
    tt = time_frontend(w64, tcfg.frontend)
    tbound = _frontend_bound(ff, trimmed_spectral_bases, tcfg.frontend, *w64.shape)
    report_frontend("training", w64, tt, tbound)
    train_kernel_ms, train_plain_ms = tt["ms"][tprec], tt["plain_ms"][tprec]

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

    # the front-end kernel at the flagship's site (bench.py's batch, "default")
    fw = (torch.randn((FLAGSHIP_BATCH, 10 * sr), generator=gen) * 0.1).cuda()
    fprec = fcfg.frontend.precision
    fbound = _frontend_bound(ff, trimmed_spectral_bases, fcfg.frontend, *fw.shape)
    flagship_fe = {"ms": device_median_ms(lambda: ff.fused_log_mel_patches(fw, fcfg.frontend,
                                                                           fprec)),
                   "plain_ms": device_median_ms(lambda: ff.fused_log_mel_patches_reference(
                       fw, fcfg.frontend, fprec)),
                   "torch_ops_ms": device_median_ms(lambda: fe.waveform_to_patches(
                       fw, fcfg.frontend)),
                   "bound_ms": fbound["bound_ms"][fprec], "bound_by": fbound["bound_by"][fprec],
                   "precision": fprec, "shape": list(fw.shape)}
    print(f"time: fused_log_mel_patches {fprec} flagship {list(fw.shape)}: "
          f"{flagship_fe['ms']:.4f} ms, plain version {flagship_fe['plain_ms']:.4f} ms, "
          f"torch-ops front-end (impl xla) {flagship_fe['torch_ops_ms']:.4f} ms, bound {flagship_fe['bound_ms']:.4f} ms "
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

    for wire in EXPORT_WIRES:  # reported, not gated: the host clock moves between calls
        tk = ticks[wire]["ms"]
        print(f"time: export streaming chunk call, {wire}, ring {TIMELINE_CAP}: host "
              f"{export_rec['streaming'][wire]['chunk_host_ms']:.4f} ms (median of the run's "
              f"calls) beside the live server's tick_packed {tk['packed']:.4f} ms"
              + (f", with the ring {tk['ring packed']:.4f} ms" if "ring packed" in tk else "")
              + f" {tag}")

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
    # the augmented step (mixup + SpecAugment) against the plain one, in turns
    # from the same weights on the same batch, then its own profile
    acfg = get_config("us8k_fused_frontend", AUG_TRAIN_CUT)
    am = build_model(acfg.model, seed=SEED)
    am.load_state_dict(state.model.state_dict())
    astate = create_train_state(acfg, am)
    astep = make_train_step(acfg, am, "waveform", clip_samples=x1.shape[1])
    aug_turns, _ = _in_turns({"plain": lambda: step(state, x1, y1),
                              "augmented": lambda: astep(astate, x1, y1)})
    aug_prof = _report_profile("augmented train step", n_steps_prof, aug_turns["augmented"],
                               _profile(lambda: astep(astate, x1, y1), n_steps_prof), tag)
    print(f"time: augmented us8k train step (mixup + SpecAugment), host clock in turns with the "
          f"plain step ({REPS} each): {aug_turns['augmented']:.4f} ms against "
          f"{aug_turns['plain']:.4f} ms; device busy {aug_prof['device_busy_ms']} against "
          f"{step_prof['device_busy_ms']} ms; idle share {aug_prof['idle_share']} against "
          f"{step_prof['idle_share']} {tag}")
    leftovers["augmented_step"] = {"turns_ms": aug_turns, "profile": aug_prof}
    del am, astate, astep
    record.update(kernel_ms=kernel_ms, plain_ms=plain_ms, frontend_serving=st,
                  frontend_training=tt, tick_ms=tick_med, bound_ms=bound,
                  bound_ms_f32_cores=sbound["f32_cores_ms"], bytes=sbound["bytes"],
                  dft_flops=sbound["dft_flops"], mel_flops=sbound["mel_flops"],
                  max_abs_err=errs, tick_profile=tick_prof, train_step_ms=step_med,
                  train_clips_per_s=clips_s, train_step_profile=step_prof,
                  train_frontend={"ms": train_kernel_ms, "plain_ms": train_plain_ms,
                                  "precision": tprec, "shape": list(w64.shape), **tbound},
                  frontend_launches={"serve": serve_launches, "train": train_launches},
                  peak_memory_gb=peak_gb, adpcm4_tick_ms=atick_med,
                  adpcm4_tick_profile=atick_prof)

    # 8. the doctor, the parity harness, the TensorBoard sink and the
    # streamed adpcm4 feed
    phase8, phase8_fe, phase8_dec = _doctor_parity_logging(zero_counts, tag)
    record["phase8"] = phase8

    # 9. the checkpoint verbs (on phase 6's trained workspace and phase 5's
    # serving weights) and the native ingest library
    # and under PyTorch's default cuDNN TF32 flag, as the verbs' subprocesses
    # run, so that their outputs can be held bit-equal against this process's
    torch.backends.cudnn.allow_tf32 = True
    try:
        phase9, phase9_fe = _checkpoint_verbs(state_dict, record["packages"], step_med,
                                              zero_counts, tag)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    record["phase9"] = phase9

    # 10. parallelism on the one card: the stream-sharded server, context-
    # parallel scoring, data parallelism on one NCCL rank and on two gloo ranks
    phase10, phase10_fe, phase10_dec = _parallelism(scfg, state_dict, streams, schedule,
                                                    zero_counts, check_launches, tag)
    record["phase10"] = phase10

    # 11. tensor parallelism on the one card: the rule, fits over the model
    # axis on gloo ranks, the server over TP-sharded weights, the dryrun
    phase11, phase11_fe, phase11_dec = _tensor_parallelism(
        scfg, state_dict, state_dict2, streams, schedule, zero_counts, check_launches, tag)
    record["phase11"] = phase11
    dec_by_path.update(phase8_dec)
    dec_by_path.update(phase10_dec)
    dec_by_path.update(phase11_dec)
    dec_launches_by_variant = {v: sum(p[v] for p in dec_by_path.values())
                               for v in DECODE_VARIANTS}

    main_probe = _probe_key(*PROBE_CASES[0][:3])
    # the front-end kernel's launches on every path that takes it
    fe_by_path = {"serve": serve_launches, "train": train_launches,
                  "serve_adpcm4": adpcm_serve["adpcm4"]["frontend_launches"],
                  "serve_adpcm2": adpcm_serve["adpcm2"]["frontend_launches"],
                  **{p: r["frontend_launches"] for p, r in new_paths.items()},
                  "train_adpcm4": a_fe, **leftover_fe, "flagship_forward": fwd_launches,
                  "flagship_train": flagship["pallas"]["frontend_launches"], **phase8_fe,
                  **phase9_fe, **phase10_fe, **phase11_fe}
    kernels = [{
        "name": "fused_log_mel_patches",
        "route": "cuda",
        "source": "mla_tpu_torch/csrc/fused_frontend.cu",
        "replaces": "mla_tpu/ops/pallas_frontend.py:154",
        "launches": sum(fe_by_path.values()),
        "launches_by_path": fe_by_path,
        "max_abs_err": errs[f"serve [8, 77120] {MAIN_PRECISION}"],
        "max_abs_err_by_case": errs,
        "ms": kernel_ms[MAIN_PRECISION],
        "kernel_ms": kernel_ms,
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
                  "max_abs_err": errs[f"train [64, 64000] {tprec}"],
                  "kernel_ms": tt["ms"],
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
    na_rec = record["norm_act"]
    na_tag, na_train = na_rec["tag_eight_blocks"], na_rec["train_eight_blocks"]
    kernels.append({
        "name": "norm_act",
        "route": "cuda",
        "source": "mla_tpu_torch/csrc/norm_act.cu",
        "replaces": None,
        "replaces_note": "port-only: flax nn.BatchNorm + ReLU (mla_tpu/models/trunk.py) left to "
                         "XLA, no pallas_call",
        "launches": na_rec["launches"],
        "ms": na_tag["ms"]["apply"],
        "plain_ms": na_tag["plain_ms"]["apply"],
        "bound_ms": na_tag["bound_ms"]["apply"],
        "bound_by": "bytes",
        "library_ms": na_tag["library_ms"]["apply"],
        "library_call": "torch.relu(F.batch_norm(x, ...))",
        "site": "apply, the eight blocks of a tag forward (1,280 patches)",
        "train": na_train,
        "main_path": {"tag": na_rec["tag_main_path"], "train": na_rec["train_main_path"]},
        "by_shape": na_rec["shapes"],
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
    if sys.argv[1:2] == ["--dp-worker"]:  # one rank of phase 10's gloo launch
        sys.exit(_dp_worker(sys.argv[2]))
    sys.exit(main())
