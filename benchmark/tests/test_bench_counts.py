"""The yardstick's operation and byte counts against hand counts at one
patch, the frozen copies against the program's own, and the reductions the
readers make."""

import types

import pytest

from benchmark import core, tracing, yardstick

FULL = core.load_json(core.BENCH / "configs" / "audioset_full_dp.json")
FE, MODEL = FULL["frontend"], FULL["model"]


def test_frontend_geometry_by_hand():
    # 16 kHz, 25 ms / 10 ms -> 400 / 160 samples, FFT 512 (bins of 31.25 Hz);
    # 7500 Hz is bin 240, where the top band's triangle ends: 240 bins carry mel weight
    g = yardstick.frontend_geometry(FE)
    assert (g["window"], g["hop"], g["fft"], g["bins"], g["patch_frames"]) == (400, 160, 512,
                                                                               240, 96)
    f = yardstick.frontend_flops_per_frame(FE)
    assert f == {"dft": 2 * 2 * 400 * 240, "mel": 2 * 240 * 64}


def test_trunk_and_heads_by_hand_at_one_patch():
    convs = (2 * 9 * (1 * 64 + 64 * 64) * 96 * 64 + 2 * 9 * (64 * 128 + 128 * 128) * 48 * 32
             + 2 * 9 * (128 * 256 + 256 * 256) * 24 * 16 + 2 * 9 * (256 * 512 + 512 * 512) * 12 * 8)
    assert convs == 2_498_494_464
    assert yardstick.trunk_flops_per_patch(MODEL, FE) == convs + 2 * 512 * 128
    heads = 2 * 128 * 512 + 2 * (2 * 512 * 512) + 3 * (2 * 2 * 512 * 527)
    assert yardstick.head_flops_per_patch(MODEL) == heads
    assert yardstick.head_flops_per_clip(MODEL) == 2 * 1581 * 527
    per_patch = 96 * (384_000 + 30_720) + convs + 2 * 512 * 128 + heads
    assert yardstick.forward_flops_per_patch(MODEL, FE) == per_patch
    assert yardstick.clip_patches(10.0, FE) == 10
    assert yardstick.tag_flops_per_clip(MODEL, FE, 10.0) == 10 * per_patch + 2 * 1581 * 527
    front = 10 * 96 * (384_000 + 30_720)
    assert yardstick.train_flops_per_clip(MODEL, FE, 10.0) == front + 3 * (
        10 * (convs + 2 * 512 * 128 + heads) + 2 * 1581 * 527)


def test_frontend_bytes_and_bound_by_hand():
    # one 5-patch chunk: 77120 samples in (the frames' span), 480 x 64 out, f32
    assert yardstick.frontend_bytes_moved(1, 77120, FE) == 77120 * 4 + 480 * 64 * 4
    ops = 480 * (384_000 / yardstick.PEAK_BF16_FLOPS + 30_720 / yardstick.PEAK_F32_FLOPS)
    assert yardstick.frontend_bound_s(1, 77120, FE, "default") == pytest.approx(ops, rel=1e-12)
    assert ops > (77120 * 4 + 480 * 64 * 4) / yardstick.PEAK_BYTES  # bound by operations


@pytest.mark.parametrize("shape", [(1, 15680), (8, 77120), (3, 160000), (2, 77200)])
def test_frozen_copies_match_the_program(shape):
    from mla_tpu_torch.config import FrontendConfig
    from mla_tpu_torch.ops.frontend import trimmed_spectral_bases
    from mla_tpu_torch.ops.fused_frontend import frontend_bytes_moved

    cfg = FrontendConfig()
    assert yardstick.frontend_bytes_moved(*shape, FE) == frontend_bytes_moved(*shape, cfg)
    assert yardstick.frontend_geometry(FE)["bins"] == trimmed_spectral_bases(cfg)[3]


def test_nearest_rank():
    v = list(range(1, 101))
    assert core.nearest_rank(v, 0.95) == 95 and core.nearest_rank(v, 0.5) == 50
    assert core.nearest_rank([7.0], 0.95) == 7.0


def _event(name, start, end, cuda):
    dt = tracing.torch.autograd.DeviceType
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start, end=end),
                                 device_type=dt.CUDA if cuda else dt.CPU)


def test_trace_summary_busy_and_gaps():
    events = [_event("k1", 100, 300, True), _event("k2", 250, 400, True),
              _event("k1", 700, 800, True), _event("ProfilerStep#1", 0, 1000, True),
              _event("step", 0, 500, False), _event("aten::mm", 520, 690, False),
              _event("cudaMemcpyAsync", 380, 900, False), _event("aten::cat", 790, 850, False),
              _event("traced_window", 0, 1000, True)]
    events = [_event(e.name, e.time_range.start + 50, e.time_range.end + 50,
                     e.device_type == tracing.torch.autograd.DeviceType.CUDA) for e in events]
    events.append(_event(tracing.WINDOW, 50, 1050, False))  # the window, on the profiler's clock
    s = tracing.summarize(types.SimpleNamespace(events=lambda: events))
    assert s["busy_s"] == pytest.approx(400e-6) and s["window_s"] == pytest.approx(1e-3)
    assert s["device_ops"][0] == ("k1", pytest.approx(300e-6))
    assert s["idle_gaps"][0] == ["step", pytest.approx(300e-6)]  # 400 -> 700
    # a span first; then the work begun last, not a wait for the card
    assert [g[0] for g in s["idle_gaps"]] == ["step", "aten::cat", "step"]
    assert tracing.kernel_seconds(s, "k") == pytest.approx(450e-6)


@pytest.mark.parametrize("cell", [w["name"] for w in core.manifest()["workloads"]])
def test_a_traced_run_reads_its_per_layer_metrics(cell):
    """The traced path end to end at the tiny size on the CPU: the window's
    span, the reduction, every reader of the cell (the CPU has no device
    events, so the device's readers give 100% idle or nothing)."""
    from conftest import tiny_run

    params = {"chunk_patches": 1, "trace_seconds": 0.3} if cell.startswith("stream") else None
    run, traffic = tiny_run(cell, seconds=0.6, params=params, trace=True)
    assert not traffic.run(run)["failed"]
    s = run.tracer.summary
    assert 0.0 < s["window_s"] < 2.0 and s["busy_s"] == 0.0
    read = {m["name"]: core.load_module(core.BENCH / "metrics" / f"{m['name']}.py",
                                        "r_" + m["name"]).read(run)
            for m in core.metrics_of(core.manifest(), cell)["per_layer"]}
    assert all(v == 100.0 for k, v in read.items() if k.startswith("device_idle"))
    if cell.startswith("stream"):
        assert read["streams_per_tick.stream"] >= 1.0 and read["gen_late_p95_ms.stream"] >= 0.0
