"""The readers of the program's spans (``benchmark/program_spans.py`` and
the metrics whose source is ``program_span`` or ``program_counter``) on
synthetic spans in the program's store: nearest-rank p95, medians, the
ratio of sums, the traced-part filter, and None where nothing was traced."""

import collections
import types

import pytest

from benchmark import core
from mla_tpu_torch.utils import profiling

T0_NS, T1_NS = 10_000_000_000, 20_000_000_000
MS = 1_000_000


def _reader(name):
    return core.load_module(core.BENCH / "metrics" / f"{name}.py",
                            "benchmark_metric_" + name.replace(".", "_"))


def _run(t0_ns=T0_NS, t1_ns=T1_NS):
    tracer = types.SimpleNamespace(t0=None if t0_ns is None else t0_ns / 1e9,
                                   t1=None if t1_ns is None else t1_ns / 1e9)
    return types.SimpleNamespace(tracer=tracer)


@pytest.fixture
def store(monkeypatch):
    """An empty store of the program's; ``add(name, start_ns, ms, ...)``
    puts a span of ``ms`` host milliseconds in it and returns it."""
    monkeypatch.setattr(profiling, "_STORE", collections.deque(maxlen=1000))

    def add(name, start_ns, ms=1.0, parent=None, device_ms=None, **attrs):
        s = profiling.Span(name, None, attrs)
        s.start_ns, s.end_ns = start_ns, start_ns + int(ms * MS)
        s.parent, s.device_ms = (parent.id if parent is not None else 0), device_ms
        profiling._STORE.append(s)
        return s

    return add


def test_p95_by_nearest_rank_inside_the_traced_part(store):
    for i in range(40):
        store("mla.queue", T0_NS + i * MS, ms=float(i + 1), stream=0, seq=i, tick=i)
    store("mla.queue", T0_NS - MS, ms=500.0)  # before the traced part
    store("mla.queue", T1_NS + 1, ms=600.0)  # after it
    assert _reader("queue_wait_p95_ms.stream").read(_run()) == 38.0  # ceil(0.95 * 40) = 38th
    for i in range(20):
        store("mla.scores.read", T0_NS + i * MS, ms=float(20 - i))
    assert _reader("scores_read_p95_ms.stream").read(_run()) == 19.0


def test_tick_medians_and_rows_ratio(store):
    for i, (host, streams, up, step) in enumerate([(10, 2, 0.5, 40.0), (30, 3, 0.5, 41.0),
                                                   (20, 3, 1.0, 39.0)]):
        t = store("mla.tick", T0_NS + i * 50 * MS, ms=host, tick=i, streams=streams,
                  ready_rows=5 * streams, rows=1280)
        store("mla.tick.upload", t.start_ns + MS, parent=t, device_ms=up)
        store("mla.tick.step", t.start_ns + 2 * MS, parent=t, device_ms=step)
    # a tick whose step begins after the traced part closed counts whole
    late = store("mla.tick", T1_NS - MS, ms=5.0, tick=3, streams=2, ready_rows=10, rows=1280)
    store("mla.tick.upload", T1_NS - MS // 2, parent=late, device_ms=1.0)
    store("mla.tick.step", T1_NS + MS, parent=late, device_ms=60.0)
    store("mla.tick", T1_NS + 2 * MS, ms=99.0, tick=4, streams=1, ready_rows=5, rows=1280)
    run = _run()
    assert _reader("tick_host_ms.stream").read(run) == 15.0  # median of 10, 30, 20, 5
    assert _reader("tick_device_ms.stream").read(run) == 41.0  # median of 40.5, 41.5, 40, 61
    assert _reader("rows_per_ready_row.stream").read(run) == 4 * 1280 / 50


def test_train_phase_medians(store):
    for i, (fwd, bwd, opt) in enumerate([(110.0, 240.0, 1.0), (120.0, 250.0, 3.0),
                                          (130.0, 260.0, 2.0)]):
        step = store("mla.train.step", T0_NS + i * 400 * MS, device_ms=fwd + bwd + opt)
        store("mla.train.forward", step.start_ns + 1, parent=step, device_ms=fwd)
        store("mla.train.backward", step.start_ns + 2, parent=step, device_ms=bwd)
        store("mla.train.optimizer", step.start_ns + 3, parent=step, device_ms=opt)
    run = _run()
    assert _reader("forward_ms.train").read(run) == 120.0
    assert _reader("backward_ms.train").read(run) == 250.0
    assert _reader("optimizer_ms.train").read(run) == 2.0


def test_norm_act_share_of_the_traced_forwards(store):
    for i in range(2):
        fwd = store("mla.forward", T0_NS + i * 50 * MS, device_ms=40.0)
        for b in range(8):
            store("mla.trunk.norm_act", fwd.start_ns + b + 1, parent=fwd, device_ms=3.0,
                  block=b)
    outside = store("mla.forward", T0_NS - 100 * MS, device_ms=40.0)
    store("mla.trunk.norm_act", T0_NS - 99 * MS, parent=outside, device_ms=40.0, block=0)
    assert _reader("norm_act_share.tag").read(_run()) == 100.0 * 16 * 3.0 / 80.0


NEW = ["queue_wait_p95_ms.stream", "tick_host_ms.stream", "tick_device_ms.stream",
       "rows_per_ready_row.stream", "scores_read_p95_ms.stream", "forward_ms.train",
       "backward_ms.train", "optimizer_ms.train", "norm_act_share.tag"]


@pytest.mark.parametrize("name", NEW)
def test_none_without_spans(store, name):
    reader = _reader(name)
    assert reader.read(_run()) is None  # an empty store
    store("mla.other", T0_NS + MS)
    assert reader.read(_run()) is None
    assert reader.read(_run(t0_ns=None, t1_ns=None)) is None  # no traced part
    assert reader.read(types.SimpleNamespace(tracer=None)) is None


def test_none_where_the_program_has_no_spans(monkeypatch):
    """A program before its spans (no ``profiling.spans``): every reader
    gives None, and none raises."""
    monkeypatch.delattr(profiling, "spans")
    for name in NEW:
        assert _reader(name).read(_run()) is None, name


def test_new_metrics_declared_for_their_cells():
    per_layer = {m["name"]: m for m in core.manifest()["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["source"] == ("program_counter" if name.startswith("rows_per")
                               else "program_span")
        assert len(m["workloads"]) == 1
        assert core.metrics_of(core.manifest(), m["workloads"][0])["per_layer"]
