"""The port's spans (``utils/profiling.py``): off, ``annotate`` creates
nothing; under ``torch.profiler`` spans nest per thread, sit on the
profiler's timeline and on ``perf_counter_ns``, turn their device events
into ``device_ms`` when read (with stand-in events here), and the store
stays bounded; ``trace`` empties the store when it ends. The spans the
program records: the tick loop's (one ``mla.tick`` a tick with its row
counts, the rows from the server's own count, one ``mla.queue`` a chunk
ending at its gather, the client's read), the train step's phases in order,
and one ``mla.trunk.norm_act`` a trunk block. All on the CPU at a tiny
size."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import collections  # noqa: E402
import itertools  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.autograd.profiler as autograd_profiler  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from mla_tpu_torch.config import get_config  # noqa: E402
from mla_tpu_torch.entry import flagship_forward  # noqa: E402
from mla_tpu_torch.models.trunk import CompactCNN  # noqa: E402
from mla_tpu_torch.models.zoo import build_model  # noqa: E402
from mla_tpu_torch.serve.server import BatchedStreamingServer  # noqa: E402
from mla_tpu_torch.serve.ticker import TickLoop  # noqa: E402
from mla_tpu_torch.train.state import create_train_state, make_train_step  # noqa: E402
from mla_tpu_torch.utils import profiling  # noqa: E402

SMALL = {"model.conv_channels": "8,16", "model.convs_per_stage": 2, "model.embed_dim": 16,
         "model.hidden_units": 32, "model.n_classes": 5, "model.compute_dtype": "float32",
         "data.clip_seconds": 2.0}
N_BLOCKS = 4  # two stages of two convolutions
JOIN_S = 60


@pytest.fixture
def store():
    """An empty store before and after the test."""
    profiling.clear()
    yield
    profiling.clear()


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


class _FakeEvent:
    """A CUDA timing event stand-in: each record reads a clock that moves
    by 1 ms."""

    clock = itertools.count()
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = float(next(self.clock))

    def elapsed_time(self, other):
        return other.t - self.t


@pytest.fixture
def fake_card(monkeypatch):
    """torch.cuda's events, streams and synchronize stood in; returns the
    list of devices synchronize was called with."""
    synced = []
    _FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    return synced


def test_profiler_flag_is_process_wide():
    """The flag ``enabled`` reads: set by the profiler on one thread, read
    True on another, cleared when it stops."""
    seen = []
    assert not autograd_profiler._is_profiler_enabled and not profiling.enabled()
    with _profiler():
        t = threading.Thread(target=lambda: seen.append(profiling.enabled()))
        t.start()
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
        assert autograd_profiler._is_profiler_enabled is True
    assert seen == [True] and not profiling.enabled()


def test_recorded_is_the_profiled_thread():
    """``recorded`` reads the profiler's thread-local state: True on the
    thread that started it, False on another and once it stops."""
    seen = []
    assert not profiling.recorded()
    with _profiler():
        t = threading.Thread(target=lambda: seen.append(profiling.recorded()))
        t.start()
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
        assert profiling.recorded() and profiling.enabled()
    assert seen == [False] and not profiling.recorded()


def test_trace_writes_spans_and_empties_the_store(store, tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("mla.traced", k=1):
            torch.ones(4).sum()
        assert [s.name for s in profiling.spans()] == ["mla.traced"]
    assert profiling.spans() == []
    (path,) = tmp_path.glob("trace_*.json")
    assert "mla.traced" in path.read_text()


def test_off_records_nothing(store, fake_card, monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: made.append(name))
    span = profiling.annotate("mla.x", torch.device("cuda"), k=1)
    assert span is profiling.annotate("mla.y") and not span
    with span as s, s.phase("mla.x.a"):
        s.set(k=2)
    profiling.record("mla.q", 1, 2, stream=0)
    assert profiling.spans() == [] and made == [] and _FakeEvent.made == 0
    assert fake_card == []


def test_spans_nest_per_thread_on_the_profiler_timeline(store):
    ready = threading.Barrier(2, timeout=JOIN_S)
    bounds = {}

    def work(tag):
        lo = time.perf_counter_ns()
        with profiling.annotate(f"mla.{tag}.outer", rank=tag == "main"):
            ready.wait()
            with profiling.annotate(f"mla.{tag}.inner"):
                torch.ones(8).sum()
            ready.wait()
        bounds[tag] = (lo, time.perf_counter_ns())

    with _profiler() as prof:
        t = threading.Thread(target=work, args=("side",))
        t.start()
        work("main")
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    got = {s.name: s for s in profiling.spans()}
    assert len(got) == 4
    for tag in ("main", "side"):
        outer, inner = got[f"mla.{tag}.outer"], got[f"mla.{tag}.inner"]
        lo, hi = bounds[tag]
        assert outer.parent == 0 and inner.parent == outer.id and outer.thread == inner.thread
        assert lo <= outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns <= hi
        assert inner.device_ms is None
    assert got["mla.main.outer"].thread == threading.get_native_id()
    assert got["mla.side.outer"].thread != got["mla.main.outer"].thread
    assert got["mla.main.outer"].attrs == {"rank": True}
    events = prof.events()
    main_ops = {e.thread for e in events if e.name == "aten::ones"}
    for name in ("mla.main.outer", "mla.main.inner"):
        assert {e.thread for e in events if e.name == name} <= main_ops
        assert any(e.name == name for e in events)


def test_spans_from_many_threads_keep_ids_and_parents(store):
    """More threads than cores append at once, switching often: no span is
    lost, ids are unique, and every inner span's parent is its own
    thread's outer span."""
    n_threads, n_spans = 16, 100
    start = threading.Barrier(n_threads, timeout=JOIN_S)

    def work():
        start.wait()
        for i in range(n_spans):
            with profiling.annotate("mla.outer", i=i):
                with profiling.annotate("mla.inner", i=i):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiler():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=JOIN_S)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = profiling.spans()
    assert len(spans) == 2 * n_threads * n_spans == len({s.id for s in spans})
    outer = {s.id: s for s in spans if s.name == "mla.outer"}
    for s in spans:
        if s.name == "mla.inner":
            parent = outer[s.parent]
            assert (parent.thread, parent.attrs) == (s.thread, s.attrs)
    assert len({s.thread for s in spans}) == n_threads


def test_device_time_phases_share_events(store, fake_card):
    """Phases back to back take one event per boundary, and the reading
    waits for the card once."""
    dev = torch.device("cuda", 0)
    with _profiler():
        with profiling.annotate("mla.step", dev, step=3) as span:
            with span.phase("mla.step.a"):
                pass
            with span.phase("mla.step.b", part=1):
                pass
    assert _FakeEvent.made == 4  # the step's start, a | b, b's end, the step's end
    got = {s.name: s for s in profiling.spans()}
    assert fake_card == [dev]
    assert got["mla.step.a"].device_ms == 1.0 and got["mla.step.b"].device_ms == 1.0
    assert got["mla.step"].device_ms == 3.0 and got["mla.step"].attrs == {"step": 3}
    assert got["mla.step.b"].parent == got["mla.step"].id and got["mla.step.b"].attrs == {"part": 1}
    profiling.spans()
    assert fake_card == [dev]  # resolved once


def test_spans_filter_and_store_bound(store, monkeypatch):
    assert profiling._STORE.maxlen == profiling.MAX_SPANS >= 1 << 20
    monkeypatch.setattr(profiling, "_STORE", collections.deque(maxlen=4))
    with _profiler():
        for i in range(10):
            profiling.record("mla.q" if i % 2 else "mla.r", 100 + i, 200 + i, i=i)
    assert [s.attrs["i"] for s in profiling.spans()] == [6, 7, 8, 9]
    assert [s.attrs["i"] for s in profiling.spans("mla.q")] == [7, 9]
    assert [s.attrs["i"] for s in profiling.spans(since_ns=107, until_ns=108)] == [7, 8]
    copy = profiling.spans("mla.q")[0]
    copy.attrs["i"] = -1
    assert profiling.spans("mla.q")[0].attrs == {"i": 7}


def _tick_loop(max_streams=4, chunk_patches=2):
    cfg = get_config("streaming_inference", SMALL)
    state_dict = build_model(cfg.model, device="cpu", seed=0).state_dict()
    srv = BatchedStreamingServer(cfg, state_dict, max_streams=max_streams,
                                 chunk_patches=chunk_patches, device="cpu")
    return TickLoop(srv)


def test_tick_loop_spans(store):
    loop = _tick_loop()
    srv = loop.srv
    n_chunks = 3
    sids = [loop.open() for _ in range(3)]
    audio = (np.random.default_rng(0).standard_normal(
        (len(sids), srv.chunk_samples + (n_chunks - 1) * srv.hop_samples)) * 0.1).astype(
        np.float32)
    pieces = [audio[:, :srv.chunk_samples]] + [
        audio[:, srv.chunk_samples + k * srv.hop_samples:][:, :srv.hop_samples]
        for k in range(n_chunks - 1)]
    try:
        with _profiler():
            ticks0, streams0, rows0 = loop.ticks, loop.ticked_streams, srv.patch_rows
            for piece in pieces:
                for sid, row in zip(sids, piece):
                    loop.feed(sid, row, sync=False)
                for sid in sids:
                    loop.scores(sid)
            ticks, streams = loop.ticks - ticks0, loop.ticked_streams - streams0
            rows = srv.patch_rows - rows0
    finally:
        loop.stop()
    spans = profiling.spans()
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s.name].append(s)
    cp = srv.chunk_patches
    assert len(by_name["mla.tick"]) == ticks >= n_chunks
    assert sorted(s.attrs["tick"] for s in by_name["mla.tick"]) == list(
        range(ticks0, ticks0 + ticks))
    for t in by_name["mla.tick"]:
        assert t.attrs["rows"] == srv.S * cp
        assert t.attrs["ready_rows"] == t.attrs["streams"] * cp
        assert [c.name for c in _children(spans, t)] == [
            "mla.tick.gather", "mla.tick.upload", "mla.tick.step"]
    assert sum(t.attrs["streams"] for t in by_name["mla.tick"]) == streams
    assert sum(t.attrs["rows"] for t in by_name["mla.tick"]) == rows
    ratio = (sum(t.attrs["rows"] for t in by_name["mla.tick"])
             / sum(t.attrs["ready_rows"] for t in by_name["mla.tick"]))
    assert ratio == srv.S * ticks / streams
    gathers = {t.attrs["tick"]: _children(spans, t)[0] for t in by_name["mla.tick"]}
    queue = by_name["mla.queue"]
    assert len(queue) == streams == len(sids) * n_chunks
    for q in queue:
        assert q.start_ns <= q.end_ns == gathers[q.attrs["tick"]].start_ns
    for sid in sids:
        seqs = [q.attrs["seq"] for q in queue if q.attrs["stream"] == sid]
        assert seqs == list(range(n_chunks))
    assert len(by_name["mla.scores.read"]) == len(sids) * n_chunks
    assert set(by_name) == {"mla.tick", "mla.tick.gather", "mla.tick.upload", "mla.tick.step",
                            "mla.queue", "mla.scores.read"}  # no trunk span: unrecorded thread


def test_tick_loop_seq_numbers_chunks_within_their_stream(store):
    """A chunk made ready before the profiler started has no queue span;
    one feed can make several chunks ready, and a feed while chunks still
    wait numbers its own after them."""
    loop = _tick_loop(max_streams=2)
    srv = loop.srv
    sid = loop.open()
    hop = srv.hop_samples
    audio = np.zeros(srv.chunk_samples + 4 * hop, np.float32)
    try:
        loop.feed(sid, audio[:srv.chunk_samples])
        with _profiler():
            loop.feed(sid, audio[srv.chunk_samples:][:3 * hop], sync=False)
            loop.feed(sid, audio[srv.chunk_samples + 3 * hop:], sync=False)
            loop.scores(sid)
    finally:
        loop.stop()
    assert [(q.attrs["stream"], q.attrs["seq"]) for q in profiling.spans("mla.queue")] == [
        (sid, 1), (sid, 2), (sid, 3), (sid, 4)]


def test_train_step_phases_and_trunk_blocks(store):
    cfg = get_config("audioset_full_dp", {**SMALL, "train.batch_size": 2})
    model = build_model(cfg.model, device="cpu", seed=0)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg, model, "waveform")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 32000)).astype(
        np.float32) * 0.1)
    y = torch.zeros(2, cfg.model.n_classes)
    with _profiler():
        step(state, x, y)
    spans = profiling.spans()
    (top,) = [s for s in spans if s.name == "mla.train.step"]
    assert top.attrs == {"step": 0} and top.parent == 0
    phases = _children(spans, top)
    assert [p.name for p in phases] == ["mla.train.frontend", "mla.train.forward",
                                        "mla.train.backward", "mla.train.optimizer"]
    edges = [top.start_ns] + [t for p in phases for t in (p.start_ns, p.end_ns)] + [top.end_ns]
    assert edges == sorted(edges)
    blocks = [s for s in spans if s.name == "mla.trunk.norm_act"]
    assert [b.attrs["block"] for b in blocks] == list(range(N_BLOCKS))
    assert {b.parent for b in blocks} == {phases[1].id}


def test_flagship_forward_span(store):
    cfg = get_config("audioset_full_dp", SMALL)
    model = build_model(cfg.model, device="cpu", seed=0).eval()
    with _profiler():
        flagship_forward(cfg)(model, torch.zeros(2, 32000))
    spans = profiling.spans()
    (fwd,) = [s for s in spans if s.name == "mla.forward"]
    assert len(_children(spans, fwd)) == N_BLOCKS
    assert all(c.name == "mla.trunk.norm_act" for c in _children(spans, fwd))


@pytest.mark.parametrize("norm", ["batch", "group", "none"])
def test_trunk_norm_act_span_per_block(store, norm):
    trunk = CompactCNN(conv_channels=(8, 16, 16), convs_per_stage=1, embed_dim=8, norm=norm,
                       dtype=torch.float32)
    with _profiler():
        trunk(torch.zeros(2, 16, 8))
    blocks = profiling.spans("mla.trunk.norm_act")
    assert [b.attrs["block"] for b in blocks] == [0, 1, 2]
    assert all(b.parent == 0 and b.start_ns <= b.end_ns for b in blocks)


def test_trunk_block_spans_only_on_a_recorded_thread(store, monkeypatch):
    """The blocks' spans, with device time, on the profiler's own thread,
    and none on a thread it leaves out (as the tick thread is)."""
    asked = []
    annotate = profiling.annotate

    def spy(name, device=None, **attrs):
        if name == "mla.trunk.norm_act":
            asked.append((threading.get_ident(), device))
        return annotate(name, device, **attrs)

    monkeypatch.setattr(profiling, "annotate", spy)
    trunk = CompactCNN(conv_channels=(8, 16), convs_per_stage=1, embed_dim=8,
                       dtype=torch.float32)
    x = torch.zeros(2, 16, 8)
    with _profiler():
        trunk(x)
        t = threading.Thread(target=trunk, args=(x,))
        t.start()
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    assert asked == [(threading.get_ident(), x.device)] * 2
    assert len(profiling.spans("mla.trunk.norm_act")) == 2
