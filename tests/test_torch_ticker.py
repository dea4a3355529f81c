"""The PyTorch port's TickLoop (serve/ticker.py): threads feeding distinct
streams through the one tick thread score as a serial drive of the port's
server does, an open()'s slot reset is not lost to an in-flight tick, async
feeds are bounded by backpressure, and the port's loop agrees with JAX's on
the same audio."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mla_tpu.serve.server import BatchedStreamingServer as JaxServer  # noqa: E402
from mla_tpu.serve.ticker import TickLoop as JaxTickLoop  # noqa: E402
from mla_tpu_torch.serve.server import BatchedStreamingServer  # noqa: E402
from mla_tpu_torch.serve.streaming import _samples_per_patches  # noqa: E402
from mla_tpu_torch.serve.ticker import TickLoop  # noqa: E402
from tests.torch_port_common import configs, jax_weights, torch_state_dict  # noqa: E402

SERIAL_TOL = dict(rtol=1e-5, atol=1e-6)  # the loop against a serial drive of the port
JAX_TOL = dict(rtol=1e-4, atol=1e-5)  # the port against JAX (f32)
JOIN_S = 60


@pytest.fixture(scope="module")
def setup():
    # the front-end at "highest", as the reference's own tests run it (the
    # preset's "default" rounds the DFT to bf16, where the packages round apart)
    jcfg, tcfg = configs({"frontend.precision": "highest"})
    variables, flat = jax_weights(jcfg.model, seed=11)
    wav = (np.random.default_rng(7).standard_normal(16000 * 14) * 0.1).astype(np.float32)
    return jcfg, tcfg, variables, torch_state_dict(tcfg.model, flat), wav


def _server(tcfg, state_dict, max_streams):
    return BatchedStreamingServer(tcfg, state_dict, max_streams=max_streams, chunk_patches=3,
                                  device="cpu")


def _serial_scores(tcfg, state_dict, audio, max_streams, flush=False):
    """One stream through the port's server driven from this thread alone."""
    srv = _server(tcfg, state_dict, max_streams)
    sid = srv.open()
    srv.feed(sid, audio)
    srv.drain()
    if flush:
        srv.flush(sid)
    return srv.scores(sid)


def _run_threads(targets):
    errs = []

    def wrap(fn, *a):
        try:
            fn(*a)
        except Exception as e:  # reported below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=t) for t in targets]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in ts), "a feeding thread did not finish"
    assert not errs, errs


def test_concurrent_feeds_match_serial(setup):
    """4 threads, 4 streams, different audio each, feeds cut into odd
    blocks, the interpreter switching threads every 10 µs: every stream's
    scores equal its serial drive, and the loop batched its ticks."""
    _, tcfg, _, sd, wav = setup
    n = _samples_per_patches(tcfg.frontend, 6)  # 2 chunks of 3 patches
    audios = [(wav[:n] * g).astype(np.float32) for g in (1.0, 0.5, 0.25, 0.8)]
    loop = TickLoop(_server(tcfg, sd, 4), batch_grace=0.02)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        sids = [loop.open() for _ in audios]

        def client(sid, audio):
            for s in range(0, len(audio), 11111):
                loop.feed(sid, audio[s:s + 11111])

        _run_threads([(client, sid, a) for sid, a in zip(sids, audios)])
        assert loop.ticked_streams == 4 * 2 and loop.srv.dispatches == loop.ticks
        for sid, audio in zip(sids, audios):
            np.testing.assert_allclose(loop.scores(sid), _serial_scores(tcfg, sd, audio, 4),
                                       **SERIAL_TOL)
            loop.close(sid)
    finally:
        sys.setswitchinterval(old)
        loop.stop()
    assert not loop._thread.is_alive()


def test_lockstep_streams_share_ticks(setup):
    """Chunk-sized feeds from 4 threads in lockstep: the grace window merges
    them, so a tick serves more than one stream on average."""
    _, tcfg, _, sd, wav = setup
    audio = wav[:_samples_per_patches(tcfg.frontend, 3)]
    loop = TickLoop(_server(tcfg, sd, 4), batch_grace=0.5)
    try:
        sids = [loop.open() for _ in range(4)]
        rounds = 3
        barrier = threading.Barrier(4, timeout=JOIN_S)

        def client(sid):
            for _ in range(rounds):
                barrier.wait()
                loop.feed(sid, audio)

        _run_threads([(client, sid) for sid in sids])
        assert loop.ticked_streams == 4 * rounds
        assert loop.ticks <= 2 * rounds, (loop.ticks, loop.ticked_streams)
        want = _serial_scores(tcfg, sd, np.concatenate([audio] * rounds), 4)
        for sid in sids:
            np.testing.assert_allclose(loop.scores(sid), want, **SERIAL_TOL)
    finally:
        loop.stop()


def test_feed_advanced_and_flush_semantics(setup):
    """feed() returns the chunks it completed (the HTTP `advanced` field),
    sub-chunk feeds return 0, flush folds the tail as the serial server
    does, and errors propagate as the server raises them."""
    _, tcfg, _, sd, wav = setup
    loop = TickLoop(_server(tcfg, sd, 2))
    try:
        n1 = _samples_per_patches(tcfg.frontend, 3)
        sid = loop.open()
        assert loop.feed(sid, wav[: n1 // 2]) == 0
        assert loop.feed(sid, wav[n1 // 2: n1]) == 1
        tail_n = 16000  # more than one 15,360-sample patch, less than a chunk
        assert loop.feed(sid, wav[n1: n1 + tail_n]) == 0
        assert loop.pending(sid) > 0
        assert loop.flush(sid) is True
        np.testing.assert_allclose(
            loop.scores(sid), _serial_scores(tcfg, sd, wav[: n1 + tail_n], 2, flush=True),
            **SERIAL_TOL)
        with pytest.raises(RuntimeError):
            loop.scores(loop.open())  # a fresh stream, nothing processed
        with pytest.raises(KeyError):
            loop.feed(99, wav[:100])
    finally:
        loop.stop()


def test_open_reset_not_lost_to_inflight_tick(setup):
    """Closing and reopening a slot while another stream keeps ticking gives
    the new stream a clean state: the dev lock orders the slot reset against
    the tick's state swap (a lost reset would leak the previous occupant's
    accumulators into the new scores)."""
    _, tcfg, _, sd, wav = setup
    audio = wav[:_samples_per_patches(tcfg.frontend, 3)]
    loop = TickLoop(_server(tcfg, sd, 2), batch_grace=0.0)
    try:
        other = loop.open()
        stop = threading.Event()
        errs = []

        def background():
            try:
                while not stop.is_set():
                    loop.feed(other, audio)
            except Exception as e:  # reported below
                errs.append(e)

        t = threading.Thread(target=background)
        t.start()
        try:
            for gain in (1.0, 0.3):
                sid = loop.open()
                a = (audio * gain).astype(np.float32)
                loop.feed(sid, a)
                np.testing.assert_allclose(loop.scores(sid), _serial_scores(tcfg, sd, a, 2),
                                           **SERIAL_TOL)
                loop.close(sid)
        finally:
            stop.set()
            t.join(timeout=JOIN_S)
        assert not t.is_alive() and not errs, errs
    finally:
        loop.stop()


def test_async_feeds_match_serial_and_backpressure(setup):
    """sync=False feeds return once buffered, yet scores reflect every fed
    chunk; backpressure bounds the backlog."""
    _, tcfg, _, sd, wav = setup
    n1 = _samples_per_patches(tcfg.frontend, 3)
    audio = wav[: n1 * 4]
    loop = TickLoop(_server(tcfg, sd, 2), batch_grace=0.0)
    try:
        sid = loop.open()
        for s in range(0, len(audio), n1):
            loop.feed(sid, audio[s: s + n1], sync=False, max_backlog=2)
            with loop.cond:
                assert loop.srv.chunks_ready(sid) <= 3  # the backlog + the one appended
        np.testing.assert_allclose(loop.scores(sid), _serial_scores(tcfg, sd, audio, 2),
                                   **SERIAL_TOL)
        assert loop.backlog() == 0
    finally:
        loop.stop()


@pytest.mark.parametrize("wire", ["int16", "adpcm4"])
def test_tick_loop_matches_jax_tick_loop(setup, wire):
    """The same three streams, fed from three threads each into the port's
    loop and JAX's, flushed, then scores and timelines read through the
    loops: equal within the cross-package tolerance."""
    jcfg, tcfg, variables, sd, wav = setup
    audios = [(wav[i * 20000: i * 20000 + 90000 + i * 7777] * (1 - 0.2 * i)).astype(np.float32)
              for i in range(3)]

    def drive(loop):
        sids = [loop.open() for _ in audios]

        def client(sid, audio):
            for s in range(0, len(audio), 9001):
                loop.feed(sid, audio[s:s + 9001])
            loop.flush(sid)

        _run_threads([(client, sid, a) for sid, a in zip(sids, audios)])
        out = [(loop.scores(sid), loop.timeline_with_scores(sid)) for sid in sids]
        return out, loop.ticked_streams

    ours = TickLoop(BatchedStreamingServer(tcfg, sd, max_streams=3, chunk_patches=2,
                                           transfer_dtype=wire, timeline_cap=8,
                                           device="cpu"))
    ref = JaxTickLoop(JaxServer(jcfg, variables, max_streams=3, chunk_patches=2,
                                transfer_dtype=wire, timeline_cap=8))
    try:
        (got, got_folds), (want, want_folds) = drive(ours), drive(ref)
    finally:
        ours.stop()
        ref.stop()
    assert got_folds == want_folds
    for (s, (s2, start, levels)), (ws, (ws2, wstart, wlevels)) in zip(got, want):
        np.testing.assert_allclose(s, ws, **JAX_TOL)
        np.testing.assert_allclose(s2, s, rtol=0, atol=1e-6)
        assert start == wstart and len(levels) == len(wlevels)
        for (w, f), (ww, wf) in zip(levels, wlevels):
            np.testing.assert_allclose(w, np.asarray(ww), **JAX_TOL)
            np.testing.assert_allclose(f, np.asarray(wf), **JAX_TOL)
