"""The localization timeline of the PyTorch port against the JAX package:
the on-device ring (TimelineState) bit for bit, the numpy window readout
for every gate, the packed readout and its extra lane, and the server's and
the streaming tagger's timelines and scores on the same weights and audio
for every streaming variant."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.ops import attention_pool as jap  # noqa: E402
from mla_tpu.serve.server import BatchedStreamingServer as JaxServer  # noqa: E402
from mla_tpu.serve.streaming import StreamingTagger as JaxTagger  # noqa: E402
from mla_tpu_torch.ops import attention_pool as ap  # noqa: E402
from mla_tpu_torch.ops import frontend as fe  # noqa: E402
from mla_tpu_torch.serve.server import BatchedStreamingServer  # noqa: E402
from mla_tpu_torch.serve.streaming import (  # noqa: E402
    STREAMING_VARIANTS,
    StreamingTagger,
    _samples_per_patches,
)
from tests.torch_port_common import configs, jax_weights, torch_model, torch_state_dict  # noqa: E402

TOL = 1e-4  # scores and window readouts, port against JAX (f32, convolutions summed apart)
GATES = ("exp", "max", "sigmoid", "relu", "softplus")


def _setup(variant, seed=0):
    jcfg, tcfg = configs({"model.variant": variant, "model.n_blocks": 2,
                          "model.n_attention_heads": 2})
    variables, flat = jax_weights(jcfg.model, seed)
    return jcfg, tcfg, variables, flat


def _wav(seed, n_patches, cfg):
    n = _samples_per_patches(cfg.frontend, n_patches)
    return (np.random.default_rng(seed).standard_normal(n) * 0.3).astype(np.float32)


def _both_rings(s, cap, levels, c):
    return (ap.init_timeline_state(s, cap, levels, c),
            jap.init_timeline_state(s, cap, levels, c))


def _assert_rings_equal(tl, jtl):
    for a, b in zip(tl, jtl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ring_semantics_and_jax_bit_equality():
    """Wrap-around, a masked flush patch and an inactive row, as the JAX
    package's own ring test states them, and the same ring bit for bit
    against JAX's update_timeline_state."""
    s, cap, p = 2, 4, 3
    tl, jtl = _both_rings(s, cap, 1, 3)

    def chunk(v):
        g = np.full((s, p, 1, 3), v, np.float32) + np.arange(p, dtype=np.float32)[None, :, None,
                                                                                    None]
        return g

    for v, active, n_valid in ((10.0, [True, False], [3, 3]), (20.0, [True, True], [2, 3])):
        args = (chunk(v), chunk(10 * v), np.array(active), np.array(n_valid, np.int32))
        tl = ap.update_timeline_state(tl, *(torch.from_numpy(a) for a in args))
        jtl = jap.update_timeline_state(jtl, *(jnp.asarray(a) for a in args))
        _assert_rings_equal(tl, jtl)
    # tick 1 wrote 10, 11, 12 to stream 0; tick 2's two valid patches land in
    # slots 3 and (wrapped) 0, and the padded third keeps slot 1
    np.testing.assert_array_equal(tl.g[0, :, 0, 0].numpy(), [21, 11, 12, 20])
    assert tl.count.tolist() == [5, 3] and tl.cursor.tolist() == [1, 3]
    assert tl.cursor.dtype == tl.count.dtype == torch.int32


def test_ring_random_ticks_bit_equal_to_jax():
    """Twenty ticks of random rows, activity and flush lengths through a
    ring that wraps many times."""
    rng = np.random.default_rng(3)
    s, cap, p, levels, c = 3, 5, 4, 2, 6
    tl, jtl = _both_rings(s, cap, levels, c)
    for _ in range(20):
        args = (rng.standard_normal((s, p, levels, c)).astype(np.float32),
                rng.random((s, p, levels, c)).astype(np.float32),
                rng.random(s) < 0.7, rng.integers(0, p + 1, s).astype(np.int32))
        tl = ap.update_timeline_state(tl, *(torch.from_numpy(a) for a in args))
        jtl = jap.update_timeline_state(jtl, *(jnp.asarray(a) for a in args))
        _assert_rings_equal(tl, jtl)
    assert int(tl.count.max()) > 2 * cap


@pytest.mark.parametrize("gate", GATES)
def test_window_timeline_equals_jax(gate):
    rng = np.random.default_rng(4)
    t, c = 7, 5
    g = rng.standard_normal((t, c)).astype(np.float32) * 3
    f = rng.random((t, c)).astype(np.float32)
    num = f.max(axis=0) if gate == "max" else rng.random(c).astype(np.float32)
    den = rng.uniform(0.5, 4.0, c).astype(np.float32)
    m = np.where(np.arange(c) == 0, -np.inf, g.max(axis=0)).astype(np.float32)
    w, fw = ap.window_timeline(g, f, num, den, m, gate)
    rw, rfw = jap.window_timeline(g, f, num, den, m, gate)
    assert w.dtype == np.float32 and w.shape == (t, c)
    np.testing.assert_array_equal(w, rw)
    np.testing.assert_array_equal(fw, rfw)
    with pytest.raises(ValueError, match="unknown att_activation"):
        ap.window_timeline(g, f, num, den, m, "tanh")


def test_read_timeline_and_extra_lane_equal_jax():
    """One packed readout: the extra row comes back bit for bit, the window
    is the same with and without it, and both equal JAX's read_timeline."""
    rng = np.random.default_rng(5)
    s, cap, levels, c = 2, 4, 2, 3
    tl, jtl = _both_rings(s, cap, levels, c)
    for n in (3, 2):
        g = rng.standard_normal((s, 3, levels, c)).astype(np.float32)
        args = (g, 1 / (1 + np.exp(-g)), np.ones(s, bool), np.full(s, n, np.int32))
        tl = ap.update_timeline_state(tl, *(torch.from_numpy(a) for a in args))
        jtl = jap.update_timeline_state(jtl, *(jnp.asarray(a) for a in args))
    st = [(rng.random((s, c)) + 0.5, rng.uniform(1, 2, (s, c)), rng.standard_normal((s, c)))
          for _ in range(levels)]
    states = [ap.StreamState(*(torch.from_numpy(a.astype(np.float32)) for a in x)) for x in st]
    jstates = [jap.StreamState(*(jnp.asarray(a.astype(np.float32)) for a in x)) for x in st]
    extra = np.float32([0.125, -3.5, 1e-7, 0.0, 42.0])
    start, lv, got = ap.read_timeline(states, tl, 1, "exp", extra=torch.from_numpy(extra))
    np.testing.assert_array_equal(got, extra)
    start0, lv0 = ap.read_timeline(states, tl, 1, "exp")
    rstart, rlv = jap.read_timeline(jstates, jtl, 1, "exp")
    assert start == start0 == rstart == 1  # 5 patches folded, the last 4 kept
    for (w, f), (w0, f0), (rw, rf) in zip(lv, lv0, rlv):
        assert w.shape == (cap, c)
        np.testing.assert_array_equal(w, w0)
        np.testing.assert_array_equal(w, rw)
        np.testing.assert_array_equal(f, rf)
    with pytest.raises(RuntimeError, match="timeline disabled"):
        ap.read_timeline(states, None, 0, "exp")


def _serve(srv, audio):
    """Two streams, one long and fed in uneven blocks with ticks between,
    one short; both flushed. Returns per stream (scores, start, levels)."""
    a, b = srv.open(), srv.open()
    for i, lo in enumerate(range(0, len(audio), 9000)):
        srv.feed(a, audio[lo:lo + 9000])
        if i % 2:
            srv.tick()
    srv.feed(b, audio[:len(audio) // 3])
    srv.drain()
    srv.flush(a)
    srv.flush(b)
    model = srv.model if isinstance(srv, BatchedStreamingServer) else srv.variables
    out = []
    for sid in (a, b):
        scores, start, levels = srv.timeline_with_scores_from(model, srv.states, srv.tl, sid)
        np.testing.assert_array_equal(scores, srv.scores(sid))
        t_start, t_levels = srv.timeline(sid)
        assert t_start == start
        for (w, f), (tw, tf) in zip(levels, t_levels):
            np.testing.assert_array_equal(w, tw)
            np.testing.assert_array_equal(f, tf)
        out.append((scores, start, levels))
    return out


@pytest.mark.parametrize("variant", STREAMING_VARIANTS)
def test_server_timeline_and_scores_match_jax_server(variant):
    """Every streaming variant: the ring written inside the tick (and the
    flush) reads back the JAX server's window and scores within 1e-4, both
    through timeline() and through the one-copy timeline_with_scores_from;
    the long stream wraps its ring."""
    jcfg, tcfg, variables, flat = _setup(variant, seed=1)
    audio = _wav(2, 11, tcfg)  # 11 patches: past the ring of 8
    kw = dict(max_streams=2, chunk_patches=3, timeline_cap=8)
    ours = _serve(BatchedStreamingServer(tcfg, torch_state_dict(tcfg.model, flat),
                                         device="cpu", **kw), audio)
    ref = _serve(JaxServer(jcfg, variables, **kw), audio)
    assert [o[1] for o in ours] == [r[1] for r in ref] == [3, 0]
    for (scores, _, levels), (rscores, _, rlevels) in zip(ours, ref):
        np.testing.assert_allclose(scores, rscores, atol=TOL, rtol=0)
        assert len(levels) == len(rlevels)
        for (w, f), (rw, rf) in zip(levels, rlevels):
            assert w.shape == rw.shape
            np.testing.assert_allclose(w, rw, atol=TOL, rtol=0)
            np.testing.assert_allclose(f, rf, atol=TOL, rtol=0)


def test_server_ring_wraps_to_the_last_cap_patches():
    """A ring of 4 over an 11-patch stream keeps the last 4 patches, whose
    globally normalized weights are the one-shot readout's last 4 rows."""
    _, tcfg, _, flat = _setup("single_attention", seed=2)
    wav = _wav(3, 11, tcfg)
    srv = BatchedStreamingServer(tcfg, torch_state_dict(tcfg.model, flat), max_streams=1,
                                 chunk_patches=4, timeline_cap=4, device="cpu")
    sid = srv.open()
    srv.feed(sid, wav)
    srv.drain()
    srv.flush(sid)
    start, [(w, f)] = srv.timeline(sid)
    assert start == 11 - 4
    model = torch_model(tcfg.model, flat)
    with torch.no_grad():
        [(w1, f1)] = model.timeline(fe.apply_frontend(torch.from_numpy(wav)[None], tcfg.frontend))
    np.testing.assert_allclose(w, w1[0, -4:].numpy(), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(f, f1[0, -4:].numpy(), atol=1e-5, rtol=1e-4)
    assert (w.sum(axis=0) < 1.0 + 1e-5).all()


def test_server_slot_reset_on_reuse_and_snapshots():
    """A reused slot starts an empty window; a (states, tl) snapshot taken
    before later ticks and the slot's reset still reads what it held."""
    _, tcfg, _, flat = _setup("single_attention", seed=3)
    srv = BatchedStreamingServer(tcfg, torch_state_dict(tcfg.model, flat), max_streams=1,
                                 chunk_patches=3, timeline_cap=8, device="cpu")
    wav = _wav(4, 6, tcfg)
    sid = srv.open()
    srv.feed(sid, wav)
    srv.drain()
    snap = (srv.states, srv.tl)
    first = srv.timeline_from(*snap, sid)
    assert first[0] == 0 and first[1][0][0].shape[0] == 6
    srv.close(sid)
    sid2 = srv.open()
    assert sid2 == sid
    half = wav[:_samples_per_patches(tcfg.frontend, 3)]
    srv.feed(sid2, half)
    srv.drain()
    start, [(w, _)] = srv.timeline(sid2)
    assert start == 0 and w.shape[0] == 3
    model = torch_model(tcfg.model, flat)
    with torch.no_grad():
        [(w1, _)] = model.timeline(fe.apply_frontend(torch.from_numpy(half)[None], tcfg.frontend))
    np.testing.assert_allclose(w, w1[0].numpy(), atol=1e-5, rtol=1e-4)
    again = srv.timeline_from(*snap, sid)
    np.testing.assert_array_equal(again[1][0][0], first[1][0][0])


def test_server_timeline_disabled_raises():
    _, tcfg, _, flat = _setup("single_attention")
    sd = torch_state_dict(tcfg.model, flat)
    srv = BatchedStreamingServer(tcfg, sd, max_streams=1, chunk_patches=3, device="cpu")
    assert srv.tl is None
    sid = srv.open()
    srv.feed(sid, np.zeros(_samples_per_patches(tcfg.frontend, 3), np.float32))
    srv.drain()
    with pytest.raises(RuntimeError, match="timeline disabled"):
        srv.timeline(sid)
    with pytest.raises(ValueError, match="timeline_cap"):
        BatchedStreamingServer(tcfg, sd, max_streams=1, chunk_patches=5, timeline_cap=3,
                               device="cpu")


def test_tagger_timeline_matches_jax():
    jcfg, tcfg, variables, flat = _setup("multi_attention", seed=4)
    wav = _wav(5, 5, tcfg)
    ours = StreamingTagger(tcfg, torch_state_dict(tcfg.model, flat), chunk_patches=2,
                           timeline_cap=8, device="cpu")
    with pytest.raises(RuntimeError, match="no audio"):
        ours.timeline()
    ref = JaxTagger(jcfg, variables, chunk_patches=2, timeline_cap=8)
    for t in (ours, ref):
        for lo in range(0, len(wav), 9000):
            t.feed(wav[lo:lo + 9000])
        t.flush()
    (start, levels), (rstart, rlevels) = ours.timeline(), ref.timeline()
    assert start == rstart == 0 and len(levels) == len(rlevels) == 2
    for (w, f), (rw, rf) in zip(levels, rlevels):
        assert w.shape == (5, 5)
        np.testing.assert_allclose(w, rw, atol=TOL, rtol=0)
        np.testing.assert_allclose(f, rf, atol=TOL, rtol=0)
    np.testing.assert_allclose(ours.scores(), ref.scores(), atol=TOL, rtol=0)
    ours.reset()
    assert int(ours.tl.count[0]) == 0
    with pytest.raises(ValueError, match="timeline_cap"):
        StreamingTagger(tcfg, torch_state_dict(tcfg.model, flat), chunk_patches=4,
                        timeline_cap=3, device="cpu")
