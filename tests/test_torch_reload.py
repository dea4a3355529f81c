"""Weight reload of the PyTorch port's server against the JAX server's:
prepare_reload checks and stages a second model, commit_reload swaps it in
with one attribute store, open streams keep their accumulators and ring,
and chunks folded after the swap use the new weights."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.serve.server import BatchedStreamingServer as JaxServer  # noqa: E402
from mla_tpu_torch.serve.server import BatchedStreamingServer  # noqa: E402
from mla_tpu_torch.serve.streaming import _samples_per_patches  # noqa: E402
from tests.torch_port_common import configs, jax_weights, torch_state_dict  # noqa: E402

TOL = 1e-4  # scores, port against JAX (f32)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs({"model.variant": "single_attention", "model.n_blocks": 1})
    (v1, f1), (v2, f2) = jax_weights(jcfg.model, seed=7), jax_weights(jcfg.model, seed=8)
    return jcfg, tcfg, (v1, torch_state_dict(tcfg.model, f1)), (v2, torch_state_dict(tcfg.model, f2))


def _wav(seed, n_patches, cfg):
    n = _samples_per_patches(cfg.frontend, n_patches)
    return (np.random.default_rng(seed).standard_normal(n) * 0.3).astype(np.float32)


def _fresh_stream_after_reload(srv, new, wav):
    a = srv.open()
    srv.feed(a, wav)
    srv.drain()
    before = srv.scores(a).copy()
    srv.reload_weights(new)
    b = srv.open()
    srv.feed(b, wav)
    srv.drain()
    return before, srv.scores(b)


def test_reload_fresh_stream_matches_new_weight_server(setup):
    jcfg, tcfg, (v1, sd1), (v2, sd2) = setup
    wav = _wav(1, 3, tcfg)
    kw = dict(max_streams=2, chunk_patches=3, timeline_cap=4)
    before, after = _fresh_stream_after_reload(
        BatchedStreamingServer(tcfg, sd1, device="cpu", **kw), sd2, wav)
    assert not np.allclose(after, before)  # the weights really changed
    fresh = BatchedStreamingServer(tcfg, sd2, device="cpu", **kw)
    fresh.open()  # the reloaded server's fresh stream sat in slot 1
    r = fresh.open()
    fresh.feed(r, wav)
    fresh.drain()
    np.testing.assert_array_equal(after, fresh.scores(r))
    ref_before, ref_after = _fresh_stream_after_reload(JaxServer(jcfg, v1, **kw), v2, wav)
    np.testing.assert_allclose(before, ref_before, atol=TOL, rtol=0)
    np.testing.assert_allclose(after, ref_after, atol=TOL, rtol=0)


def _mid_stream(srv, new, wav):
    sid = srv.open()
    srv.feed(sid, wav[:srv.chunk_samples])
    assert srv.tick() == 1
    prepared = srv.prepare_reload(new)
    assert srv.tick() == 0
    kept = [np.asarray(t).copy() for st in srv.states for t in st]
    if srv.tl is not None:
        kept += [np.asarray(t).copy() for t in srv.tl]
    srv.commit_reload(prepared)
    after = [np.asarray(t) for st in srv.states for t in st]
    if srv.tl is not None:
        after += [np.asarray(t) for t in srv.tl]
    for k, a in zip(kept, after):  # the swap leaves every accumulator and the ring
        np.testing.assert_array_equal(k, a)
    srv.feed(sid, wav[srv.chunk_samples:])  # completes the second chunk exactly
    assert srv.drain() == 1
    return srv.scores(sid), srv.timeline(sid) if srv.tl is not None else None


def test_reload_mid_stream_keeps_accumulators_and_ring(setup):
    """One chunk folds with the old weights, the next with the new; the
    stream's state and ring carry across the swap, as in the JAX server."""
    jcfg, tcfg, (v1, sd1), (v2, sd2) = setup
    kw = dict(max_streams=1, chunk_patches=3, timeline_cap=8)
    srv = BatchedStreamingServer(tcfg, sd1, device="cpu", **kw)
    wav = _wav(2, 6, tcfg)
    scores, (start, [(w, f)]) = _mid_stream(srv, sd2, wav)
    rscores, (rstart, [(rw, rf)]) = _mid_stream(JaxServer(jcfg, v1, **kw), v2, wav)
    np.testing.assert_allclose(scores, rscores, atol=TOL, rtol=0)
    assert start == rstart == 0 and w.shape == (6, tcfg.model.n_classes)
    np.testing.assert_allclose(w, rw, atol=TOL, rtol=0)
    np.testing.assert_allclose(f, rf, atol=TOL, rtol=0)


@pytest.mark.parametrize("change", ["other_architecture", "missing_key", "dtype"])
def test_reload_rejects_a_mismatched_state_dict(setup, change):
    _, tcfg, (_, sd1), _ = setup
    srv = BatchedStreamingServer(tcfg, sd1, max_streams=1, chunk_patches=3, device="cpu")
    if change == "other_architecture":
        jother, other = configs({"model.variant": "single_attention", "model.n_blocks": 1,
                                 "model.n_classes": 9})
        bad = torch_state_dict(other.model, jax_weights(jother.model)[1])
    elif change == "missing_key":
        bad = dict(sd1)
        bad.pop(next(iter(bad)))
    else:
        bad = {k: v.double() if v.is_floating_point() else v for k, v in sd1.items()}
    model = srv.model
    with pytest.raises(ValueError, match="does not match"):
        srv.reload_weights(bad)
    assert srv.model is model


def test_commit_reload_is_one_store(setup):
    """prepare_reload leaves the serving model alone; commit_reload makes
    the staged model the server's, without copying it."""
    _, tcfg, (_, sd1), (_, sd2) = setup
    srv = BatchedStreamingServer(tcfg, sd1, max_streams=1, chunk_patches=3, device="cpu")
    old = srv.model
    staged = srv.prepare_reload(sd2)
    assert srv.model is old and staged is not old and not staged.training
    for k, v in staged.state_dict().items():
        assert torch.equal(v, sd2[k])
    srv.commit_reload(staged)
    assert srv.model is staged
