"""The PyTorch port's stream-sharded server (``BatchedStreamingServer`` with
a mesh) against JAX's mesh server: scores and timelines on an 8-shard CPU
mesh against JAX's 8 virtual devices, on the int16 and adpcm4 wires with
the ring on (as tests/test_server.py:257-330 holds JAX's against its
unsharded server); the packed rows layout byte for byte against JAX's; the
packed tick against the three-upload tick bit for bit on a mesh; and a
weight reload on a mesh. The reference encodes ADPCM through its native
library (``mla_tpu.data.native``), pinned for the whole module by
``reference_native_libraries``, never through its numpy / scipy fallback."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.parallel import mesh as jmesh  # noqa: E402
from mla_tpu.serve.server import BatchedStreamingServer as JaxServer  # noqa: E402
from mla_tpu_torch.data import audio_io  # noqa: E402
from mla_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mla_tpu_torch.serve.server import BatchedStreamingServer  # noqa: E402
from mla_tpu_torch.serve.streaming import _samples_per_patches  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    configs,
    jax_weights,
    reference_native_libraries,
    torch_state_dict,
)

pytestmark = pytest.mark.usefixtures("reference_native_libraries")

SCORE_TOL = 1e-4  # tests/test_torch_serve.py's, the port against JAX
SHARD_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_server.py's, sharded against unsharded
KW = dict(max_streams=8, chunk_patches=5, timeline_cap=8)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs({"model.n_classes": 9, "model.n_blocks": 2, "model.hidden_units": 48})
    (v1, f1), (_, f2) = jax_weights(jcfg.model, seed=6), jax_weights(jcfg.model, seed=7)
    wav = (np.random.default_rng(0).standard_normal(16000 * 40) * 0.1).astype(np.float32)
    return jcfg, tcfg, v1, torch_state_dict(tcfg.model, f1), torch_state_dict(tcfg.model, f2), wav


def _cpu_mesh(n=8):
    return make_mesh(devices=["cpu"] * n)


def _streams(cfg, wav, wire, patches=7):
    n = _samples_per_patches(cfg.frontend, patches)
    out = [wav[:n], wav[n:2 * n], (wav[:n] * 0.3).astype(np.float32)]
    return [audio_io.pcm16_quantize(s) for s in out] if wire == "int16" else out


def _session(srv, streams):
    """Three streams fed and drained, flushed; stream 0 closed, reopened and
    fed again. Returns the scores and stream 1's timeline."""
    sids = [srv.open() for _ in streams]
    for sid, s in zip(sids, streams):
        for i in range(0, len(s), 7000):
            srv.feed(sid, s[i:i + 7000])
        srv.drain()
    for sid in sids:
        srv.flush(sid)
    scores = [np.asarray(srv.scores(sid)) for sid in sids]
    start, levels = srv.timeline(sids[1])
    srv.close(sids[0])
    sid = srv.open()
    srv.feed(sid, streams[0])
    srv.drain()
    srv.flush(sid)
    scores.append(np.asarray(srv.scores(sid)))
    return np.stack(scores), start, levels


@pytest.mark.parametrize("wire", ["int16", "adpcm4"])
def test_mesh_server_matches_jax_mesh_server(setup, wire):
    jcfg, tcfg, variables, sd, _, wav = setup
    streams = _streams(tcfg, wav, wire)
    ours = BatchedStreamingServer(tcfg, sd, transfer_dtype=wire, mesh=_cpu_mesh(), **KW)
    assert [d for d, _ in ours._shards] == [torch.device("cpu")] * 8
    assert len({id(m) for m in ours.model}) == 1  # one replica per distinct device
    got, start, levels = _session(ours, streams)
    want, jstart, jlevels = _session(
        JaxServer(jcfg, variables, transfer_dtype=wire, mesh=jmesh.make_mesh(), **KW), streams)
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)
    assert start == jstart and len(levels) == len(jlevels)
    for (w, p), (jw, jp) in zip(levels, jlevels):
        np.testing.assert_allclose(w, np.asarray(jw), rtol=0, atol=SCORE_TOL)
        np.testing.assert_allclose(p, np.asarray(jp), rtol=0, atol=SCORE_TOL)
    plain, _, _ = _session(BatchedStreamingServer(tcfg, sd, transfer_dtype=wire, device="cpu",
                                                  **KW), streams)
    np.testing.assert_allclose(got, plain, **SHARD_TOL)
    np.testing.assert_allclose(got[3], got[0], **SHARD_TOL)  # the reset slot starts clean


def test_mesh_server_rejects_an_indivisible_stream_count(setup):
    jcfg, tcfg, variables, sd, _, _ = setup
    with pytest.raises(ValueError, match="divisible") as ours:
        BatchedStreamingServer(tcfg, sd, max_streams=6, chunk_patches=5, mesh=_cpu_mesh())
    with pytest.raises(ValueError) as ref:
        JaxServer(jcfg, variables, max_streams=6, chunk_patches=5, mesh=jmesh.make_mesh())
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("wire", ["int16", "adpcm4"])
def test_packed_rows_layout_equals_jax(setup, wire):
    """A mesh server packs [S, packed_row_bytes] rows (wire bytes, then the
    active byte), byte for byte JAX's; put_packed uploads one block per
    shard."""
    jcfg, tcfg, variables, sd, _, wav = setup
    ours = BatchedStreamingServer(tcfg, sd, transfer_dtype=wire, mesh=_cpu_mesh(), **KW)
    ref = JaxServer(jcfg, variables, transfer_dtype=wire, mesh=jmesh.make_mesh(), **KW)
    streams = _streams(tcfg, wav, wire)
    for srv in (ours, ref):
        for s in streams:
            srv.feed(srv.open(), s)
    while True:
        buf, jbuf = ours.packed_buffer(), ref.packed_buffer()
        assert buf.shape == jbuf.shape == (8, ours.packed_row_bytes)
        buf[:] = 0xA5  # stale bytes: the gather writes every byte
        act, jact = ours.gather_ready_packed(buf), ref.gather_ready_packed(jbuf)
        if act is None:
            assert jact is None
            break
        np.testing.assert_array_equal(act, jact)
        np.testing.assert_array_equal(buf, jbuf)
        blocks = ours.put_packed(buf)
        assert len(blocks) == 8 and all(b.shape == (1, ours.packed_row_bytes) for b in blocks)
        # the card's decode kernel takes contiguous wire only
        assert all(ours._wire(b[:, :-1]).is_contiguous() for b in blocks)


@pytest.mark.parametrize("wire", ["int16", "adpcm4"])
def test_mesh_packed_tick_equals_three_upload_tick(setup, wire):
    """Driven only through tick_packed, a mesh server's states and ring
    equal those of the same server driven through tick(), bit for bit, on
    every shard."""
    _, tcfg, _, sd, _, wav = setup
    mesh = make_mesh(devices=["cpu"] * 4)  # two streams on each shard
    a, b = (BatchedStreamingServer(tcfg, sd, transfer_dtype=wire, mesh=mesh, **KW)
            for _ in range(2))
    for srv in (a, b):
        for s in _streams(tcfg, wav, wire, patches=12):
            srv.feed(srv.open(), s)
    rows = b.put_packed(b.packed_buffer())
    assert all(b._wire(r[:, :-1]).is_contiguous() for r in rows)  # two rows a block
    while a.tick():
        assert b.tick_packed()
    assert b.tick_packed() == 0 and a.dispatches == b.dispatches >= 2
    for k in range(4):
        for x, y in zip([t for st in a.states[k] for t in st] + list(a.tl[k]),
                        [t for st in b.states[k] for t in st] + list(b.tl[k])):
            assert torch.equal(x, y)


def test_mesh_reload(setup):
    """A reload mid-stream on a mesh: open streams keep their accumulators,
    a stream opened after it scores as a fresh mesh server on the new
    weights, every shard's replica swapped in one commit."""
    _, tcfg, _, sd1, sd2, wav = setup
    mesh = make_mesh(devices=["cpu"] * 4)
    streams = _streams(tcfg, wav, "float32")
    srv = BatchedStreamingServer(tcfg, sd1, mesh=mesh, **KW)
    kept = srv.open()
    srv.feed(kept, streams[0])
    srv.drain()
    before = [t.clone() for shard in srv.states for st in shard for t in st]
    staged = srv.prepare_reload(sd2)
    assert len(staged) == 4 and len({id(m) for m in staged}) == 1
    srv.commit_reload(staged)
    assert all(torch.equal(x, y) for x, y in
               zip(before, [t for shard in srv.states for st in shard for t in st]))
    for _ in range(2):
        srv.open()  # the next stream lands on the second shard
    new = srv.open()
    assert srv._locate(new) == (1, 1)
    fresh = BatchedStreamingServer(tcfg, sd2, mesh=mesh, **KW)
    for s in (srv, fresh):
        s.feed(new if s is srv else s.open(), streams[1])
        s.drain()
    np.testing.assert_allclose(srv.scores(new), fresh.scores(0), **SHARD_TOL)
    with pytest.raises(ValueError, match="does not match"):
        srv.prepare_reload({k: v for k, v in sd2.items() if "att0" not in k})
