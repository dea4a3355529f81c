"""Serving slice of the PyTorch port: BatchedStreamingServer against the
JAX server on identical bytes (fused front-end, f32 compute, same weights)
on every wire, the adpcm wires' pre-encoded feeds and remainders included,
the packed one-upload tick against the three-upload tick and its byte
layout against JAX's, StreamingTagger against tag_clip, and the device rule
of the entry points. The reference encodes ADPCM through its native library
(``mla_tpu.data.native``), pinned for the whole module by
``reference_native_libraries``, never through its numpy / scipy fallback."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from mla_tpu.serve.server import BatchedStreamingServer as JaxServer  # noqa: E402
from mla_tpu_torch.data import adpcm, audio_io  # noqa: E402
from mla_tpu_torch.ops import adpcm as adpcm_ops  # noqa: E402
from mla_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mla_tpu_torch.serve.server import BatchedStreamingServer  # noqa: E402
from mla_tpu_torch.serve.streaming import (  # noqa: E402
    StreamingTagger,
    _samples_per_patches,
    tag_clip,
)
from tests.torch_port_common import (  # noqa: E402
    configs,
    jax_weights,
    reference_native_libraries,
    torch_state_dict,
)

pytestmark = pytest.mark.usefixtures("reference_native_libraries")

SCORE_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs({"frontend.impl": "pallas"})
    variables, flat = jax_weights(jcfg.model, seed=4)
    return jcfg, tcfg, variables, torch_state_dict(tcfg.model, flat)


def _session(srv, audio):
    """Two streams: one long, fed in uneven blocks with ticks between, and
    one lone sub-patch stream; flush both; then a third stream that reuses
    the first one's slot. Returns every score read."""
    a, b = srv.open(), srv.open()
    sizes = [5000, 17, 23000, 9000, 40000, 3333] * 4
    pos = 0
    for i, n in enumerate(sizes):
        srv.feed(a, audio[pos:pos + n])
        pos += n
        if i % 3 == 2:
            srv.tick()
    srv.feed(b, audio[:8000])
    srv.drain()
    out = [srv.scores(a)]
    srv.flush(a)
    srv.flush(b)
    out += [srv.scores(a), srv.scores(b)]
    srv.close(a)
    c = srv.open()
    srv.feed(c, audio[50000:50000 + 2 * 16000 + 4321])
    srv.flush(c)
    out.append(srv.scores(c))
    return np.stack(out)


@pytest.mark.parametrize("wire", ["float32", "int16", "uint8", "adpcm4", "adpcm2"])
def test_server_matches_jax_server(setup, wire):
    jcfg, tcfg, variables, state_dict = setup
    audio = (np.random.default_rng(7).standard_normal(16000 * 20) * 0.1).astype(np.float32)
    if wire == "int16":
        audio = audio_io.pcm16_quantize(audio)  # PCM16 in, the wire as it arrives
    ours = _session(BatchedStreamingServer(tcfg, state_dict, max_streams=2, chunk_patches=2,
                                           transfer_dtype=wire, device="cpu"), audio)
    ref = _session(JaxServer(jcfg, variables, max_streams=2, chunk_patches=2,
                             transfer_dtype=wire), audio)
    assert ours.shape == (4, 5) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, atol=SCORE_TOL, rtol=0)


WIRES = ["float32", "int16", "uint8", "adpcm4", "adpcm2"]


def _wire_rows(srv, rng):
    """Three distinct rows of one chunk in the server's wire format."""
    units, _ = srv._chunk_hop_units()
    if srv.transfer_dtype == "float32":
        return (rng.standard_normal((3, units)) * 0.2).astype(np.float32)
    if srv.transfer_dtype == "int16":
        return rng.integers(-30000, 30000, (3, units)).astype(np.int16)
    if srv.transfer_dtype == "uint8":
        return rng.integers(0, 256, (3, units)).astype(np.uint8)
    one = srv._adpcm["encode"]((rng.standard_normal(srv.chunk_samples) * 8000).astype(np.int16),
                               block=srv._adpcm["block"])
    return np.stack([one, one[::-1], one ^ 0x5A]).astype(np.uint8)


@pytest.mark.parametrize("wire", WIRES)
def test_packed_tick_equals_three_upload_tick(setup, wire):
    """The one-upload step ([S * row bytes wire][S active] uint8, sliced and
    reinterpreted little-endian on the device) gives the states and ring of
    the three-upload step bit for bit, one row inactive."""
    _, tcfg, _, state_dict = setup
    srv = BatchedStreamingServer(tcfg, state_dict, max_streams=3, chunk_patches=2,
                                 transfer_dtype=wire, timeline_cap=4, device="cpu")
    rows = _wire_rows(srv, np.random.default_rng(12))
    active = np.array([True, False, True])
    states, tl = srv._step(srv.states, srv.tl, torch.from_numpy(rows), torch.from_numpy(active),
                           torch.full((3,), srv.chunk_patches, dtype=torch.int32))
    packed = srv.packed_buffer()
    assert packed.shape == (srv.packed_nbytes,) == (3 * rows[0].nbytes + 3,)
    wire_rows, act_bytes = srv._packed_views(packed)
    wire_rows[:] = rows.view(np.uint8).reshape(3, -1)
    act_bytes[:] = active
    p_states, p_tl = srv._packed_step(srv.states, srv.tl, srv.put_packed(packed))
    for a, b in zip([t for st in states for t in st] + list(tl),
                    [t for st in p_states for t in st] + list(p_tl)):
        assert torch.equal(a, b)
    assert int(tl.count[1]) == 0 and int(tl.count[0]) == srv.chunk_patches


@pytest.mark.parametrize("wire", WIRES)
def test_gather_ready_packed_bytes_equal_jax(setup, wire):
    """The packed layout is the JAX server's byte for byte (the contract a
    front's own gather writes), inactive rows wire silence over stale bytes,
    and the buffers advance as gather_ready advances them."""
    jcfg, tcfg, variables, state_dict = setup
    kw = dict(max_streams=3, chunk_patches=2, transfer_dtype=wire)
    ours, plain = (BatchedStreamingServer(tcfg, state_dict, device="cpu", **kw)
                   for _ in range(2))
    ref = JaxServer(jcfg, variables, **kw)
    audio = (np.random.default_rng(13).standard_normal(ours.chunk_samples + 777) * 0.2
             ).astype(np.float32)
    for srv in (ours, plain, ref):
        for sid, gain in zip((srv.open(), srv.open(), srv.open()), (1.0, 0.0, 0.5)):
            if gain:
                srv.feed(sid, audio * gain)
    assert ours.packed_nbytes == ref.packed_nbytes
    assert ours.packed_row_bytes == ref.packed_row_bytes
    out, ref_out = (np.full(ours.packed_nbytes, 0xAB, np.uint8) for _ in range(2))
    active = ours.gather_ready_packed(out)
    np.testing.assert_array_equal(active, ref.gather_ready_packed(ref_out))
    np.testing.assert_array_equal(out, ref_out)
    wav, plain_active = plain.gather_ready()
    np.testing.assert_array_equal(active, plain_active)
    np.testing.assert_array_equal(out[:wav.nbytes], wav.view(np.uint8).ravel())
    for sid in range(3):
        np.testing.assert_array_equal(ours._bufs[sid], plain._bufs[sid])
    assert ours.gather_ready_packed(out) is None


@pytest.mark.parametrize("wire", WIRES)
def test_staging_buffers_rewrite_only_changed_rows(setup, wire):
    """A staging buffer the server hands out again holds, after each
    gather, the bytes of a full write into stale memory, whichever streams
    were ready in its earlier uses; a buffer a front wrote itself is
    written whole again; one still held is not handed out."""
    _, tcfg, _, state_dict = setup
    kw = dict(max_streams=3, chunk_patches=2, transfer_dtype=wire, device="cpu")
    ours, twin = (BatchedStreamingServer(tcfg, state_dict, **kw) for _ in range(2))
    audio = (np.random.default_rng(15).standard_normal(ours.chunk_samples) * 0.2
             ).astype(np.float32)
    for srv in (ours, twin):
        for _ in range(3):
            srv.open()
    rounds = [(0,), (1,), (0, 2), (), (2,), (1, 2), (0, 1, 2)]
    first = None  # id() of the first buffer: a reference would hold it
    for r, ready in enumerate(rounds):
        if r == 3:  # a front's own writes into the buffer, dropped
            buf = ours.packed_buffer()
            buf[:] = 0xCD
            del buf
            continue
        for srv in (ours, twin):
            for sid in ready:
                srv.feed(sid, audio * (0.3 + 0.2 * sid + 0.1 * r))
        buf = ours.packed_buffer()
        first = id(buf) if first is None else first
        assert id(buf) == first  # released and uploaded: handed out again
        full = np.full(twin.packed_nbytes, 0xAB, np.uint8)
        active = ours.gather_ready_packed(buf)
        np.testing.assert_array_equal(active, twin.gather_ready_packed(full))
        np.testing.assert_array_equal(buf, full)
        dev = ours.put_packed(buf)
        del buf, dev
        for srv in (ours, twin):  # the ready streams' tails: drop, keep the slots
            for sid in ready:
                srv._bufs[sid] = srv._bufs[sid][:0]
    held = ours.packed_buffer()
    assert id(held) == first and ours.packed_buffer() is not held


@pytest.mark.parametrize("wire", ["int16", "adpcm4"])
def test_tick_packed_serves_like_tick(setup, wire):
    """A whole session through tick_packed gives the scores of the same
    session through tick; warmup(packed=True) changes no state."""
    _, tcfg, _, state_dict = setup
    audio = (np.random.default_rng(14).standard_normal(16000 * 12) * 0.1).astype(np.float32)
    kw = dict(max_streams=2, chunk_patches=2, transfer_dtype=wire, device="cpu")
    srv = BatchedStreamingServer(tcfg, state_dict, **kw)
    before = [t.clone() for st in srv.states for t in st]
    srv.warmup(packed=True)
    assert all(torch.equal(x, y) for x, y in zip(before, [t for st in srv.states for t in st]))
    packed = BatchedStreamingServer(tcfg, state_dict, **kw)
    packed.tick = packed.tick_packed  # the session's ticks and drains go through it
    d0 = srv.dispatches
    np.testing.assert_array_equal(_session(packed, audio), _session(srv, audio))
    assert packed.dispatches == srv.dispatches - d0 > 0


def test_server_bookkeeping(setup):
    _, tcfg, _, state_dict = setup
    srv = BatchedStreamingServer(tcfg, state_dict, max_streams=2, chunk_patches=2,
                                 transfer_dtype="int16", device="cpu")
    a = srv.open()
    with pytest.raises(RuntimeError, match="no processed audio"):
        srv.scores(a)
    srv.feed(a, np.zeros(srv.chunk_samples + srv.hop_samples, np.float32))
    assert srv.pending(a) == srv.chunk_samples + srv.hop_samples
    assert srv.chunks_ready(a) == 2 and srv.chunks_ready(1) == 0
    assert srv.drain() == 2 and srv.dispatches == 2
    srv.open()
    with pytest.raises(RuntimeError, match="busy"):
        srv.open()
    srv.close(a)
    with pytest.raises(KeyError):
        srv.feed(a, np.zeros(10, np.float32))
    before = [t.clone() for st in srv.states for t in st]
    srv.warmup()  # an all-inactive step changes no state
    assert all(torch.equal(x, y) for x, y in zip(before, [t for st in srv.states for t in st]))


@pytest.mark.parametrize("kwargs,err", [
    ({"timeline_cap": 3}, ValueError),  # below chunk_patches
    # the reference's divisibility error: 6 streams over 4 shards
    ({"max_streams": 6, "mesh": make_mesh(devices=["cpu"] * 4)}, ValueError),
    ({"transfer_dtype": "bfloat16"}, ValueError),
])
def test_server_rejects_unported_options(setup, kwargs, err):
    _, tcfg, _, state_dict = setup
    with pytest.raises(err):
        BatchedStreamingServer(tcfg, state_dict, device="cpu", **kwargs)


@pytest.mark.parametrize("wire", ["adpcm4", "adpcm2"])
def test_adpcm_server_wire_feeds_match_jax_server(setup, wire):
    """Pre-encoded wire feeds (wire=True, and uint8 taken as wire), a
    sample feed that leaves a sub-block remainder, its flush, and the
    server's units: pending in samples, chunks_ready in wire units."""
    jcfg, tcfg, variables, state_dict = setup
    bits = int(wire[-1])
    enc = adpcm.adpcm4_encode if bits == 4 else adpcm.adpcm2_encode
    audio = (np.random.default_rng(11).standard_normal(16000 * 12) * 0.1).astype(np.float32)
    blk, wb = adpcm.SERVE_BLOCK, adpcm.wire_block_bytes(adpcm.SERVE_BLOCK, bits)
    coded = enc(audio, block=blk)
    tail = audio[1100 * blk:1100 * blk + 16000 + 37]  # 16037 samples: a remainder of 37

    def run_feeds(srv):
        a, b = srv.open(), srv.open()
        srv.feed(a, coded[:500 * wb], wire=True)
        srv.feed(a, coded[500 * wb:1100 * wb])  # uint8: wire by default
        assert srv.pending(a) == 1100 * blk
        ready = srv.chunks_ready(a)
        srv.feed(b, tail)
        assert srv.pending(b) == len(tail)
        with pytest.raises(ValueError, match="not-yet-encoded"):
            srv.feed(b, coded[:wb], wire=True)
        with pytest.raises(ValueError, match="whole"):
            srv.feed(a, coded[:wb - 1])
        srv.drain()
        out = [srv.scores(a)]
        srv.flush(a)
        srv.flush(b)
        assert srv.pending(b) == 0
        return ready, np.stack(out + [srv.scores(a), srv.scores(b)])

    launches = adpcm_ops.LAUNCHES
    ready, ours = run_feeds(BatchedStreamingServer(tcfg, state_dict, max_streams=2,
                                                 chunk_patches=2, transfer_dtype=wire,
                                                 device="cpu"))
    assert adpcm_ops.LAUNCHES == launches  # the CPU takes the plain decode
    ref_ready, ref = run_feeds(JaxServer(jcfg, variables, max_streams=2, chunk_patches=2,
                                       transfer_dtype=wire))
    assert ready == ref_ready > 1
    np.testing.assert_allclose(ours, ref, atol=SCORE_TOL, rtol=0)


def test_adpcm_server_needs_whole_block_chunks(setup):
    """At 22.05 kHz the hop is 220 samples, so chunks are not whole 64-sample
    blocks: the adpcm wires are refused, as the reference refuses them."""
    _, tcfg, _, state_dict = setup
    cfg = dataclasses.replace(tcfg, frontend=dataclasses.replace(tcfg.frontend,
                                                                 sample_rate=22050))
    for wire in ("adpcm4", "adpcm2"):
        with pytest.raises(ValueError, match="divisible by 64"):
            BatchedStreamingServer(cfg, state_dict, transfer_dtype=wire, device="cpu")
    srv = BatchedStreamingServer(cfg, state_dict, transfer_dtype="int16", device="cpu")
    assert srv.chunk_samples % 64


def test_streaming_tagger_matches_tag_clip(setup):
    _, tcfg, _, state_dict = setup
    n = _samples_per_patches(tcfg.frontend, 6)
    wav = (np.random.default_rng(8).standard_normal(n) * 0.1).astype(np.float32)
    whole = tag_clip(tcfg, state_dict, wav, device="cpu")
    tagger = StreamingTagger(tcfg, state_dict, chunk_patches=3, device="cpu")
    for lo in range(0, n, 7777):
        tagger.feed(wav[lo:lo + 7777])
    np.testing.assert_allclose(tagger.scores(), whole, atol=SCORE_TOL, rtol=0)
    top = tagger.top_k(3)
    assert len(top) == 3 and top[0][1] >= top[1][1] >= top[2][1]
    tagger.reset()
    with pytest.raises(RuntimeError, match="no audio"):
        tagger.scores()
    tagger.feed(wav[:8000])  # lone sub-patch stream: zero-padded to one patch
    tagger.flush()
    padded = np.zeros(_samples_per_patches(tcfg.frontend, 1), np.float32)
    padded[:8000] = wav[:8000]
    np.testing.assert_allclose(tagger.scores(), tag_clip(tcfg, state_dict, padded, device="cpu"),
                               atol=SCORE_TOL, rtol=0)


def test_xla_and_pallas_frontends_serve_alike(setup):
    _, tcfg, _, state_dict = setup
    xcfg = dataclasses.replace(tcfg, frontend=dataclasses.replace(tcfg.frontend, impl="xla"))
    wav = (np.random.default_rng(9).standard_normal(16000 * 5) * 0.1).astype(np.float32)
    np.testing.assert_allclose(tag_clip(tcfg, state_dict, wav, device="cpu"),
                               tag_clip(xcfg, state_dict, wav, device="cpu"), atol=SCORE_TOL)


def test_entry_points_need_a_card_unless_cpu_is_named(setup):
    _, tcfg, _, state_dict = setup
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    wav = np.zeros(16000 * 2, np.float32)
    for make in (lambda: BatchedStreamingServer(tcfg, state_dict),
                 lambda: StreamingTagger(tcfg, state_dict),
                 lambda: tag_clip(tcfg, state_dict, wav)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_wire_codecs_equal_reference():
    from mla_tpu.data import audio_io as ref

    x = np.random.default_rng(10).uniform(-1.2, 1.2, 4096).astype(np.float32)
    np.testing.assert_array_equal(audio_io.pcm16_quantize(x), ref.pcm16_quantize(x))
    np.testing.assert_array_equal(audio_io.mulaw_encode(x), ref.mulaw_encode(x))
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(audio_io.mulaw_decode(codes), ref.mulaw_decode(codes))
    # the device-side decode uses torch's expm1: within one f32 ulp of numpy's
    np.testing.assert_allclose(audio_io.mulaw_decode(torch.from_numpy(codes)).numpy(),
                               ref.mulaw_decode(codes), rtol=2.4e-7, atol=0)

