"""Serving slice of the PyTorch port: BatchedStreamingServer against the
JAX server on identical bytes (fused front-end, f32 compute, same weights),
StreamingTagger against tag_clip, and the device rule of the entry points."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.serve.server import BatchedStreamingServer as JaxServer  # noqa: E402
from mla_tpu_torch.data import audio_io  # noqa: E402
from mla_tpu_torch.serve.server import BatchedStreamingServer  # noqa: E402
from mla_tpu_torch.serve.streaming import (  # noqa: E402
    StreamingTagger,
    _samples_per_patches,
    tag_clip,
)
from tests.torch_port_common import configs, jax_weights, torch_state_dict  # noqa: E402

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


@pytest.mark.parametrize("wire", ["float32", "int16", "uint8"])
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
    ({"timeline_cap": 8}, NotImplementedError),
    ({"mesh": object()}, NotImplementedError),
    ({"transfer_dtype": "adpcm4"}, NotImplementedError),
    ({"transfer_dtype": "adpcm2"}, NotImplementedError),
    ({"transfer_dtype": "bfloat16"}, ValueError),
])
def test_server_rejects_unported_options(setup, kwargs, err):
    _, tcfg, _, state_dict = setup
    with pytest.raises(err):
        BatchedStreamingServer(tcfg, state_dict, device="cpu", **kwargs)


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
