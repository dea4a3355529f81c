"""The PyTorch port's stdlib HTTP front (serve/http.py) beside JAX's: one
request sequence goes to both services, and every reply must carry the same
status, the same JSON keys and labels, and probabilities within the
reference tests' tolerance. Bodies: float32, audio/L16, audio/basic,
audio/adpcm4 with a partial block and X-Samples, WAV; routes: the stream
lifecycle, /v1/tag, ?sync=0, the timeline, /v1/reload, and the error
paths. The reference decodes wav bodies and encodes ADPCM through its native
library (``mla_tpu.data.native``), pinned for the whole module by
``reference_native_libraries``, never through its numpy / scipy fallback."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import http.client  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.serve.http import create_server as jax_create_server  # noqa: E402
from mla_tpu.serve.streaming import tag_clip as jax_tag_clip  # noqa: E402
from mla_tpu_torch.data import adpcm, audio_io  # noqa: E402
from mla_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mla_tpu_torch.serve.client import TagClient  # noqa: E402
from mla_tpu_torch.serve.http import create_server  # noqa: E402
from mla_tpu_torch.serve.streaming import _samples_per_patches  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    both,
    configs,
    http_call,
    jax_weights,
    reference_native_libraries,
    torch_state_dict,
)

pytestmark = pytest.mark.usefixtures("reference_native_libraries")

MULAW_TOL = dict(rtol=0, atol=5e-2)  # a mu-law body against the float32 feed


@pytest.fixture(scope="module")
def pair():
    """(port base URL, JAX base URL), cfg, wav, and the holders the two
    reload_fns read: int16 wire, 3 slots, 3-patch chunks, an 8-patch ring."""
    jcfg, tcfg = configs({"frontend.precision": "highest"})
    (v1, f1), (v2, f2) = jax_weights(jcfg.model, seed=21), jax_weights(jcfg.model, seed=22)
    weights = {"port": [torch_state_dict(tcfg.model, f) for f in (f1, f2)], "jax": [v1, v2]}
    current = {"i": 0}
    kw = dict(port=0, max_streams=3, chunk_patches=3, transfer_dtype="int16", timeline_cap=8)
    ours = create_server(tcfg, weights["port"][0], device="cpu",
                         reload_fn=lambda: (weights["port"][current["i"]], {"i": current["i"]}),
                         **kw)
    ref = jax_create_server(jcfg, v1,
                            reload_fn=lambda: (weights["jax"][current["i"]], {"i": current["i"]}),
                            **kw)
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in (ours, ref)]
    for t in threads:
        t.start()
    bases = tuple("http://%s:%d" % s.server_address[:2] for s in (ours, ref))
    wav = (np.random.default_rng(5).standard_normal(16000 * 12) * 0.1).astype(np.float32)
    yield bases, tcfg, wav, current
    for s in (ours, ref):
        s.shutdown()
        s.server_close()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)


def test_healthz(pair):
    bases, _, _, _ = pair
    (s, got), (ws, want) = (http_call(b, "GET", "/v1/healthz") for b in bases)
    assert s == ws == 200 and sorted(got) == sorted(want)
    for k in ("ok", "max_streams", "variant", "sample_rate", "transfer_dtype"):
        assert got[k] == want[k], k


def test_stream_lifecycle_float32_body(pair):
    bases, cfg, wav, _ = pair
    audio = wav[:_samples_per_patches(cfg.frontend, 7) + 5000]
    _, r = both(bases, "POST", "/v1/streams")
    sid = r["sid"]
    assert r["chunk_samples"] == _samples_per_patches(cfg.frontend, 3)
    both(bases, "POST", f"/v1/streams/{sid}/audio", audio[:50000].tobytes())
    _, r = both(bases, "POST", f"/v1/streams/{sid}/audio", audio[50000:].tobytes())
    assert r["advanced"] >= 1
    both(bases, "GET", f"/v1/streams/{sid}/scores?top_k=3")
    _, r = both(bases, "POST", f"/v1/streams/{sid}/flush")
    assert r["flushed"] is True
    _, r = both(bases, "GET", f"/v1/streams/{sid}/scores")
    assert len(r["top_k"]) == 5
    assert both(bases, "DELETE", f"/v1/streams/{sid}")[1]["closed"] is True


def test_l16_body_and_querystring_routes(pair):
    bases, cfg, wav, _ = pair
    pcm16 = audio_io.pcm16_quantize(wav[:_samples_per_patches(cfg.frontend, 3)])
    sid = both(bases, "POST", "/v1/streams")[1]["sid"]
    _, r = both(bases, "POST", f"/v1/streams/{sid}/audio?src=mic", pcm16.tobytes(),
                "audio/L16; rate=16000")
    assert r["fed_samples"] == len(pcm16) and r["advanced"] == 1
    both(bases, "GET", f"/v1/streams/{sid}/scores?top_k=4")
    both(bases, "POST", f"/v1/streams/{sid}/flush?now=1")
    both(bases, "DELETE", f"/v1/streams/{sid}?reason=done")


def test_mulaw_body(pair):
    """audio/basic: the same replies from both services, and the port's
    scores track its float32 feed of the same audio within the codec's
    tolerance."""
    bases, cfg, wav, _ = pair
    audio = wav[:_samples_per_patches(cfg.frontend, 3)]
    sids = [both(bases, "POST", "/v1/streams")[1]["sid"] for _ in range(2)]
    both(bases, "POST", f"/v1/streams/{sids[0]}/audio", audio_io.mulaw_encode(audio).tobytes(),
         "audio/basic")
    both(bases, "POST", f"/v1/streams/{sids[1]}/audio", audio.tobytes())
    _, mu = both(bases, "GET", f"/v1/streams/{sids[0]}/scores")
    _, f32 = both(bases, "GET", f"/v1/streams/{sids[1]}/scores")
    want = dict(f32["top_k"])
    for name, p in mu["top_k"]:
        np.testing.assert_allclose(p, want[name], **MULAW_TOL)
    for sid in sids:
        both(bases, "DELETE", f"/v1/streams/{sid}")


def test_adpcm4_partial_block_x_samples(pair):
    """An adpcm4 body whose last block is partial, to an int16 server: the
    host decode slices the padding off at X-Samples, and fed_samples
    reports the true count."""
    bases, cfg, wav, _ = pair
    n = _samples_per_patches(cfg.frontend, 3) + 17
    assert n % adpcm.SERVE_BLOCK
    padded = np.concatenate([wav[:n], np.repeat(wav[n - 1], (-n) % adpcm.SERVE_BLOCK)])
    wire = adpcm.adpcm4_encode(audio_io.pcm16_quantize(padded), block=adpcm.SERVE_BLOCK)
    sid = both(bases, "POST", "/v1/streams")[1]["sid"]
    _, r = both(bases, "POST", f"/v1/streams/{sid}/audio", wire.tobytes(), "audio/adpcm4",
                headers={"X-Samples": str(n)})
    assert r["fed_samples"] == n
    both(bases, "GET", f"/v1/streams/{sid}/scores?top_k=4")
    both(bases, "DELETE", f"/v1/streams/{sid}")


def test_wav_body_and_flush(pair, tmp_path):
    bases, cfg, wav, _ = pair
    p = tmp_path / "clip.wav"
    audio_io.write_wav(str(p), wav[: 16000 * 2], 16000)
    sid = both(bases, "POST", "/v1/streams")[1]["sid"]
    _, r = both(bases, "POST", f"/v1/streams/{sid}/audio", p.read_bytes(), "audio/wav")
    assert r["fed_samples"] == 16000 * 2
    assert both(bases, "POST", f"/v1/streams/{sid}/flush")[1]["flushed"] is True
    both(bases, "GET", f"/v1/streams/{sid}/scores")
    both(bases, "DELETE", f"/v1/streams/{sid}")


def test_one_shot_tag(pair, tmp_path):
    """POST /v1/tag with a float32 body and with a WAV file; the transient
    slots are released."""
    bases, cfg, wav, _ = pair
    audio = wav[:_samples_per_patches(cfg.frontend, 6)]
    both(bases, "POST", "/v1/tag?top_k=4", audio.tobytes())
    p = tmp_path / "t.wav"
    audio_io.write_wav(str(p), audio, cfg.frontend.sample_rate)
    for _ in range(4):  # more calls than slots
        _, r = both(bases, "POST", "/v1/tag", p.read_bytes(), "audio/wav")
        assert len(r["top_k"]) == 5
    assert http_call(bases[0], "GET", "/v1/healthz")[1]["open_streams"] == 0


def test_async_feeds_match_sync(pair):
    """?sync=0 feeds through the port's client give the scores of a sync
    stream of the same audio, on both services; the backlog drains to 0."""
    bases, cfg, wav, _ = pair
    audio = wav[:_samples_per_patches(cfg.frontend, 6)]
    out = []
    for base in bases:
        c = TagClient(base, timeout=30)
        try:
            with c.stream(wire="float32", sync=False) as s:
                for off in range(0, len(audio), 30000):
                    s.feed(audio[off: off + 30000])
                got = s.scores(top_k=4)
            assert c.health()["backlog"] == 0
            with c.stream(wire="float32") as s2:
                s2.feed(audio)
                want = s2.scores(top_k=4)
        finally:
            c.close()
        assert [g[0] for g in got] == [w[0] for w in want]
        np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                                   rtol=1e-6, atol=1e-7)
        out.append(got)
    assert [n for n, _ in out[0]] == [n for n, _ in out[1]]
    np.testing.assert_allclose([p for _, p in out[0]], [p for _, p in out[1]],
                               rtol=1e-4, atol=1e-5)


def test_timeline_window(pair):
    """GET .../timeline: a 10-patch stream keeps its last 8 patches; the
    window's classes, weights and probabilities match JAX's."""
    bases, cfg, wav, _ = pair
    audio = wav[:_samples_per_patches(cfg.frontend, 10)]
    sid = both(bases, "POST", "/v1/streams")[1]["sid"]
    both(bases, "GET", f"/v1/streams/{sid}/timeline")  # 409: nothing folded yet
    both(bases, "POST", f"/v1/streams/{sid}/audio", audio.tobytes())
    both(bases, "POST", f"/v1/streams/{sid}/flush")
    _, r = both(bases, "GET", f"/v1/streams/{sid}/timeline?top_k=3")
    assert r["start_patch"] == 2 and len(r["probs"]) == 8 and len(r["classes"]) == 3
    both(bases, "DELETE", f"/v1/streams/{sid}")


def test_reload_second_weights(pair):
    """POST /v1/reload through a reload_fn that returns second weights: an
    open stream keeps serving, a stream opened afterwards scores with the
    new weights on both services; then back to the first weights."""
    bases, cfg, wav, current = pair
    audio = wav[:_samples_per_patches(cfg.frontend, 3)]
    sid = both(bases, "POST", "/v1/streams")[1]["sid"]
    both(bases, "POST", f"/v1/streams/{sid}/audio", audio.tobytes())
    _, before = both(bases, "GET", f"/v1/streams/{sid}/scores")
    current["i"] = 1
    try:
        _, r = both(bases, "POST", "/v1/reload")
        assert r == {"reloaded": True, "i": 1}
        both(bases, "POST", f"/v1/streams/{sid}/audio", audio.tobytes())
        both(bases, "GET", f"/v1/streams/{sid}/scores")
        fresh = both(bases, "POST", "/v1/streams")[1]["sid"]
        both(bases, "POST", f"/v1/streams/{fresh}/audio", audio.tobytes())
        _, after = both(bases, "GET", f"/v1/streams/{fresh}/scores")
        assert after != before
        both(bases, "DELETE", f"/v1/streams/{fresh}")
    finally:
        current["i"] = 0
        both(bases, "POST", "/v1/reload")
    both(bases, "DELETE", f"/v1/streams/{sid}")


def test_error_paths(pair):
    """404 (closed stream, unknown route), 409 (no audio folded yet), 400
    (a float32 body not a multiple of 4 bytes), 413 (over the body cap);
    the same status and keys from both services."""
    bases, _, _, _ = pair
    assert both(bases, "GET", "/v1/streams/99/scores")[0] == 404
    assert both(bases, "DELETE", "/v1/streams/99")[0] == 404
    assert both(bases, "GET", "/v1/nosuchroute")[0] == 404
    sid = both(bases, "POST", "/v1/streams")[1]["sid"]
    assert both(bases, "GET", f"/v1/streams/{sid}/scores")[0] == 409
    assert both(bases, "POST", f"/v1/streams/{sid}/audio", b"abc")[0] == 400
    big = {"Content-Length": str(100 * 1024 * 1024 * 1024)}
    assert both(bases, "POST", f"/v1/streams/{sid}/audio", b"\0\0\0\0", headers=big)[0] == 413
    both(bases, "DELETE", f"/v1/streams/{sid}")


def test_unread_body_closes_keepalive(pair):
    """A body no route reads is not left in the socket: the reply announces
    and performs a connection close, so keep-alive cannot desync."""
    bases, _, _, _ = pair
    host, port = bases[0].replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", "/v1/nosuchroute", body=b"x" * 4096,
                     headers={"Content-Type": "application/octet-stream"})
        r = conn.getresponse()
        r.read()
        assert r.status == 404 and r.will_close
    finally:
        conn.close()


def test_device_rule_and_mesh(pair):
    """Without device= and without a card, create_server raises rather than
    serve on the CPU; with a 2-shard CPU mesh (``serve --shard_streams``) a
    stream on the second shard is served the scores JAX's one-shot tag
    gives the same audio, as tests/test_http_serve.py holds JAX's own."""
    _, cfg, wav, _ = pair
    jcfg = configs({"frontend.precision": "highest"})[0]
    variables, flat = jax_weights(jcfg.model, seed=21)
    sd = torch_state_dict(cfg.model, flat)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_server(cfg, sd, port=0)
    srv = create_server(cfg, sd, port=0, max_streams=2, chunk_patches=3,
                        transfer_dtype="float32", mesh=make_mesh(devices=["cpu", "cpu"]))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = "http://%s:%d" % srv.server_address[:2]
    try:
        audio = wav[:_samples_per_patches(cfg.frontend, 3)]
        sids = [http_call(base, "POST", "/v1/streams")[1]["sid"] for _ in range(2)]
        assert sids == [0, 1]
        assert http_call(base, "POST", "/v1/streams/1/audio", audio.tobytes())[1][
            "advanced"] == 1
        got = http_call(base, "GET", "/v1/streams/1/scores?top_k=4")[1]["top_k"]
        want = jax_tag_clip(jcfg, variables, audio)
        order = np.argsort(-want)[:4]
        labels = srv.state.labels
        assert [g[0] for g in got] == [labels[i] for i in order]
        np.testing.assert_allclose([g[1] for g in got], want[order], rtol=1e-4, atol=1e-5)
    finally:
        srv.shutdown()
        srv.server_close()
    t.join(timeout=30)
