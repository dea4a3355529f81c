"""The PyTorch port's native C++ front (serve/native_front.py over
native/serve_front.cpp) beside JAX's: one request sequence goes to both
services, on the int16 and adpcm4 fast paths (the body's format is the
server's wire: C++ buffers it, no Python per request) and the slow paths
(WAV bodies, mismatched wires, the flush tail, the one-shot tag), and every
reply must match in status, keys and labels, probabilities within the
reference tests' tolerance. Also: the build is the g++ build of the
unedited source into build/mla_tpu_torch/, and a failed build raises."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.serve import native_front as jax_native  # noqa: E402
from mla_tpu_torch.data import adpcm, audio_io  # noqa: E402
from mla_tpu_torch.ops import _build  # noqa: E402
from mla_tpu_torch.serve.client import TagClient  # noqa: E402
from mla_tpu_torch.serve.native_front import create_native_server  # noqa: E402
from mla_tpu_torch.serve.streaming import _samples_per_patches  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    both,
    configs,
    http_call,
    jax_weights,
    torch_state_dict,
)

JAX_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs({"frontend.precision": "highest"})
    (v1, f1), (v2, f2) = jax_weights(jcfg.model, seed=31), jax_weights(jcfg.model, seed=32)
    wav = (np.random.default_rng(9).standard_normal(16000 * 12) * 0.1).astype(np.float32)
    return (jcfg, tcfg, {"port": [torch_state_dict(tcfg.model, f) for f in (f1, f2)],
                         "jax": [v1, v2]}, wav)


def _pair(setup, wire, current):
    jcfg, tcfg, weights, _ = setup
    kw = dict(port=0, max_streams=3, chunk_patches=3, transfer_dtype=wire, timeline_cap=8)
    ours = create_native_server(
        tcfg, weights["port"][0], device="cpu",
        reload_fn=lambda: (weights["port"][current["i"]], {"i": current["i"]}), **kw)
    try:
        ref = jax_native.create_native_server(
            jcfg, weights["jax"][0],
            reload_fn=lambda: (weights["jax"][current["i"]], {"i": current["i"]}), **kw)
    except BaseException:
        ours.server_close()
        raise
    return ours, ref


@pytest.fixture(scope="module", params=["int16", "adpcm4"])
def served(setup, request):
    current = {"i": 0}
    ours, ref = _pair(setup, request.param, current)
    yield request.param, tuple("http://%s:%d" % s.server_address for s in (ours, ref)), current
    for s in (ours, ref):
        s.server_close()
    assert not any(t.is_alive() for t in ours._threads)


def _fast_body(wire, audio):
    """A body in the server's own wire format: the C++ fast path."""
    if wire == "int16":
        return audio_io.pcm16_quantize(audio).tobytes(), "audio/L16"
    return (adpcm.adpcm4_encode(audio_io.pcm16_quantize(audio), block=adpcm.SERVE_BLOCK)
            .tobytes(), "audio/adpcm4")


def test_build_goes_to_build_dir():
    """The unedited native/serve_front.cpp, built with the reference's g++
    flags into build/mla_tpu_torch/ under a hash of source, flags and target;
    nothing is written under native/ by the port."""
    path = _build.native_library_path("serve_front")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libserve_front_")
    assert _build.GXX_FLAGS == ("-O3", "-std=c++17", "-fPIC", "-march=native", "-shared",
                                "-pthread")
    lib = _build.load_native("serve_front")
    assert path.exists() and lib._name == str(path)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_build, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed for broken.cpp.*error"):
        _build.load_native("broken")
    assert not list((tmp_path / "build").glob("*.so"))


def test_healthz(served):
    _, bases, _ = served
    (s, got), (ws, want) = (http_call(b, "GET", "/v1/healthz") for b in bases)
    assert s == ws == 200 and sorted(got) == sorted(want) and got["native_front"] is True
    for k in ("ok", "max_streams", "variant", "sample_rate", "transfer_dtype"):
        assert got[k] == want[k], k


def test_fast_path_lifecycle(served):
    """The server's own wire in odd-sized whole-unit bodies, then flush of
    the tail, scores and the timeline."""
    wire, bases, _ = served
    # adpcm bodies in whole 64-sample blocks, the tail a whole patch past two chunks
    n = _samples_per_patches(configs()[1].frontend, 7) // 64 * 64
    audio = np.random.default_rng(3).standard_normal(n).astype(np.float32) * 0.1
    sid = both(bases, "POST", "/v1/streams")[1]["sid"]
    cut = 64 * 700
    for lo, hi in ((0, cut), (cut, n)):
        body, ctype = _fast_body(wire, audio[lo:hi])
        _, r = both(bases, "POST", f"/v1/streams/{sid}/audio", body, ctype)
        assert r["fed_samples"] == hi - lo
    both(bases, "GET", f"/v1/streams/{sid}/scores?top_k=3")
    assert both(bases, "POST", f"/v1/streams/{sid}/flush")[1]["flushed"] is True
    both(bases, "GET", f"/v1/streams/{sid}/scores")
    _, r = both(bases, "GET", f"/v1/streams/{sid}/timeline?top_k=2")
    assert len(r["probs"]) == 7
    both(bases, "DELETE", f"/v1/streams/{sid}")


def test_slow_paths_wav_and_mismatched_wire(served, tmp_path):
    """A WAV body, a float32 body (host-encoded: the mismatched wire), and
    an adpcm4 body with a partial last block and X-Samples; each stream
    flushed with a sub-chunk tail."""
    wire, bases, _ = served
    cfg = configs()[1]
    audio = (np.random.default_rng(4).standard_normal(40000) * 0.1).astype(np.float32)
    p = tmp_path / "clip.wav"
    audio_io.write_wav(str(p), audio, 16000)
    n = 35000 + 17
    padded = np.concatenate([audio[:n], np.repeat(audio[n - 1], (-n) % adpcm.SERVE_BLOCK)])
    bodies = [(p.read_bytes(), "audio/wav", {}), (audio.tobytes(), "application/octet-stream", {}),
              (adpcm.adpcm4_encode(audio_io.pcm16_quantize(padded), block=adpcm.SERVE_BLOCK)
               .tobytes(), "audio/adpcm4", {"X-Samples": str(n)})]
    for body, ctype, headers in bodies:
        sid = both(bases, "POST", "/v1/streams")[1]["sid"]
        both(bases, "POST", f"/v1/streams/{sid}/audio", body, ctype, headers=headers)
        assert both(bases, "POST", f"/v1/streams/{sid}/flush")[1]["flushed"] is True
        both(bases, "GET", f"/v1/streams/{sid}/scores?top_k=4")
        both(bases, "DELETE", f"/v1/streams/{sid}")
    assert _samples_per_patches(cfg.frontend, 3) > 40000  # each clip is a flush tail


def test_adpcm_remainder_then_wire_rejected(served):
    """On the adpcm4 wire, a float feed that leaves a sub-block remainder
    makes a following pre-encoded wire feed a 400 (its blocks would land
    before the remainder's audio); flush consumes the remainder, and wire
    feeds work again. The int16 wire has no remainder: both feeds take."""
    wire, bases, _ = served
    audio = (np.random.default_rng(6).standard_normal(50017) * 0.1).astype(np.float32)
    sid = both(bases, "POST", "/v1/streams")[1]["sid"]
    both(bases, "POST", f"/v1/streams/{sid}/audio", audio.tobytes())
    body, ctype = _fast_body(wire, audio[:256])
    status = both(bases, "POST", f"/v1/streams/{sid}/audio", body, ctype)[0]
    assert status == (400 if wire == "adpcm4" else 200)
    both(bases, "POST", f"/v1/streams/{sid}/flush")
    assert both(bases, "POST", f"/v1/streams/{sid}/audio", body, ctype)[1]["fed_samples"] == 256
    both(bases, "DELETE", f"/v1/streams/{sid}")


def test_one_shot_tag(served):
    wire, bases, _ = served
    audio = (np.random.default_rng(8).standard_normal(70000) * 0.1).astype(np.float32)
    both(bases, "POST", "/v1/tag?top_k=4", audio.tobytes())
    body, ctype = _fast_body(wire, audio[:64 * 1000])
    for _ in range(4):  # more calls than slots: no slot leaks
        both(bases, "POST", "/v1/tag", body, ctype)
    assert http_call(bases[0], "GET", "/v1/healthz")[1]["open_streams"] == 0


def test_concurrent_streams_match_jax(served):
    """Three client threads per service, each streaming its own audio in the
    server's wire through the port's TagClient: the same scores on both."""
    wire, bases, _ = served
    audios = [(np.random.default_rng(20 + i).standard_normal(60000 + 9000 * i) * 0.1)
              .astype(np.float32) for i in range(3)]
    results = {}

    def client(base, i):
        c = TagClient(base, timeout=30)
        try:
            with c.stream(wire=wire) as s:
                for lo in range(0, len(audios[i]), 7001):
                    s.feed(audios[i][lo:lo + 7001])
                s.flush()
                results[base, i] = s.scores(top_k=5)
        finally:
            c.close()

    ts = [threading.Thread(target=client, args=(b, i)) for b in bases for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts) and len(results) == 6
    for i in range(3):
        got, want = results[bases[0], i], results[bases[1], i]
        assert [n for n, _ in got] == [n for n, _ in want]
        np.testing.assert_allclose([p for _, p in got], [p for _, p in want], **JAX_TOL)


def test_reload_second_weights(served):
    wire, bases, current = served
    body, ctype = _fast_body(wire, (np.random.default_rng(2).standard_normal(64 * 800) * 0.1)
                             .astype(np.float32))
    sid = both(bases, "POST", "/v1/streams")[1]["sid"]
    both(bases, "POST", f"/v1/streams/{sid}/audio", body, ctype)
    _, before = both(bases, "GET", f"/v1/streams/{sid}/scores")
    current["i"] = 1
    try:
        assert both(bases, "POST", "/v1/reload")[1] == {"reloaded": True, "i": 1}
        fresh = both(bases, "POST", "/v1/streams")[1]["sid"]
        both(bases, "POST", f"/v1/streams/{fresh}/audio", body, ctype)
        _, after = both(bases, "GET", f"/v1/streams/{fresh}/scores")
        assert after != before
        both(bases, "DELETE", f"/v1/streams/{fresh}")
    finally:
        current["i"] = 0
        both(bases, "POST", "/v1/reload")
    both(bases, "DELETE", f"/v1/streams/{sid}")


def test_error_paths(served):
    wire, bases, _ = served
    assert both(bases, "GET", "/v1/streams/99/scores")[0] == 404
    assert both(bases, "DELETE", "/v1/streams/99")[0] == 404
    assert both(bases, "GET", "/v1/nosuchroute")[0] == 404
    sid = both(bases, "POST", "/v1/streams")[1]["sid"]
    assert both(bases, "GET", f"/v1/streams/{sid}/scores")[0] == 409
    assert both(bases, "POST", f"/v1/streams/{sid}/audio", b"abc")[0] == 400
    big = {"Content-Length": str(100 * 1024 * 1024 * 1024)}
    assert both(bases, "POST", f"/v1/streams/{sid}/audio", b"\0\0\0\0", headers=big)[0] == 413
    both(bases, "DELETE", f"/v1/streams/{sid}")


def test_device_rule_and_mesh(setup):
    _, tcfg, weights, _ = setup
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_native_server(tcfg, weights["port"][0], port=0)
    with pytest.raises(NotImplementedError, match="item 9"):
        create_native_server(tcfg, weights["port"][0], port=0, mesh=object(), device="cpu")
