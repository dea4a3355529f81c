"""The port's client side and host modules against JAX's: the client's wire
encoder byte for byte on every wire, event detection on seeded timelines,
label maps, wav IO and resampling; then the CLI end to end: ``python -m
mla_tpu_torch serve`` on the CPU in a subprocess, tagged by ``python -m
mla_tpu_torch tag``. The reference reads, resamples and encodes through its
native library (``mla_tpu.data.native``), pinned for the whole module by
``reference_native_libraries``, never through its numpy / scipy fallback."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mla_tpu.data import audio_io as jax_audio_io  # noqa: E402
from mla_tpu.data import labels as jax_labels  # noqa: E402
from mla_tpu.serve import client as jax_client  # noqa: E402
from mla_tpu.serve import events as jax_events  # noqa: E402
from mla_tpu_torch.data import audio_io, labels  # noqa: E402
from mla_tpu_torch.serve import client, events  # noqa: E402
from mla_tpu_torch.serve.http import create_server  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    SMALL,
    configs,
    jax_weights,
    reference_native_libraries,
    torch_state_dict,
)

pytestmark = pytest.mark.usefixtures("reference_native_libraries")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIRES = ["float32", "int16", "mulaw", "adpcm4", "adpcm2"]


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_wire_encoder_bytes_equal_jax(wire, dtype):
    """Feeds of odd sizes (sub-block remainders carried between them) and
    the final flush: every body byte for byte JAX's."""
    rng = np.random.default_rng(1)
    x = np.clip(rng.standard_normal(20000) * 0.3, -1, 1).astype(np.float32)
    if dtype == "int16":
        x = audio_io.pcm16_quantize(x)
    ours, ref = client._WireEncoder(wire), jax_client._WireEncoder(wire)
    for lo, hi in ((0, 33), (33, 7001), (7001, 7040), (7040, 19999)):
        assert ours.encode(x[lo:hi]) == ref.encode(x[lo:hi])
    assert ours.encode(x[19999:], final=True) == ref.encode(x[19999:], final=True)
    assert ours.encode(np.zeros(0, np.int16), final=True) == b""


def test_wire_encoder_rejects_unknown_wire():
    with pytest.raises(ValueError):
        client._WireEncoder("flac")


def _timeline(seed, t=23, c=6):
    rng = np.random.default_rng(seed)
    probs = rng.uniform(0, 1, (t, c)).astype(np.float32)
    weights = rng.dirichlet(np.ones(t), c).T.astype(np.float32)
    return probs, weights


@pytest.mark.parametrize("kw", [
    dict(threshold=0.5),
    dict(threshold=0.3, merge_gap_s=1.0, min_dur_s=1.5, start_patch=7),
    dict(threshold=np.linspace(0.2, 0.8, 6), hop_s=0.5, classes=[5, 1, 3]),
    dict(threshold=0.6, merge_gap_s=2.0, class_names=[f"c{i}" for i in range(6)]),
])
def test_detect_events_equal_jax(kw):
    for seed in range(3):
        probs, weights = _timeline(seed)
        got = events.detect_events(probs, weights, **kw)
        assert got == jax_events.detect_events(probs, weights, **kw)
        assert got == sorted(got, key=lambda ev: (ev["t_start"], -ev["score"]))


@pytest.mark.parametrize("threshold", [0.4, "table"])
def test_events_from_timeline_payload_equal_jax(threshold):
    probs, weights = _timeline(5, t=12, c=3)
    payload = {"start_patch": 4, "hop_s": 0.96,
               "classes": [["dog", 0.9], ["cat", 0.7], ["rain", 0.4]],
               "probs": probs.tolist(), "weights": weights.tolist()}
    if threshold == "table":
        threshold = {"dog": 0.3, "cat": 0.5, "rain": 0.7, "wind": 0.1}
    kw = dict(threshold=threshold, merge_gap_s=0.96, min_dur_s=0.5)
    assert (events.events_from_timeline_payload(payload, **kw)
            == jax_events.events_from_timeline_payload(payload, **kw))
    with pytest.raises(ValueError, match="lacks"):
        events.events_from_timeline_payload(payload, threshold={"dog": 0.5})


@pytest.mark.parametrize("dataset,n", [("synthetic_esc50", 50), ("synthetic_us8k", 10),
                                       ("synthetic_audioset", 527), ("synthetic_esc50", 7)])
def test_labels_equal_jax(dataset, n):
    assert labels.labels_for(dataset, n) == jax_labels.labels_for(dataset, n)


def test_wav_io_and_resample_equal_jax(tmp_path):
    """write_wav -> read_wav / read_wav_bytes, and the 22.05 -> 16 kHz
    polyphase resample, against the reference's module."""
    rng = np.random.default_rng(3)
    x = np.clip(rng.standard_normal(22050) * 0.3, -1, 1).astype(np.float32)
    p = str(tmp_path / "a.wav")
    audio_io.write_wav(p, x, 22050)
    got, sr = audio_io.read_wav(p)
    want, want_sr = jax_audio_io.read_wav(p)
    assert sr == want_sr == 22050
    np.testing.assert_array_equal(got, want)
    with open(p, "rb") as fh:
        got_b, _ = audio_io.read_wav_bytes(fh.read())
    np.testing.assert_array_equal(got_b, got)
    np.testing.assert_allclose(audio_io.resample(got, 22050, 16000),
                               jax_audio_io.resample(want, 22050, 16000), rtol=0, atol=1e-5)
    np.testing.assert_allclose(audio_io.load_wav_16k(p), jax_audio_io.load_wav_16k(p),
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def served():
    """The port's stdlib front on the CPU (adpcm4 wire), tagged through the
    port's client."""
    jcfg, tcfg = configs()
    _, flat = jax_weights(jcfg.model, seed=41)
    srv = create_server(tcfg, torch_state_dict(tcfg.model, flat), port=0, max_streams=2,
                        chunk_patches=2, transfer_dtype="adpcm4", device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    n = 16000 * 7
    wav = np.clip(0.4 * np.sin(2 * np.pi * 440 * np.arange(n) / 16000)
                  + 0.1 * np.random.default_rng(7).standard_normal(n), -1, 1).astype(np.float32)
    yield client.TagClient("http://%s:%d" % srv.server_address[:2], timeout=30), wav
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def test_client_stream_matches_one_shot(served):
    """A stream of odd-sized feeds (client-side remainders) and the one-shot
    tag carve the same 64-sample blocks, so their scores agree; every wire
    of the one-shot gives the same top-1."""
    c, wav = served
    ref = c.tag(wav, wire="adpcm4", top_k=3)
    with c.stream(wire="adpcm4") as s:
        for lo in range(0, len(wav), 7001):
            s.feed(wav[lo:lo + 7001])
        s.flush()
        got = s.scores(top_k=3)
    assert [n for n, _ in got] == [n for n, _ in ref]
    np.testing.assert_allclose([p for _, p in got], [p for _, p in ref], atol=1e-4)
    for wire in ("float32", "int16", "mulaw", "adpcm2"):
        assert c.tag(wav, wire=wire)[0][0] == ref[0][0], wire


def test_client_errors_and_base_url():
    with pytest.raises(ValueError, match="https"):
        client.TagClient("https://example.invalid")
    with pytest.raises(ValueError, match="path"):
        client.TagClient("http://127.0.0.1:1/prefix")
    c = client.TagClient("127.0.0.1:8123")
    assert (c.host, c.port) == ("127.0.0.1", 8123)


def test_client_maps_http_errors(served):
    c, _ = served
    with pytest.raises(client.TagServiceError) as e:
        c._request("GET", "/v1/streams/99/scores")
    assert e.value.status == 404
    with pytest.raises(client.TagServiceError) as e:
        c.reload()  # no reload source configured
    assert e.value.status == 409


def _terminate(proc):
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


def test_serve_and_tag_verbs(tmp_path):
    """``serve --device cpu --port 0 --checkpoint random`` in a subprocess:
    its ``serving ...`` line gives the port; ``tag`` one-shot (adpcm4 wire,
    and the WAV file as it is) and through the stream API with --timeline
    and --events prints top-k JSON and writes both files."""
    sets = [f"{k}={v}" for k, v in SMALL.items()]
    env = {**os.environ, "PYTHONPATH": ROOT}
    wav = (0.3 * np.sin(2 * np.pi * 330 * np.arange(16000 * 7) / 16000)).astype(np.float32)
    clip = str(tmp_path / "clip.wav")
    audio_io.write_wav(clip, wav, 16000)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mla_tpu_torch", "serve", "--device", "cpu", "--port", "0",
         "--checkpoint", "random", "--workspace", str(tmp_path / "ws"), "--timeline_cap", "8",
         "--set", *sets],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving multi_level_attention on http://127.0.0.1:"), line
        url = line.split(" on ")[1].split("/v1")[0]

        def tag(*extra):
            out = subprocess.run([sys.executable, "-m", "mla_tpu_torch", "tag", "--url", url,
                                  "--wav", clip, "--top_k", "3", *extra],
                                 cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
            assert out.returncode == 0, out.stderr
            top = json.loads(out.stdout.strip().splitlines()[-1])["top_k"]
            assert len(top) == 3 and all(0 <= p <= 1 for _, p in top)
            return top

        one_shot = tag("--wire", "adpcm4")
        assert tag("--wire", "wav")[0][0] == one_shot[0][0]
        csv, ev = str(tmp_path / "tl.csv"), str(tmp_path / "ev.json")
        streamed = tag("--wire", "int16", "--timeline", csv, "--events", ev,
                       "--event_threshold", "0.4")
        assert streamed[0][0] == one_shot[0][0]
        rows = open(csv).read().splitlines()
        assert rows[0].startswith("patch,time_s,prob:") and len(rows) == 1 + 7
        assert json.load(open(ev))["threshold"] == 0.4
    finally:
        _terminate(proc)
        proc.stdout.close()
