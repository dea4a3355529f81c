"""The port's ``infer`` verb against the reference's (both CLIs in process):
one flat .npz loaded by both packages' ``weights --load`` into
``streaming_inference`` cut small, then one clip one-shot and with
``--stream``, each with ``--timeline``, ``--events`` and ``--plot``, a
``--thresholds`` table, and ``--wav_dir`` over three clips of different
lengths with a timeline directory and a combined events file. Top-k names
equal, scores and timelines within 1e-4, events equal (times exact, scores
within 1e-4); the refusals carry the reference's messages. The reference reads
wavs through its native library (``mla_tpu.data.native``), pinned for the
whole module by ``reference_native_libraries``, never through its numpy /
scipy fallback."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import contextlib  # noqa: E402
import csv  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mla_tpu.__main__ import main as jmain  # noqa: E402
from mla_tpu_torch.__main__ import main as tmain  # noqa: E402
from mla_tpu_torch.data.audio_io import write_wav  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    SMALL,
    configs,
    jax_weights,
    reference_native_libraries,
)

pytestmark = pytest.mark.usefixtures("reference_native_libraries")

TOL = 1e-4
SETS = ["--set"] + [f"{k}={v}" for k, v in SMALL.items()]
CLIPS = {"a.wav": 3.0, "sub/b.wav": 12.5, "sub/c.wav": 0.5}  # --wav_dir, any lengths


def _call(main, argv):
    """stdout lines of one in-process CLI call."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv + (["--device", "cpu"] if main is tmain else []))
    return buf.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(dir, {"t"|"j": workspace}, the single clip's path)."""
    d = tmp_path_factory.mktemp("infer")
    jcfg, _ = configs()
    _, flat = jax_weights(jcfg.model, seed=7)
    np.savez(d / "w.npz", **flat)
    rng = np.random.default_rng(7)
    t = np.arange(int(16000 * 14.0)) / 16000
    # a tone that comes and goes over noise, so events start and end
    wav = 0.05 * rng.standard_normal(t.shape) + 0.5 * np.sin(2 * np.pi * 900 * t) * (
        (t % 6) < 3)
    write_wav(str(d / "clip.wav"), wav.astype(np.float32))
    for name, secs in CLIPS.items():
        os.makedirs(os.path.dirname(d / "clips" / name), exist_ok=True)
        write_wav(str(d / "clips" / name),
                  (0.3 * rng.standard_normal(int(16000 * secs))).astype(np.float32))
    ws = {}
    for tag, main in (("t", tmain), ("j", jmain)):
        ws[tag] = str(d / f"ws_{tag}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["weights", "--workspace", ws[tag], "--load", str(d / "w.npz"), *SETS])
    return d, ws, str(d / "clip.wav")


def _assert_top_k(got, want):
    """Names in the same order (a swap only where two scores lie within
    2e-4), each score within 1e-4."""
    assert len(got) == len(want)
    scores = dict(want)
    assert {n for n, _ in got} == set(scores)
    for (n, p) in got:
        assert abs(p - scores[n]) <= TOL, n
    for i, ((gn, gp), (wn, wp)) in enumerate(zip(got, want)):
        if gn != wn:
            assert abs(gp - scores[gn]) <= TOL and abs(wp - scores[gn]) <= 2 * TOL, i


def _read_csv(path):
    rows = list(csv.reader(open(path)))
    return rows[0], np.array(rows[1:], float)


def _assert_csv_close(path_t, path_j):
    head_t, vals_t = _read_csv(path_t)
    head_j, vals_j = _read_csv(path_j)
    assert head_t == head_j
    np.testing.assert_allclose(vals_t, vals_j, rtol=0, atol=TOL)


def _assert_events_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], float) and k not in ("t_start", "t_end"):
                assert abs(g[k] - w[k]) <= TOL, k
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("stream", [False, True], ids=["one_shot", "stream"])
def test_single_clip_with_timeline_events_plot(setup, stream):
    d, ws, clip = setup
    out = {}
    for tag, main in (("t", tmain), ("j", jmain)):
        argv = ["infer", "--wav", clip, "--workspace", ws[tag], "--timeline",
                str(d / f"{tag}{stream}.csv"), "--events", str(d / f"{tag}{stream}.json"),
                "--plot", str(d / f"{tag}{stream}.png"), "--event_threshold", "0.3", *SETS]
        out[tag] = json.loads(_call(main, argv + (["--stream"] if stream else []))[-1])
    _assert_top_k(out["t"]["top_k"], out["j"]["top_k"])
    _assert_csv_close(d / f"t{stream}.csv", d / f"j{stream}.csv")
    ev_t, ev_j = (json.load(open(d / f"{tag}{stream}.json")) for tag in ("t", "j"))
    assert ev_t["hop_s"] == ev_j["hop_s"] and ev_t["threshold"] == ev_j["threshold"] == 0.3
    assert ev_j["events"]  # the operating point finds some
    _assert_events_equal(ev_t["events"], ev_j["events"])
    png = [open(d / f"{tag}{stream}.png", "rb").read() for tag in ("t", "j")]
    assert png[0][:8] == b"\x89PNG\r\n\x1a\n"
    assert png[0][16:24] == png[1][16:24]  # the same width and height


def test_per_class_thresholds(setup, tmp_path):
    d, ws, clip = setup
    names = [f"class_{i}" for i in range(int(SMALL["model.n_classes"]))]
    table = tmp_path / "thr.json"
    table.write_text(json.dumps({"target_precision": 0.8, "thresholds": {
        n: 0.2 + 0.1 * i for i, n in enumerate(names)}}))
    evs = []
    for tag, main in (("t", tmain), ("j", jmain)):
        _call(main, ["infer", "--wav", clip, "--workspace", ws[tag], "--events",
                     str(tmp_path / f"{tag}.json"), "--thresholds", str(table),
                     "--event_gap", "1.0", "--event_min_dur", "1.0", *SETS])
        evs.append(json.load(open(tmp_path / f"{tag}.json")))
    assert evs[0]["threshold"] == evs[1]["threshold"] == f"per-class ({table})"
    _assert_events_equal(evs[0]["events"], evs[1]["events"])


def test_wav_dir(setup):
    d, ws, _ = setup
    lines = {}
    for tag, main in (("t", tmain), ("j", jmain)):
        lines[tag] = [json.loads(ln) for ln in _call(main, [
            "infer", "--wav_dir", str(d / "clips"), "--workspace", ws[tag], "--timeline",
            str(d / f"tl_{tag}"), "--events", str(d / f"ev_{tag}.json"), "--top_k", "3",
            "--timeline_cap", "12", *SETS])]
    assert len(lines["t"]) == len(lines["j"]) == len(CLIPS)
    for lt, lj in zip(lines["t"], lines["j"]):
        assert lt["wav"] == lj["wav"] and lt["seconds"] == lj["seconds"]
        _assert_top_k(lt["top_k"], lj["top_k"])
        _assert_events_equal(lt["events"], lj["events"])
    for name in CLIPS:
        stem = os.path.splitext(name)[0] + ".timeline.csv"
        _assert_csv_close(d / "tl_t" / stem, d / "tl_j" / stem)
    ev_t, ev_j = (json.load(open(d / f"ev_{tag}.json")) for tag in ("t", "j"))
    assert ev_t.keys() == ev_j.keys() and ev_t["clips"].keys() == ev_j["clips"].keys()
    for rel in ev_j["clips"]:
        _assert_events_equal(ev_t["clips"][rel], ev_j["clips"][rel])
    # the 12.5 s clip keeps the last 12 patches of its ring
    _, vals = _read_csv(d / "tl_t" / "sub/b.timeline.csv")
    assert len(vals) == 12 and vals[0, 0] > 0


@pytest.mark.parametrize("argv", [["--wav", "X", "--wav_dir", "D"],
                                  ["--wav_dir", "D", "--plot", "p.png"],
                                  []], ids=["both", "dir_plot", "neither"])
def test_refusals_carry_the_reference_messages(setup, argv):
    d, ws, clip = setup
    argv = [a.replace("X", clip).replace("D", str(d / "clips")) for a in argv]
    msgs = []
    for tag, main in (("t", tmain), ("j", jmain)):
        with pytest.raises(SystemExit) as e:
            _call(main, ["infer", *argv, "--workspace", ws[tag], *SETS])
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] and msgs[0].startswith("infer:")
