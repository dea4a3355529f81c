"""The port's ``eval`` verb against the reference's (both CLIs in process):
one flat .npz loaded by both packages' ``weights --load`` into
``us8k_fused_frontend`` cut small (the fused front-end's plain version on
the port's side, the Pallas kernel interpreted on JAX's), then ``eval
--per_class --calibrate --events --sweep`` in each. The stats, the
per-class CSV, the calibrated thresholds and the event scores agree within
1e-5; the six eval clips in batches of 4 pad the last batch. A
``--thresholds`` file drives ``--events`` alike in both, and one that lacks
a class is refused with the reference's message."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import contextlib  # noqa: E402
import csv  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mla_tpu.__main__ import main as jmain  # noqa: E402
from mla_tpu_torch.__main__ import main as tmain  # noqa: E402
from tests.torch_port_common import SMALL, configs, jax_weights  # noqa: E402

TOL = 1e-5
CUT = {"data.n_eval_clips": 6, "data.clip_seconds": 2.0, "train.batch_size": 4,
       "train.data_parallel": 1}
SETS = ["--set"] + [f"{k}={v}" for k, v in {**SMALL, **CUT}.items()]
CONFIG = ["--config", "us8k_fused_frontend"]


def _eval(main, ws, out, extra, capsys):
    argv = ["eval", *CONFIG, "--workspace", ws, *extra, *SETS]
    if main is tmain:
        argv += ["--device", "cpu"]
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"t"|"j": (workspace, output dir, stats)} after both packages loaded
    one npz and ran eval with every output flag."""
    d = tmp_path_factory.mktemp("eval")
    jcfg, _ = configs(CUT, preset="us8k_fused_frontend")
    _, flat = jax_weights(jcfg.model, seed=5)
    np.savez(d / "w.npz", **flat)
    out = {}
    for tag, main in (("t", tmain), ("j", jmain)):
        ws = str(d / f"ws_{tag}")
        buf = io.StringIO()  # capsys is per test; this fixture is per module
        with contextlib.redirect_stdout(buf):
            main(["weights", *CONFIG, "--workspace", ws, "--load", str(d / "w.npz"), *SETS])
            argv = ["eval", *CONFIG, "--workspace", ws, "--per_class", str(d / f"{tag}.csv"),
                    "--calibrate", str(d / f"{tag}.json"), "--events", "--sweep",
                    "--sed_clips", "4", *SETS]
            main(argv + (["--device", "cpu"] if main is tmain else []))
        out[tag] = (ws, d, json.loads(buf.getvalue().strip().splitlines()[-1]))
    return out


def _assert_close(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= TOL, (path, got, want)
    else:
        assert got == want, path


def test_eval_stats_match(runs):
    t, j = runs["t"][2], runs["j"][2]
    _assert_close({k: t[k] for k in ("mAP", "mAUC", "d_prime")},
                  {k: j[k] for k in ("mAP", "mAUC", "d_prime")})


def test_eval_events_and_sweep_match(runs):
    t, j = runs["t"][2], runs["j"][2]
    assert t["events"]["n_clips"] == 4
    _assert_close(t["events"], j["events"], "events")
    _assert_close(t["events_sweep"], j["events_sweep"], "events_sweep")


def test_per_class_csv_matches(runs):
    d = runs["t"][1]
    rows = [list(csv.reader(open(d / f"{tag}.csv"))) for tag in ("t", "j")]
    assert rows[0][0] == rows[1][0] == ["index", "name", "AP", "AUC", "d_prime", "n_pos"]
    assert len(rows[0]) == len(rows[1]) == 1 + int(SMALL["model.n_classes"])
    for rt, rj in zip(rows[0][1:], rows[1][1:]):
        assert rt[:2] == rj[:2] and rt[5] == rj[5]
        # NaN and +-inf (d' at AUC 0 or 1) must match exactly
        np.testing.assert_allclose(np.array(rt[2:5], float), np.array(rj[2:5], float),
                                   rtol=0, atol=TOL)


def test_calibrated_thresholds_match(runs):
    d = runs["t"][1]
    t, j = (json.load(open(d / f"{tag}.json")) for tag in ("t", "j"))
    assert t["target_precision"] == j["target_precision"] == 0.8
    _assert_close(t["thresholds"], j["thresholds"], "thresholds")


def test_events_with_thresholds_file(runs, tmp_path, capsys):
    d = runs["t"][1]
    thr = ["--events", "--thresholds", str(d / "t.json"), "--sed_clips", "3",
           "--event_gap", "0.5", "--event_min_dur", "0.9", "--segment_s", "1.0"]
    t = _eval(tmain, runs["t"][0], d, thr, capsys)
    j = _eval(jmain, runs["j"][0], d, thr, capsys)
    assert t["events"]["threshold"] == "per-class"
    _assert_close(t["events"], j["events"], "events")
    table = json.load(open(d / "t.json"))
    table["thresholds"].pop(next(iter(table["thresholds"])))
    lacking = tmp_path / "lacking.json"
    lacking.write_text(json.dumps(table))
    msgs = []
    for main, tag in ((tmain, "t"), (jmain, "j")):
        with pytest.raises(SystemExit) as e:
            _eval(main, runs[tag][0], d, ["--events", "--thresholds", str(lacking)], capsys)
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] and msgs[0].startswith("--thresholds file lacks 1 of")
