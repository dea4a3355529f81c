"""The port's ``profile`` verb and ``utils/profiling.py`` against the
reference's on the CPU at a tiny size: the verb prints the reference's JSON
keys for the same steps and batch and writes a Chrome / Perfetto trace
file holding the train step's ops and its ``mla.train.*`` spans;
``annotate`` names a span in a trace; ``time_fn`` keeps the reference's
fields; ``sync`` hands its tree back; ``memory_stats`` reads nothing off a
card."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import contextlib  # noqa: E402
import glob  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mla_tpu.__main__ import main as jmain  # noqa: E402
from mla_tpu.utils import profiling as jprof  # noqa: E402
from mla_tpu_torch.__main__ import main as tmain  # noqa: E402
from mla_tpu_torch.utils import profiling  # noqa: E402

TINY = ["--steps=2", "--batch=2", "--set", "model.conv_channels=8", "model.hidden_units=16",
        "model.convs_per_stage=1", "data.n_train_clips=4", "data.clip_seconds=2.0",
        "train.data_parallel=1"]


def _json_line(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_profile_verb_keys_and_trace(tmp_path):
    t = _json_line(tmain, ["profile", "--config=esc50_single_attention",
                           f"--out={tmp_path / 't'}", "--device=cpu", *TINY])
    j = _json_line(jmain, ["profile", "--config=esc50_single_attention",
                           f"--out={tmp_path / 'j'}", *TINY])
    assert t.keys() == j.keys() == {"trace_dir", "steps", "batch", "mean_step_ms",
                                    "clips_per_sec", "memory"}
    assert (t["steps"], t["batch"]) == (j["steps"], j["batch"]) == (2, 2)
    assert t["trace_dir"] == str(tmp_path / "t") and t["mean_step_ms"] > 0
    assert t["memory"] == {}  # the CPU: no allocator counters
    files = glob.glob(os.path.join(t["trace_dir"], "*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("convolution" in n for n in names) and any("adam" in n.lower() for n in names)
    assert {"mla.train.forward", "mla.train.optimizer"} <= names


def test_annotate_names_a_span(tmp_path):
    with profiling.trace(str(tmp_path)) as d:
        with profiling.annotate("my_region"):
            torch.ones(4).sum()
    assert d == str(tmp_path)
    (path,) = glob.glob(str(tmp_path / "*.json"))
    assert any(e.get("name") == "my_region" for e in json.load(open(path))["traceEvents"])


def test_time_fn_sync_memory():
    def fn(x):
        return x * 2

    got = profiling.time_fn(fn, torch.ones(8), iters=3, warmup=1)
    want = jprof.time_fn(fn, jnp.ones(8), iters=3, warmup=1)
    assert got.keys() == want.keys() == {"mean_ms", "total_s", "iters_per_sec"}
    assert got["mean_ms"] > 0 and abs(got["iters_per_sec"] * got["total_s"] - 3) < 1e-9
    tree = {"a": [torch.ones(2), (torch.zeros(1),)], "b": 3}
    assert profiling.sync(tree) is tree
    assert profiling.memory_stats("cpu") == {}
