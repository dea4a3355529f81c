"""The TensorBoard sink of the PyTorch port's ScalarWriter
(mla_tpu_torch/utils/logging.py, torch.utils.tensorboard) against the JAX
package's (tf.summary): the same tags, steps and values in the event files,
the CSV byte-equal; the degrade to CSV alone when the sink does not import;
and fit() with train.tensorboard writing what scalars.csv holds. This is the
one port test module that imports tensorflow (the reference's sink)."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import csv  # noqa: E402
import glob  # noqa: E402
import logging  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from tensorboard.backend.event_processing.event_accumulator import (  # noqa: E402
    EventAccumulator,
)
from tensorboard.util import tensor_util  # noqa: E402

from mla_tpu.utils import logging as jlogging  # noqa: E402
from mla_tpu_torch.utils import logging as tlogging  # noqa: E402

# what fit() logs: the loss and throughput at the log cadence, the eval
# stats at the eval cadence (values off the f32 grid, d' = inf included)
WRITES = [(1, {"loss": 0.6931471805599453, "clips_per_sec": 123.456789}),
          (5, {"loss": 0.41, "clips_per_sec": 1e5 / 3}),
          (5, {"mAP": 0.123456789, "mAUC": 0.87654321, "d_prime": float("inf")}),
          (10, {"loss": 1e-7, "clips_per_sec": 0.0}),
          (10, {"mAP": 0.5, "mAUC": 1.0, "d_prime": 2.5})]


def _write(module, csv_path, tb_dir):
    w = module.ScalarWriter(str(csv_path), tensorboard_dir=tb_dir and str(tb_dir))
    for step, scalars in WRITES:
        w.write(step, scalars)
    w.close()


def _events(tb_dir, as_tensors):
    """{tag: [(step, f32 value)]} from the event files under tb_dir."""
    ea = EventAccumulator(str(tb_dir), size_guidance={"scalars": 0, "tensors": 0})
    ea.Reload()
    if as_tensors:
        return {t: [(e.step, np.float32(tensor_util.make_ndarray(e.tensor_proto)))
                    for e in ea.Tensors(t)] for t in ea.Tags()["tensors"]}
    return {t: [(e.step, np.float32(e.value)) for e in ea.Scalars(t)]
            for t in ea.Tags()["scalars"]}


def test_event_files_and_csv_equal_the_references(tmp_path):
    """Tags, steps and values equal as f32 (both sinks store f32; inf
    included); the CSV byte-equal to the reference's and to the port's
    without the sink."""
    _write(jlogging, tmp_path / "j.csv", tmp_path / "jtb")
    _write(tlogging, tmp_path / "t.csv", tmp_path / "ttb")
    _write(tlogging, tmp_path / "plain.csv", None)
    ref, ours = _events(tmp_path / "jtb", True), _events(tmp_path / "ttb", False)
    assert sorted(ours) == sorted(ref) == ["clips_per_sec", "d_prime", "loss", "mAP", "mAUC"]
    for tag in ref:
        assert ours[tag] == ref[tag], tag
    want = {}
    for step, scalars in WRITES:
        for k, v in scalars.items():
            want.setdefault(k, []).append((step, np.float32(v)))
    assert ours == want
    csv_bytes = (tmp_path / "t.csv").read_bytes()
    assert csv_bytes == (tmp_path / "j.csv").read_bytes()
    assert csv_bytes == (tmp_path / "plain.csv").read_bytes()


def test_sink_that_does_not_import_degrades_to_csv_with_a_warning(tmp_path, monkeypatch,
                                                                   caplog):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import fails
    with caplog.at_level(logging.WARNING, logger="mla_tpu_torch"):
        _write(tlogging, tmp_path / "t.csv", tmp_path / "ttb")
    assert any("tensorboard sink unavailable" in r.getMessage() for r in caplog.records)
    assert not (tmp_path / "ttb").exists()
    _write(jlogging, tmp_path / "j.csv", None)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("filemode", ["w", "a"])
def test_create_logging_numbers_runs_and_takes_filemode(tmp_path, filemode):
    for i in range(2):
        logger = tlogging.create_logging(str(tmp_path), "run", filemode=filemode)
        fh = next(h for h in logger.handlers if isinstance(h, logging.FileHandler))
        assert fh.mode == filemode
        assert fh.baseFilename.endswith(f"{i:04d}.log")
        logger.info("hello")
        fh.close()


def test_fit_with_tensorboard_writes_what_the_csv_holds(tmp_path):
    """fit() with train.tensorboard on the CPU: the event file's tags,
    steps and values (as f32) equal scalars.csv's rows."""
    from mla_tpu_torch.config import get_config
    from mla_tpu_torch.train.loop import fit

    cfg = get_config("us8k_fused_frontend", {
        "model.conv_channels": "8,16", "model.convs_per_stage": 1, "model.embed_dim": 16,
        "model.hidden_units": 32, "model.n_classes": 5, "data.clip_seconds": 2.0,
        "data.n_train_clips": 8, "data.n_eval_clips": 4, "train.batch_size": 4,
        "train.num_steps": 4, "train.log_every": 2, "train.eval_every": 2,
        "train.checkpoint_every": 0, "train.tensorboard": True})
    fit(cfg, workspace=str(tmp_path), log=False, device="cpu")
    with open(tmp_path / "scalars.csv", newline="") as fh:
        rows = list(csv.DictReader(fh))
    want = {}
    for r in rows:
        want.setdefault(r["key"], []).append((int(r["step"]), np.float32(float(r["value"]))))
    (tb_dir,) = glob.glob(str(tmp_path / "tensorboard" / cfg.name))
    ours = _events(tb_dir, False)
    assert ours == want
    assert {"loss", "clips_per_sec", "mAP"} <= set(ours)
