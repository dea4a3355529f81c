"""Data and metrics modules of the PyTorch port against the JAX package's:
synthetic datasets bit-identical, the balanced and sequential samplers'
index streams and state, batch gather, calculate_stats and the CSV scalar
writer."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import dataclasses  # noqa: E402
import json  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mla_tpu.config import get_config as jax_get_config  # noqa: E402
from mla_tpu.data import ooc as jooc  # noqa: E402
from mla_tpu.data import sampler as jsampler  # noqa: E402
from mla_tpu.data import synthetic as jsyn  # noqa: E402
from mla_tpu.utils import logging as jlog  # noqa: E402
from mla_tpu.utils import metrics as jmetrics  # noqa: E402
from mla_tpu_torch.config import get_config  # noqa: E402
from mla_tpu_torch.data import ooc, sampler, synthetic  # noqa: E402
from mla_tpu_torch.utils import logging as tlog  # noqa: E402
from mla_tpu_torch.utils import metrics  # noqa: E402
from tests.torch_port_common import fake_summary_writer  # noqa: E402

SMALL_DATA = {"data.n_train_clips": 24, "data.n_eval_clips": 10, "data.clip_seconds": 1.0}


@pytest.mark.parametrize("preset", ["us8k_fused_frontend", "esc50_single_attention",
                                    "audioset_multi_level"])
@pytest.mark.parametrize("split", ["train", "eval"])
@pytest.mark.parametrize("kind", ["waveform", "features"])
def test_make_dataset_bit_identical(preset, split, kind):
    jcfg, tcfg = jax_get_config(preset, SMALL_DATA), get_config(preset, SMALL_DATA)
    n_classes = tcfg.model.n_classes
    ref = jsyn.make_dataset(jcfg.data, n_classes, split, jcfg.frontend, kind)
    ours = synthetic.make_dataset(tcfg.data, n_classes, split, kind)
    assert ours.kind == ref.kind == kind
    for a, b in ((ours.x, ref.x), (ours.y, ref.y), (ours.ids, ref.ids)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_class_frequency_and_unported_datasets():
    for k in range(10):
        assert synthetic.class_frequency(k, 10) == jsyn.class_frequency(k, 10)
    cfg = get_config("us8k_fused_frontend")
    jcfg = jax_get_config("us8k_fused_frontend")
    # hdf5 and out_of_core are ported (tests/test_torch_hdf5.py): without a
    # pack both packages refuse alike; out_of_core leaves a synthetic set in RAM
    for mod, c in ((synthetic, cfg), (jsyn, jcfg)):
        with pytest.raises(ValueError, match="data.hdf5_path unset"):
            mod.make_dataset(dataclasses.replace(c.data, dataset="hdf5"), 10)
    small = dataclasses.replace(cfg.data, out_of_core=True, n_train_clips=3)
    ram = synthetic.make_dataset(small, 10)
    np.testing.assert_array_equal(ram.x, jsyn.make_dataset(
        dataclasses.replace(jcfg.data, out_of_core=True, n_train_clips=3), 10).x)
    # synthetic_events is ported (tests/test_torch_sed.py holds it bit-identical)
    events = synthetic.make_dataset(dataclasses.replace(cfg.data, dataset="synthetic_events",
                                                        n_train_clips=2), 10)
    assert events.x.shape == (2, 64000) and events.kind == "waveform"
    with pytest.raises(ValueError, match="unknown dataset"):
        synthetic.make_dataset(dataclasses.replace(cfg.data, dataset="nope"), 10)


def _labels(multi):
    cfg = get_config("audioset_multi_level" if multi else "us8k_fused_frontend", SMALL_DATA)
    return synthetic.make_dataset(cfg.data, 12, "train", "features").y


@pytest.mark.parametrize("multi", [False, True])
def test_balanced_sampler_stream_and_state_equal_reference(multi):
    y = _labels(multi)
    ours, ref = sampler.BalancedSampler(y, 7, seed=3), jsampler.BalancedSampler(y, 7, seed=3)
    for _ in range(50):
        np.testing.assert_array_equal(ours.next_batch(), ref.next_batch())
    state = ours.state_dict()
    assert state == ref.state_dict()
    state = json.loads(json.dumps(state))  # the checkpoint stores it as JSON
    again, ref_again = sampler.BalancedSampler(y, 7, seed=0), jsampler.BalancedSampler(y, 7)
    again.load_state_dict(state)
    ref_again.load_state_dict(state)
    for _ in range(20):
        b = again.next_batch()
        np.testing.assert_array_equal(b, ref_again.next_batch())
        np.testing.assert_array_equal(b, ours.next_batch())
    assert again.state_dict() == ref_again.state_dict()
    with pytest.raises(ValueError, match="version"):
        again.load_state_dict({**state, "version": 2})


def test_sequential_sampler_and_take_rows():
    for n, bs in [(10, 4), (8, 4), (3, 5)]:
        ours = list(sampler.SequentialSampler(n, bs))
        ref = list(jsampler.SequentialSampler(n, bs))
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    cfg = get_config("us8k_fused_frontend", SMALL_DATA)
    ds = synthetic.make_dataset(cfg.data, 10)
    idx = np.array([5, 0, 5, 23])
    np.testing.assert_array_equal(ooc.take_rows(ds, idx), jooc.take_rows(ds, idx))


@pytest.mark.parametrize("seed", [0, 1])
def test_calculate_stats_equal_reference(seed):
    rng = np.random.default_rng(seed)
    scores = rng.random((40, 9))
    scores[:10, 0] = 0.5  # ties
    targets = (rng.random((40, 9)) < 0.3).astype(np.float32)
    targets[:, 3] = 0  # a class with no positives
    targets[:, 4] = 1  # and one with no negatives
    ours, ref = metrics.calculate_stats(scores, targets), jmetrics.calculate_stats(scores, targets)
    assert ours.keys() == ref.keys()
    for k in ours:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-12)
    for f in ("average_precision", "roc_auc"):
        np.testing.assert_allclose(getattr(metrics, f)(scores, targets),
                                   getattr(jmetrics, f)(scores, targets), rtol=0, atol=1e-12)


def test_scalar_writer_matches_reference(tmp_path, monkeypatch):
    for mod, name in ((tlog, "ours"), (jlog, "ref")):
        w = mod.ScalarWriter(str(tmp_path / name / "scalars.csv"))
        w.write(1, {"loss": 0.5, "clips_per_sec": 10})
        w.close()
        w = mod.ScalarWriter(str(tmp_path / name / "scalars.csv"))  # appends, one header
        w.write(2, {"mAP": 0.25})
        w.close()
    assert (tmp_path / "ours" / "scalars.csv").read_text() == \
        (tmp_path / "ref" / "scalars.csv").read_text()
    # the TensorBoard sink is ported (tests/test_torch_logging.py holds its
    # event files against the reference's): with it on, the CSV is the same
    # and each scalar goes to SummaryWriter.add_scalar, flushed per write
    # (a recording stand-in here, so this module does not load tensorflow)
    calls = fake_summary_writer(monkeypatch)
    w = tlog.ScalarWriter(str(tmp_path / "x.csv"), tensorboard_dir=str(tmp_path / "tb"))
    w.write(1, {"loss": 0.5, "clips_per_sec": 10})
    w.write(2, {"mAP": 0.25})
    w.close()
    assert (tmp_path / "x.csv").read_text() == (tmp_path / "ours" / "scalars.csv").read_text()
    assert calls == [("init", str(tmp_path / "tb")), ("loss", 0.5, 1), ("clips_per_sec", 10.0, 1),
                     "flush", ("mAP", 0.25, 2), "flush", "close"]
    logger = tlog.create_logging(str(tmp_path / "logs"), "run")
    logger.info("hello")
    assert (tmp_path / "logs" / "0000.log").read_text().strip().endswith("hello")
    tlog.create_logging(str(tmp_path / "logs"), "run")
    assert (tmp_path / "logs" / "0001.log").exists()
