"""The SED harness of the PyTorch port (train/sed_eval.py, the
synthetic_events corpus, the segment metrics) against the JAX package's:
the corpus bit-identical, the DCASE segment metrics equal on the same
events, and evaluate_sed / sweep_sed_threshold equal on bridged weights."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mla_tpu.data import synthetic as jsyn  # noqa: E402
from mla_tpu.train import sed_eval as jsed  # noqa: E402
from mla_tpu.utils import metrics as jmetrics  # noqa: E402
from mla_tpu_torch.data import synthetic  # noqa: E402
from mla_tpu_torch.train import sed_eval  # noqa: E402
from mla_tpu_torch.utils import metrics  # noqa: E402
from tests.torch_port_common import configs, jax_weights, torch_state_dict  # noqa: E402


@pytest.mark.parametrize("kw", [{}, {"max_events": 1, "min_event_s": 0.5},
                                {"sample_rate": 22050, "max_event_s": 2.0, "noise": 0.1}])
def test_event_corpus_is_bit_identical(kw):
    ours = synthetic.synth_event_waveforms(5, 7, 4.0, seed=3, **kw)
    ref = jsyn.synth_event_waveforms(5, 7, 4.0, seed=3, **kw)
    for a, b in zip(ours[:2], ref[:2]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours[2] == ref[2]
    with pytest.raises(ValueError, match="exceeds clip length"):
        synthetic.synth_event_waveforms(1, 3, 1.0, min_event_s=1.5)


@pytest.mark.parametrize("split", ["train", "eval"])
def test_synthetic_events_dataset_is_bit_identical(split):
    jcfg, tcfg = configs({"data.dataset": "synthetic_events", "data.n_train_clips": 4,
                          "data.n_eval_clips": 3, "data.clip_seconds": 3.0})
    ours = synthetic.make_dataset(tcfg.data, 5, split, "waveform", tcfg.frontend)
    ref = jsyn.make_dataset(jcfg.data, 5, split, jcfg.frontend, "waveform")
    for a, b in ((ours.x, ref.x), (ours.y, ref.y), (ours.ids, ref.ids)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="waveform corpus"):
        synthetic.make_dataset(tcfg.data, 5, split, "features")


def _random_events(rng, n, c, dur):
    out = []
    for _ in range(n):
        t0 = rng.uniform(-0.5, dur)
        out.append((int(rng.integers(0, c)), t0, t0 + rng.uniform(0.0, 2.5)))
    out.append({"class_idx": 1, "t_start": 1.0, "t_end": 1.0})  # zero length
    return out


def test_segment_metrics_equal_jax_on_the_same_events():
    rng = np.random.default_rng(0)
    refs, ests = [], []
    for clip in range(6):
        dur = 4.0 + clip
        for seg in (0.96, 1.0):
            r, e = _random_events(rng, 5, 4, dur), _random_events(rng, 4, 4, dur)
            g = metrics.events_to_segment_grid(r, 4, dur, seg)
            np.testing.assert_array_equal(g, jmetrics.events_to_segment_grid(r, 4, dur, seg))
            refs.append(g)
            ests.append(metrics.events_to_segment_grid(e, 4, dur, seg))
    ours, ref = metrics.segment_event_metrics(refs, ests), jmetrics.segment_event_metrics(refs,
                                                                                            ests)
    assert ours == ref
    assert metrics.segment_event_metrics(refs[0], refs[0])["error_rate"] == 0.0
    with pytest.raises(ValueError, match="out of range"):
        metrics.events_to_segment_grid([(9, 0.0, 1.0)], 4, 2.0)


@pytest.fixture(scope="module")
def bridged():
    jcfg, tcfg = configs({"data.clip_seconds": 4.0, "data.n_eval_clips": 6,
                          "train.batch_size": 4})
    variables, flat = jax_weights(jcfg.model, seed=2)
    return jcfg, tcfg, variables, torch_state_dict(tcfg.model, flat)


def test_batched_timeline_matches_jax(bridged):
    jcfg, tcfg, variables, sd = bridged
    x, _, _ = synthetic.synth_event_waveforms(6, 5, 4.0, seed=1)
    w, f = sed_eval.batched_timeline(tcfg, sd, x, batch_size=4, device="cpu")
    jw, jf = jsed.batched_timeline(jcfg, variables, x, batch_size=4)
    assert w.shape == f.shape == (6, 4, 5) and w.dtype == np.float32
    np.testing.assert_allclose(w, jw, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(f, jf, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"threshold": 0.45, "merge_gap_s": 1.0, "segment_s": 1.0},
                                {"threshold": "per-class", "min_dur_s": 0.9}])
def test_evaluate_sed_equals_jax(bridged, kw):
    jcfg, tcfg, variables, sd = bridged
    if kw.get("threshold") == "per-class":
        kw = {**kw, "threshold": np.linspace(0.3, 0.7, tcfg.model.n_classes)}
    ours = sed_eval.evaluate_sed(tcfg, sd, device="cpu", **kw)
    ref = jsed.evaluate_sed(jcfg, variables, **kw)
    assert ours.keys() == ref.keys()
    for k in ours:
        if isinstance(ref[k], float) and np.isnan(ref[k]):
            assert np.isnan(ours[k]), k
        else:
            assert ours[k] == ref[k], (k, ours[k], ref[k])
    assert ours["n_clips"] == 6 and 0.0 <= ours["f1"] <= 1.0


def test_sweep_sed_threshold_equals_jax(bridged):
    jcfg, tcfg, variables, sd = bridged
    ours = sed_eval.sweep_sed_threshold(tcfg, sd, n_clips=5, device="cpu")
    ref = jsed.sweep_sed_threshold(jcfg, variables, n_clips=5)
    assert ours == ref
    assert len(ours["sweep"]) == 19
    with pytest.raises(ValueError, match="at least one clip"):
        sed_eval.evaluate_sed(dataclasses.replace(
            tcfg, data=dataclasses.replace(tcfg.data, n_eval_clips=0)), sd, device="cpu")
