"""The eval metrics the port's ``eval --per_class`` / ``--calibrate`` use
(mla_tpu_torch/utils/metrics.py: ``calculate_stats(class_mask)``,
``per_class_stats``, ``calibrate_thresholds``, ``write_per_class_csv``)
against ``mla_tpu.utils.metrics`` on numpy-seeded scores, with tied scores,
all-negative and all-positive classes, and adjacent float32 scores where
the threshold's midpoint collapses onto a boundary: thresholds bit-equal,
the per-class arrays equal (NaN where undefined), the CSV text equal."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mla_tpu.utils import metrics as jm  # noqa: E402
from mla_tpu_torch.utils import metrics as tm  # noqa: E402


def _case(seed, n=40, c=7, levels=None):
    """scores [n, c] (rounded to ``levels`` steps for ties when given) and
    targets with class 0 all negative and class 1 all positive."""
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0, 1, (n, c)).astype(np.float32)
    if levels:
        scores = np.round(scores * levels) / levels
    targets = (rng.uniform(0, 1, (n, c)) < 0.35).astype(np.float32)
    targets[:, 0] = 0
    targets[:, 1] = 1
    # a class whose positives score high: a precision target is reachable
    targets[:, 2] = (scores[:, 2] > 0.6).astype(np.float32)
    return scores, targets


CASES = [(0, None), (1, 4), (2, 10), (3, 2)]


@pytest.mark.parametrize("seed,levels", CASES)
def test_calculate_stats_with_class_mask(seed, levels):
    scores, targets = _case(seed, levels=levels)
    mask = np.arange(scores.shape[1]) % 2 == 1
    for m in (None, mask):
        assert tm.calculate_stats(scores, targets, class_mask=m) == \
            jm.calculate_stats(scores, targets, class_mask=m)
    masked = tm.calculate_stats(scores, targets, class_mask=mask)
    assert masked != tm.calculate_stats(scores, targets)


@pytest.mark.parametrize("seed,levels", CASES)
def test_per_class_stats(seed, levels):
    scores, targets = _case(seed, levels=levels)
    got, want = tm.per_class_stats(scores, targets), jm.per_class_stats(scores, targets)
    assert set(got) == set(want) == {"AP", "AUC", "d_prime"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)  # NaN == NaN here
    assert np.isnan(got["AP"][0]) and np.isnan(got["AUC"][1])


@pytest.mark.parametrize("seed,levels", CASES)
@pytest.mark.parametrize("target", [0.5, 0.8, 1.0])
def test_calibrate_thresholds_bit_equal(seed, levels, target):
    scores, targets = _case(seed, levels=levels)
    got = tm.calibrate_thresholds(scores, targets, target)
    want = jm.calibrate_thresholds(scores, targets, target)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.5  # no positives: the default


def test_calibrate_thresholds_midpoint_collapse():
    """Adjacent float32 scores: the f32 midpoint rounds onto a boundary, so
    the threshold is the passing score itself in both packages."""
    lo = np.float32(0.7)
    below = np.nextafter(lo, np.float32(0))
    scores = np.array([[0.9], [lo], [below], [0.1]], np.float32)
    targets = np.array([[1], [1], [0], [0]], np.float32)
    got = tm.calibrate_thresholds(scores, targets, 1.0)
    np.testing.assert_array_equal(got, jm.calibrate_thresholds(scores, targets, 1.0))
    assert got[0] == lo


@pytest.mark.parametrize("names", [None, ["dog", "rain", "siren", "a", "b", "c", "d"]])
def test_write_per_class_csv_text_equal(tmp_path, names):
    scores, targets = _case(5, levels=8)
    tm.write_per_class_csv(str(tmp_path / "t.csv"), scores, targets, names)
    jm.write_per_class_csv(str(tmp_path / "j.csv"), scores, targets, names)
    text = (tmp_path / "t.csv").read_text()
    assert text == (tmp_path / "j.csv").read_text()
    assert len(text.strip().splitlines()) == 1 + scores.shape[1]
