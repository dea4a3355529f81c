"""Wav-folder ingest and k-fold cross-validation of the PyTorch port
(mla_tpu_torch/data/folder.py, train/cv.py, the cv verb) against the JAX
package's, on a tiny wav corpus written with scipy: the scans, fold lists
and packs equal the reference's; cross_validate on 2 folds matches JAX's
per-fold final stats and cv_results.csv rows at rtol 1e-4; the n_classes
check raises the reference's message; and the cv verb runs as a subprocess
with --device cpu."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import csv  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from scipy.io import wavfile  # noqa: E402

from mla_tpu.config import get_config as jax_get_config  # noqa: E402
from mla_tpu.data import folder as jfolder  # noqa: E402
from mla_tpu.data import hdf5 as jh5  # noqa: E402
from mla_tpu.models.zoo import build_model as jax_build_model  # noqa: E402
from mla_tpu.train import cv as jcv  # noqa: E402
from mla_tpu.train import state as jstate  # noqa: E402
from mla_tpu_torch.config import get_config  # noqa: E402
from mla_tpu_torch.data import folder  # noqa: E402
from mla_tpu_torch.data import hdf5 as h5  # noqa: E402
from mla_tpu_torch.models.convert import flat_to_state_dict  # noqa: E402
from mla_tpu_torch.models.zoo import build_model  # noqa: E402
from mla_tpu_torch.train import cv  # noqa: E402
from mla_tpu_torch.train import loop  # noqa: E402
from tests.test_torch_train import _flat_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("dog", "rain", "siren")
# (file, class, fold, sample rate, seconds, channels): fold 2 has no siren;
# one clip at 22.05 kHz, one stereo, one shorter and one longer than the
# 1 s clips packed
FILES = [("a1.wav", "dog", 1, 16000, 1.0, 1), ("a2.wav", "rain", 1, 22050, 1.3, 1),
         ("a3.wav", "siren", 1, 16000, 0.7, 2), ("a4.wav", "dog", 1, 16000, 1.2, 1),
         ("b1.wav", "rain", 2, 16000, 1.0, 1), ("b2.wav", "dog", 2, 16000, 1.5, 1),
         ("b3.wav", "rain", 2, 16000, 1.1, 1), ("b4.wav", "dog", 2, 16000, 0.9, 1)]
# the reference may decode through its native C++ decoder and resampler when
# built; the port decodes with scipy: the waveforms agree within this
WAV_ATOL = 1e-5
CV_CUT = {"model.conv_channels": "8,16", "model.convs_per_stage": 1, "model.embed_dim": 32,
          "model.hidden_units": 64, "model.n_classes": 3, "model.compute_dtype": "float32",
          "model.dropout_rate": 0.0, "frontend.impl": "xla", "data.clip_seconds": 1.0,
          "train.batch_size": 4, "train.num_steps": 4, "train.log_every": 1,
          "train.eval_every": 4, "train.checkpoint_every": 0, "train.data_parallel": 1}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(csv root, metadata CSV, class-subdirectory root)."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(5)
    os.makedirs(d / "audio")
    with open(d / "meta.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["filename", "fold", "target", "category", "esc10"])
        for fn, cls, fold, sr, secs, ch in FILES:
            n = int(sr * secs)
            t = np.arange(n) / sr
            wav = 0.3 * np.sin(2 * np.pi * (300 + 400 * CLASSES.index(cls)) * t)
            wav = (wav + 0.05 * rng.standard_normal(n)) * 32767
            pcm = np.clip(wav, -32768, 32767).astype(np.int16)
            if ch == 2:
                pcm = np.stack([pcm, pcm[::-1]], axis=1)
            wavfile.write(d / "audio" / fn, sr, pcm)
            os.makedirs(d / "by_class" / cls, exist_ok=True)
            wavfile.write(d / "by_class" / cls / fn, sr, pcm)
            w.writerow([fn, fold, CLASSES.index(cls), cls, "True"])
    return str(d / "audio"), str(d / "meta.csv"), str(d / "by_class")


def _rel(paths, root):
    return [os.path.relpath(p, root) for p in paths]


@pytest.mark.parametrize("folds", [None, [1], [2]])
def test_scans_and_folds_equal_the_references(corpus, folds):
    root, meta, by_class = corpus
    p, y, c = folder.scan_folder(root, meta, folds)
    jp, jy, jc = jfolder.scan_folder(root, meta, folds)
    assert (p, c) == (jp, jc) and c == list(CLASSES)  # fold 2 keeps siren's index
    np.testing.assert_array_equal(y, jy)
    assert folder.csv_folds(meta) == jfolder.csv_folds(meta) == [1, 2]
    p, y, c = folder.scan_folder(by_class)
    jp, jy, jc = jfolder.scan_folder(by_class)
    assert (_rel(p, by_class), c) == (_rel(jp, by_class), jc)
    np.testing.assert_array_equal(y, jy)
    for mod in (folder, jfolder):
        with pytest.raises(ValueError, match="fold filtering needs"):
            mod.scan_folder(by_class, None, [1])


def _assert_packs_equal(path, ref_path):
    x, y, ids = h5.load_data(path)
    jx, jy, jids = jh5.load_data(ref_path)
    np.testing.assert_allclose(x, jx, rtol=0, atol=WAV_ATOL)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(ids, jids)


def test_pack_folder_and_cv_folds_equal_the_references(corpus, tmp_path):
    root, meta, by_class = corpus
    for args in ((by_class, None, None, None), (root, meta, 3, [2])):
        src, labels, n_classes, folds = args
        got = folder.pack_folder(src, str(tmp_path / "t.h5"), 1.0, labels_csv=labels,
                                 n_classes=n_classes, folds=folds)
        want = jfolder.pack_folder(src, str(tmp_path / "j.h5"), 1.0, labels_csv=labels,
                                   n_classes=n_classes, folds=folds)
        assert got == want
        _assert_packs_equal(str(tmp_path / "t.h5"), str(tmp_path / "j.h5"))
    packs, classes = folder.pack_cv_folds(root, str(tmp_path / "t"), 1.0, labels_csv=meta)
    jpacks, jclasses = jfolder.pack_cv_folds(root, str(tmp_path / "j"), 1.0, labels_csv=meta)
    assert classes == jclasses and sorted(packs) == sorted(jpacks) == [1, 2]
    for f in packs:
        for ours, ref in zip(packs[f], jpacks[f]):
            assert os.path.basename(ours) == os.path.basename(ref)
            _assert_packs_equal(ours, ref)
    with pytest.raises(ValueError, match=r"folds \[7\] not in CSV"):
        folder.pack_cv_folds(root, str(tmp_path / "t"), 1.0, labels_csv=meta, folds=[7])


def _read_csv(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def test_cross_validate_on_two_folds_matches_jax(corpus, tmp_path, monkeypatch):
    """Both packages from JAX's initial weights per fold: per-fold final
    stats and the mean / std rows of cv_results.csv within rtol 1e-4."""
    root, meta, _ = corpus
    jcfg = jax_get_config("us8k_fused_frontend", CV_CUT)
    tcfg = get_config("us8k_fused_frontend", CV_CUT)
    jmodel = jax_build_model(jcfg.model)
    jst = jstate.create_train_state(jcfg, jmodel, jnp.zeros((4, 1, 96, 64), jnp.float32))
    flat = _flat_jax(jst.params, jst.batch_stats)

    def bridged(cfg, device=None, seed=None):
        model = build_model(cfg, device=device)
        model.load_state_dict(flat_to_state_dict(flat, model))
        return model

    monkeypatch.setattr(loop, "build_model", bridged)
    ours = cv.cross_validate(tcfg, root, meta, str(tmp_path / "t"), log=False, device="cpu")
    ref = jcv.cross_validate(jcfg, root, meta, str(tmp_path / "j"), log=False)
    assert ours["classes"] == ref["classes"] == list(CLASSES)
    assert sorted(ours["folds"]) == sorted(ref["folds"]) == [1, 2]
    for f in ref["folds"]:
        assert sorted(ours["folds"][f]) == sorted(ref["folds"][f])
        for k, v in ref["folds"][f].items():
            np.testing.assert_allclose(ours["folds"][f][k], v, rtol=1e-4, err_msg=f"{f} {k}")
    rows, jrows = _read_csv(ours["csv"]), _read_csv(ref["csv"])
    assert [r[0] for r in rows] == [r[0] for r in jrows] == ["fold", "1", "2", "mean", "std"]
    assert rows[0] == jrows[0]
    for r, jr in zip(rows[1:], jrows[1:]):
        # std over two folds of nearly equal values: absolute 1e-6 on top
        np.testing.assert_allclose([float(v) for v in r[1:]], [float(v) for v in jr[1:]],
                                   rtol=1e-4, atol=1e-6)


def test_n_classes_mismatch_raises_the_references_message(corpus, tmp_path):
    root, meta, _ = corpus
    over = {**CV_CUT, "model.n_classes": 5}
    msgs = []
    for mod, cfg, kw in ((cv, get_config("us8k_fused_frontend", over), {"device": "cpu"}),
                         (jcv, jax_get_config("us8k_fused_frontend", over), {})):
        with pytest.raises(ValueError) as e:
            mod.cross_validate(cfg, root, meta, str(tmp_path / mod.__name__), log=False, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "model.n_classes=3" in msgs[0]


def test_cross_validate_needs_a_card_unless_given_the_cpu(corpus, tmp_path):
    root, meta, _ = corpus
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cv.cross_validate(get_config("us8k_fused_frontend", CV_CUT), root, meta,
                          str(tmp_path / "ws"), folds=[1], log=False)
    # it refused before any host work: nothing decoded, nothing packed
    assert not (tmp_path / "ws").exists()


def test_cv_verb_runs_as_a_subprocess_on_the_cpu(corpus, tmp_path):
    root, meta, _ = corpus
    env = {**os.environ, "PYTHONPATH": ROOT}
    cmd = [sys.executable, "-m", "mla_tpu_torch", "cv", "--config", "us8k_fused_frontend",
           "--wav_dir", root, "--labels_csv", meta, "--workspace", str(tmp_path),
           "--folds", "2", "--quiet", "--device", "cpu",
           "--set", *(f"{k}={v}" for k, v in CV_CUT.items())]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(summary["folds"]) == ["2"] and summary["classes"] == list(CLASSES)
    assert np.isfinite(summary["folds"]["2"]["final_loss"])
    assert summary["std"]["final_loss"] == 0.0  # one fold
    assert _read_csv(summary["csv"])[0][0] == "fold"
