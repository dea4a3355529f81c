"""The port's ``prep`` verb and AudioSet packer (mla_tpu_torch/data/
audioset.py) against the reference's (both CLIs in process): the synthetic
pack of features and of waveforms, with ``--quantize``, a wav corpus with
``--wav_dir`` (class folders; a metadata CSV with ``--folds``), and
``--tfrecords`` over SequenceExamples this test writes with tensorflow
(short and long clips, out-of-range labels). Every HDF5 array equals the
reference's. The reference reads wavs through its native library
(``mla_tpu.data.native``), pinned for the whole module by
``reference_native_libraries``, never through its numpy / scipy fallback."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import contextlib  # noqa: E402
import io  # noqa: E402
import os  # noqa: E402

import h5py  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mla_tpu.__main__ import main as jmain  # noqa: E402
from mla_tpu.data import audioset as jaudioset  # noqa: E402
from mla_tpu_torch.__main__ import main as tmain  # noqa: E402
from mla_tpu_torch.data import audioset  # noqa: E402
from mla_tpu_torch.data.audio_io import write_wav  # noqa: E402
from tests.torch_port_common import reference_native_libraries  # noqa: E402

pytestmark = pytest.mark.usefixtures("reference_native_libraries")


def _prep_both(tmp_path, argv):
    """Run prep in both packages; returns (port's line, JAX's line, the two
    packs' arrays)."""
    lines, packs = [], []
    for tag, main in (("t", tmain), ("j", jmain)):
        out = str(tmp_path / f"{tag}.h5")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["prep", "--out", out, *argv])
        lines.append(buf.getvalue().strip().replace(out, "OUT"))
        with h5py.File(out, "r") as f:
            packs.append({k: f[k][...] for k in f})
    return lines[0], lines[1], packs


def _assert_packs_equal(packs):
    t, j = packs
    assert t.keys() == j.keys() == {"x", "y", "video_id_list"}
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("argv", [
    ["--config", "audioset_multi_level", "--set", "data.n_train_clips=6"],
    ["--config", "audioset_multi_level", "--quantize", "--split", "eval",
     "--set", "data.n_eval_clips=5"],
    ["--config", "esc50_single_attention", "--set", "data.n_train_clips=4",
     "data.clip_seconds=1.0"],
    ["--config", "esc50_single_attention", "--quantize", "--set", "data.n_train_clips=3",
     "data.clip_seconds=0.5"],
], ids=["features", "features_quantized_eval", "waveform", "waveform_quantized"])
def test_prep_synthetic(tmp_path, argv):
    line_t, line_j, packs = _prep_both(tmp_path, argv)
    assert line_t == line_j and line_t.startswith("packed ")
    _assert_packs_equal(packs)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(8)
    rows = []
    for i, (cls, secs, sr) in enumerate([("dog", 1.0, 16000), ("rain", 1.4, 22050),
                                         ("dog", 0.6, 16000), ("siren", 1.0, 16000)]):
        os.makedirs(d / "dirs" / cls, exist_ok=True)
        x = (0.3 * rng.standard_normal(int(sr * secs))).astype(np.float32)
        write_wav(str(d / "dirs" / cls / f"{i}.wav"), x, sr=sr)
        rows.append(f"{cls}/{i}.wav,{cls},{1 + i % 2}")
    (d / "meta.csv").write_text("filename,category,fold\n" + "\n".join(rows) + "\n")
    return d


@pytest.mark.parametrize("with_csv", [False, True], ids=["subdirs", "csv_folds"])
def test_prep_wav_dir(tmp_path, corpus, with_csv):
    argv = ["--config", "esc50_single_attention", "--wav_dir", str(corpus / "dirs"),
            "--set", "data.clip_seconds=1.0"]
    if with_csv:
        argv[4:4] = ["--labels_csv", str(corpus / "meta.csv"), "--folds", "1"]
    line_t, line_j, packs = _prep_both(tmp_path, argv)
    assert line_t == line_j
    _assert_packs_equal(packs)
    assert len(packs[0]["x"]) == (2 if with_csv else 4)


def test_prep_tfrecords(tmp_path):
    rng = np.random.default_rng(9)
    clips = [rng.integers(0, 256, (n, 128), dtype=np.uint8) for n in (10, 7, 12, 10)]
    labels = [[0, 3], [5], [2, 600], []]  # 600 is beyond the packed class count
    for shard in range(2):
        audioset.write_sequence_examples(
            str(tmp_path / f"s{shard}.tfrecord"), clips[2 * shard: 2 * shard + 2],
            labels[2 * shard: 2 * shard + 2],
            video_ids=[f"v{2 * shard + i}".encode() for i in range(2)])
    # the port's reader equals the reference's on the same shards
    paths = sorted(str(p) for p in tmp_path.glob("*.tfrecord"))
    for a, b in zip(audioset.read_sequence_examples(paths, 10),
                    jaudioset.read_sequence_examples(paths, 10)):
        np.testing.assert_array_equal(a, b)
    line_t, line_j, packs = _prep_both(
        tmp_path, ["--config", "audioset_multi_level", "--tfrecords",
                   str(tmp_path / "*.tfrecord"), "--set", "model.n_classes=10"])
    assert line_t == line_j == "packed 4 AudioSet clips -> OUT"
    _assert_packs_equal(packs)
    x = packs[0]["x"]
    assert x.dtype == np.uint8 and x.shape == (4, 10, 128)
    np.testing.assert_array_equal(x[1, 7:], np.repeat(clips[1][-1:], 3, 0))  # edge-padded
    with pytest.raises(FileNotFoundError, match="no tfrecords match"):
        audioset.pack_audioset(str(tmp_path / "none*.tfrecord"), str(tmp_path / "n.h5"))
