"""The hdf5 / out-of-core data path of the PyTorch port
(mla_tpu_torch/data/{hdf5,ooc}.py, the hdf5 branch of make_dataset and the
out-of-core guards of fit()) against the JAX package's: each reads the
other's packs to equal arrays, plain and quantized; the readers pickle and a
forked or spawned worker opens its own handle; take() on unsorted
duplicates, the multi-pack split, the path globs and the synthetic pack
equal the reference's; an out-of-core set is never staged or read whole;
and ten fit() steps on a pack match JAX's losses at rtol 1e-4, in RAM and
out of core. The reference reads wavs through its native library
(``mla_tpu.data.native``), pinned for the whole module by
``reference_native_libraries``, never through its numpy / scipy fallback."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import dataclasses  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mla_tpu.config import get_config as jax_get_config  # noqa: E402
from mla_tpu.data import hdf5 as jh5  # noqa: E402
from mla_tpu.data import ooc as jooc  # noqa: E402
from mla_tpu.data import synthetic as jsyn  # noqa: E402
from mla_tpu.models.zoo import build_model as jax_build_model  # noqa: E402
from mla_tpu.train import loop as jloop  # noqa: E402
from mla_tpu.train import state as jstate  # noqa: E402
from mla_tpu_torch.config import get_config  # noqa: E402
from mla_tpu_torch.data import hdf5 as h5  # noqa: E402
from mla_tpu_torch.data import ooc  # noqa: E402
from mla_tpu_torch.data import pipeline as pipe  # noqa: E402
from mla_tpu_torch.data import synthetic as syn  # noqa: E402
from mla_tpu_torch.models.convert import flat_to_state_dict  # noqa: E402
from mla_tpu_torch.models.zoo import build_model  # noqa: E402
from mla_tpu_torch.train import loop  # noqa: E402
from tests.test_torch_train import _flat_jax  # noqa: E402
from tests.torch_port_common import reference_native_libraries  # noqa: E402

pytestmark = pytest.mark.usefixtures("reference_native_libraries")

N_CLASSES = 6


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """(dir, {name: path}, x, y): waveform packs written by each package,
    two shards of one set, and quantized feature packs."""
    d = tmp_path_factory.mktemp("packs")
    x, y = syn.synth_waveforms(24, N_CLASSES, clip_seconds=0.5, multi_label=True, seed=3)
    feats = np.random.default_rng(4).uniform(-0.9, 0.9, (10, 5, 128)).astype(np.float32)
    fy = y[:10]
    paths = {k: str(d / f"{k}.h5") for k in
             ("ours", "ref", "ours_q", "ref_q", "shard_a", "shard_b")}
    h5.pack_hdf5(paths["ours"], x, y)
    jh5.pack_hdf5(paths["ref"], x, y)
    h5.pack_hdf5(paths["ours_q"], feats, fy, quantize=True)
    jh5.pack_hdf5(paths["ref_q"], feats, fy, quantize=True)
    h5.pack_hdf5(paths["shard_a"], x[:10], y[:10])
    h5.pack_hdf5(paths["shard_b"], x[10:], y[10:])
    return d, paths, x, y


def _assert_triples_equal(a, b):
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
        assert u.dtype == v.dtype


@pytest.mark.parametrize("kind", ["plain", "quantized"])
def test_each_package_reads_the_others_packs(packs, kind):
    """load_data, the column reader and OutOfCoreDataset of each package on
    the other's pack: bit-equal arrays (x f32, de-quantized per read)."""
    _, paths, _, _ = packs
    ours, ref = (paths["ours"], paths["ref"]) if kind == "plain" else (paths["ours_q"],
                                                                       paths["ref_q"])
    want = jh5.load_data(ref)
    _assert_triples_equal(h5.load_data(ref), want)
    _assert_triples_equal(jh5.load_data(ours), want)
    _assert_triples_equal(h5.load_data(ours), want)
    for path in (ours, ref):
        r, jr = ooc.HDF5ColumnReader(path), jooc.HDF5ColumnReader(path)
        assert (r.shape, r.nbytes, r.ndim, len(r)) == (jr.shape, jr.nbytes, jr.ndim, len(jr))
        np.testing.assert_array_equal(r[2:7], jr[2:7])
        np.testing.assert_array_equal(r[np.array([0, 3, 4])], want[0][[0, 3, 4]])
        ds, jds = ooc.OutOfCoreDataset(path), jooc.OutOfCoreDataset(path)
        assert ds.kind == jds.kind == ("waveform" if kind == "plain" else "features")
        np.testing.assert_array_equal(ds.y, jds.y)
        np.testing.assert_array_equal(ds.ids, jds.ids)


def test_quantization_matches_and_warns_on_saturation():
    x = np.random.default_rng(0).uniform(-1.5, 1.5, (64, 8)).astype(np.float32)
    with pytest.warns(UserWarning, match="saturate"):
        q = h5.float32_to_uint8(x)
    with pytest.warns(UserWarning, match="saturate"):
        np.testing.assert_array_equal(q, jh5.float32_to_uint8(x))
    np.testing.assert_array_equal(h5.uint8_to_float32(q, 2.0), jh5.uint8_to_float32(q, 2.0))
    assert h5.DEQUANT_SCALE == jh5.DEQUANT_SCALE == 1.0


def test_readers_and_dataset_pickle(packs):
    _, paths, x, y = packs
    r = ooc.HDF5ColumnReader(paths["ours"])
    r[0]  # open the handle; the pickle must not carry it
    r2 = pickle.loads(pickle.dumps(r))
    assert r2._d is None
    np.testing.assert_array_equal(r2[7], x[7])
    m = ooc.MultiColumnReader([paths["shard_a"], paths["shard_b"]])
    np.testing.assert_array_equal(pickle.loads(pickle.dumps(m))[[3, 12, 20]], x[[3, 12, 20]])
    ds = pickle.loads(pickle.dumps(ooc.OutOfCoreDataset(paths["ours"])))
    np.testing.assert_array_equal(ds.take(np.array([9, 2, 9])), x[[9, 2, 9]])
    np.testing.assert_array_equal(ds.y, y)


def test_a_forked_worker_opens_its_own_handle(packs, monkeypatch):
    """A forked worker holds the parent's reader object, handle included,
    under a new pid: the reader must open its own there. The fork is
    simulated by a new pid (forking this multi-threaded test process is
    unsafe); the parent's handle is left as it was."""
    _, paths, x, _ = packs
    r = ooc.HDF5ColumnReader(paths["ours"])
    r[0]
    parent_handle, parent_pid = r._d, os.getpid()
    assert r._pid == parent_pid
    monkeypatch.setattr(ooc.os, "getpid", lambda: parent_pid + 1)
    np.testing.assert_array_equal(r[5], x[5])
    assert r._d is not parent_handle and r._pid == parent_pid + 1
    np.testing.assert_array_equal(parent_handle[6], x[6])  # the parent's still reads


def test_take_on_unsorted_duplicates_equals_the_references(packs):
    _, paths, x, _ = packs
    idx = np.array([5, 1, 5, 23, 0, 1, 17, 17])
    ours = ooc.OutOfCoreDataset(paths["ours"]).take(idx)
    np.testing.assert_array_equal(ours, jooc.OutOfCoreDataset(paths["ours"]).take(idx))
    np.testing.assert_array_equal(ours, x[idx])
    np.testing.assert_array_equal(ooc.take_rows(syn.ArrayDataset(x, None, None, "waveform"),
                                                idx), x[idx])


def test_multi_pack_split_equals_the_references(packs):
    _, paths, x, y = packs
    shards = [paths["shard_a"], paths["shard_b"]]
    m, jm = ooc.MultiColumnReader(shards), jooc.MultiColumnReader(shards)
    assert m.shape == jm.shape == x.shape and m.nbytes == jm.nbytes
    for idx in (3, 10, np.int64(23), slice(8, 13), np.array([0, 9, 10, 11, 23]),
                np.array([], np.int64)):
        np.testing.assert_array_equal(m[idx], jm[idx])
    ds, jds = ooc.OutOfCoreDataset(shards), jooc.OutOfCoreDataset(shards)
    idx = np.array([22, 3, 10, 3, 9])
    np.testing.assert_array_equal(ds.take(idx), jds.take(idx))
    np.testing.assert_array_equal(ds.y, jds.y)
    np.testing.assert_array_equal(ds.ids, jds.ids)
    with pytest.raises(ValueError, match="row shape"):
        ooc.MultiColumnReader([paths["shard_a"], paths["ours_q"]])


def test_path_lists_and_globs_behave_alike(packs):
    d, paths, _, _ = packs
    for spec in (paths["ours"], f"{paths['shard_a']}, {paths['shard_b']}",
                 str(d / "shard_*.h5"), str(d / "*_q.h5")):
        assert syn._hdf5_paths(spec) == jsyn._hdf5_paths(spec)
    assert syn._hdf5_paths(str(d / "shard_?.h5")) == [paths["shard_a"], paths["shard_b"]]
    for mod in (syn, jsyn):
        with pytest.raises(FileNotFoundError, match="matched nothing"):
            mod._hdf5_paths(str(d / "none_*.h5"))


@pytest.mark.parametrize("out_of_core", [False, True])
def test_make_dataset_hdf5_branch_equals_the_references(packs, out_of_core):
    d, paths, _, _ = packs
    cfg = get_config("us8k_fused_frontend", {
        "data.dataset": "hdf5", "data.hdf5_path": str(d / "shard_*.h5"),
        "data.eval_hdf5_path": paths["ref_q"], "data.out_of_core": out_of_core})
    jcfg = jax_get_config("us8k_fused_frontend", {
        "data.dataset": "hdf5", "data.hdf5_path": str(d / "shard_*.h5"),
        "data.eval_hdf5_path": paths["ref_q"], "data.out_of_core": out_of_core})
    for split in ("train", "eval"):
        ds = syn.make_dataset(cfg.data, 10, split)
        jds = jsyn.make_dataset(jcfg.data, 10, split)
        assert type(ds).__name__ == type(jds).__name__
        assert ds.kind == jds.kind
        np.testing.assert_array_equal(ooc.take_rows(ds, np.arange(len(ds.y))),
                                      jooc.take_rows(jds, np.arange(len(jds.y))))
        np.testing.assert_array_equal(ds.y, jds.y)
        np.testing.assert_array_equal(ds.ids, jds.ids)
    with pytest.raises(ValueError, match="eval_hdf5_path"):
        syn.make_dataset(dataclasses.replace(cfg.data, eval_hdf5_path=None), 10, "eval")


@pytest.mark.parametrize("out_of_core", [False, True])
def test_hdf5_without_h5py_raises_naming_it(packs, monkeypatch, out_of_core):
    _, paths, _, _ = packs
    monkeypatch.setattr(h5, "HAVE_H5PY", False)
    cfg = get_config("us8k_fused_frontend", {"data.dataset": "hdf5",
                                             "data.hdf5_path": paths["ours"],
                                             "data.out_of_core": out_of_core})
    with pytest.raises(RuntimeError, match="h5py"):
        syn.make_dataset(cfg.data, 10, "train")
    with pytest.raises(RuntimeError, match="h5py"):
        h5.pack_hdf5(paths["ours"] + ".new", np.zeros((1, 4)), np.zeros((1, 2)))


def test_generate_synthetic_pack_equals_the_references(tmp_path):
    """One seed, write blocks of 4 rows: equal x / y / ids, one-row chunks."""
    import h5py

    kw = dict(n_clips=10, n_classes=5, clip_seconds=0.25, seed=11, rows_per_write=4)
    nbytes = ooc.generate_synthetic_pack(str(tmp_path / "t.h5"), **kw)
    jnbytes = jooc.generate_synthetic_pack(str(tmp_path / "j.h5"), **kw)
    assert nbytes == jnbytes
    _assert_triples_equal(h5.load_data(str(tmp_path / "t.h5")),
                          jh5.load_data(str(tmp_path / "j.h5")))
    with h5py.File(tmp_path / "t.h5") as f:
        assert f["x"].chunks == (1, 4000)


def test_dataloader_workers_read_an_out_of_core_set(packs):
    """The stateless pipeline's DataLoader worker (spawned: the reader
    crosses as a pickle) yields the batches the in-RAM set gives."""
    _, paths, x, y = packs
    ds = ooc.OutOfCoreDataset(paths["ours"])
    ram = syn.ArrayDataset(x, y, None, "waveform")
    it = pipe.make_train_iterator(ds, 4, seed=2, workers=1)
    want = pipe.make_train_iterator(ram, 4, seed=2, workers=0)
    try:
        for _ in range(3):
            (bx, by), (wx, wy) = next(it), next(want)
            np.testing.assert_array_equal(bx, wx)
            np.testing.assert_array_equal(by, wy)
    finally:
        it.close()
        want.close()


SMALL = {"model.conv_channels": "8,16", "model.convs_per_stage": 1, "model.embed_dim": 32,
         "model.hidden_units": 64, "model.n_classes": 8, "model.compute_dtype": "float32",
         "model.dropout_rate": 0.0, "frontend.impl": "xla", "data.clip_seconds": 2.0,
         "train.batch_size": 4, "train.num_steps": 10, "train.log_every": 1,
         "train.eval_every": 10, "train.checkpoint_every": 0, "train.data_parallel": 1}


@pytest.fixture(scope="module")
def fit_packs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fit")
    train, ev = str(d / "train.h5"), str(d / "eval.h5")
    ooc.generate_synthetic_pack(train, 16, 8, clip_seconds=2.0, seed=0, multi_label=False)
    ooc.generate_synthetic_pack(ev, 6, 8, clip_seconds=2.0, seed=100, multi_label=False)
    return train, ev


class _Guarded:
    """A reader that fails any read of more than ``limit`` rows and any
    conversion to a whole array: the loop must stream it."""

    def __init__(self, reader, limit):
        self.r, self.limit, self.reads = reader, limit, []
        self.shape, self.ndim, self.dtype = reader.shape, reader.ndim, reader.dtype

    nbytes = property(lambda self: self.r.nbytes)

    def __len__(self):
        return len(self.r)

    def __array__(self, *args, **kwargs):
        raise AssertionError("the whole out-of-core set was materialized")

    def __getitem__(self, idx):
        n = len(np.arange(len(self))[idx]) if not np.isscalar(idx) else 1
        if n > self.limit:
            raise AssertionError(f"a read of {n} rows (limit {self.limit})")
        self.reads.append(n)
        return self.r[idx]


def test_out_of_core_sets_stream_under_the_residency_budget(fit_packs, tmp_path,
                                                            monkeypatch):
    """data.device_resident with a budget far above the set: the train set
    is still gathered per batch (never staged), the eval set read per batch
    (never read whole)."""
    bs = 4
    made = {}

    def guarded(data_cfg, n_classes, split="train", kind="waveform", frontend_cfg=None):
        ds = ooc.OutOfCoreDataset(fit_packs[0] if split == "train" else fit_packs[1])
        ds.x = made[split] = _Guarded(ds.x, bs)
        return ds

    monkeypatch.setattr(loop, "make_dataset", guarded)
    cfg = get_config("us8k_fused_frontend", {
        **SMALL, "data.out_of_core": True, "data.device_resident": True,
        "data.device_resident_max_bytes": 1 << 40, "data.staging_dtype": "adpcm4",
        "train.num_steps": 3, "train.eval_every": 3})
    res = loop.fit(cfg, workspace=str(tmp_path), log=False, device="cpu")
    assert res.counts == {"train_steps": 3, "eval_batches": 2}
    # sorted unique rows of each drawn batch, then the 6 eval clips batch by batch
    assert len(made["train"].reads) == 3 and max(made["train"].reads) <= bs
    assert made["eval"].reads == [4, 2]


@pytest.mark.parametrize("out_of_core,stage", [(False, "float32"), (True, "float32"),
                                               (True, "adpcm4")])
def test_ten_fit_steps_on_a_pack_match_jax(fit_packs, tmp_path, monkeypatch, out_of_core,
                                           stage):
    """fit() on dataset="hdf5" on both packages from JAX's initial weights:
    the ten logged losses within rtol 1e-4 (as tests/test_torch_train.py
    holds the train steps), the final eval stats within the same; out of
    core the port streams every batch, encoded to the staging wire."""
    train, ev = fit_packs
    ov = {**SMALL, "data.dataset": "hdf5", "data.hdf5_path": train,
          "data.eval_hdf5_path": ev, "data.out_of_core": out_of_core,
          "data.staging_dtype": stage}
    jcfg = jax_get_config("us8k_fused_frontend", {**ov, "workspace": str(tmp_path / "j")})
    tcfg = get_config("us8k_fused_frontend", {**ov, "workspace": str(tmp_path / "t")})
    jmodel = jax_build_model(jcfg.model)
    jst = jstate.create_train_state(jcfg, jmodel, jnp.zeros((4, 2, 96, 64), jnp.float32))
    flat = _flat_jax(jst.params, jst.batch_stats)

    def bridged(cfg, device=None, seed=None):
        model = build_model(cfg, device=device)
        model.load_state_dict(flat_to_state_dict(flat, model))
        return model

    encoded = []
    real_encode = loop._encode
    monkeypatch.setattr(loop, "build_model", bridged)
    monkeypatch.setattr(loop, "_encode", lambda x, s: encoded.append(len(x)) or real_encode(x, s))
    ours = loop.fit(tcfg, log=False, device="cpu")
    ref = jloop.fit(jcfg, log=False)
    losses = [h["loss"] for h in ours.history]
    assert len(losses) == 10
    np.testing.assert_allclose(losses, [h["loss"] for h in ref.history], rtol=1e-4, atol=0)
    for k in ("mAP", "mAUC"):
        np.testing.assert_allclose(ours.eval_stats[-1][k], ref.eval_stats[-1][k], rtol=1e-4)
    # out of core: one encode per step of one batch; in RAM: staged once whole
    assert encoded == ([4] * 10 if out_of_core else [16])
