"""The stateless balanced pipeline of the PyTorch port
(mla_tpu_torch/data/pipeline.py, a torch DataLoader) against the JAX
package's grain pipeline: the index stream position for position, O(1)
resume, host slices, DataLoader workers, and ten fit() steps with
data.pipeline="grain" against JAX's fit() from the same weights."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import itertools  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from mla_tpu.config import get_config as jax_get_config  # noqa: E402
from mla_tpu.data import pipeline as jpipe  # noqa: E402
from mla_tpu.data.synthetic import ArrayDataset as JaxArrayDataset  # noqa: E402
from mla_tpu.models.zoo import build_model as jax_build_model  # noqa: E402
from mla_tpu.train import loop as jloop  # noqa: E402
from mla_tpu.train import state as jstate  # noqa: E402
from mla_tpu_torch.config import get_config  # noqa: E402
from mla_tpu_torch.data import pipeline as pipe  # noqa: E402
from mla_tpu_torch.data.synthetic import ArrayDataset  # noqa: E402
from mla_tpu_torch.models.convert import flat_to_state_dict  # noqa: E402
from mla_tpu_torch.models.zoo import build_model  # noqa: E402
from mla_tpu_torch.train import loop  # noqa: E402
from tests.test_torch_train import _flat_jax  # noqa: E402

N_CLASSES = 527


def _labels(seed=0, n=300, c=N_CLASSES):
    """Multi-hot labels over 527 classes, some with no positive clip."""
    y = (np.random.default_rng(seed).random((n, c)) < 0.01).astype(np.float32)
    y[:, 5] = 0.0
    return y


def _datasets(n=48, c=7, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype(np.float32)
    y = (rng.random((n, c)) < 0.3).astype(np.float32)
    y[np.arange(n), rng.integers(0, c, n)] = 1.0
    ids = np.arange(n)
    return ArrayDataset(x, y, ids, "features"), JaxArrayDataset(x, y, ids, "features")


def test_index_stream_equals_grains_for_four_epochs_of_527_classes():
    y = _labels()
    ours = pipe.balanced_index_dataset(y, seed=3)
    ref = jpipe.balanced_index_dataset(y, seed=3)
    n = 4 * N_CLASSES
    assert [ours[p] for p in range(n)] == [int(ref[p]) for p in range(n)]
    hist = pipe.class_histogram(y, np.array([ours[p] for p in range(n)]))
    np.testing.assert_array_equal(hist, jpipe.class_histogram(y, np.array([ours[p] for p in
                                                                           range(n)])))
    later = pipe.balanced_index_dataset(y, seed=3, start_position=1000)
    assert [later[i] for i in range(50)] == [ours[1000 + i] for i in range(50)]
    with pytest.raises(ValueError, match="no class"):
        pipe.balanced_index_dataset(np.zeros((4, 3), np.float32))


def test_batches_equal_grains_and_resume_in_o1():
    ds, jds = _datasets()
    fresh = list(itertools.islice(pipe.make_train_iterator(ds, 8, seed=2), 6))
    ref = list(itertools.islice(jpipe.make_train_iterator(jds, 8, seed=2), 6))
    for (x, y), (rx, ry) in zip(fresh, ref):
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)
    resumed = list(itertools.islice(pipe.make_train_iterator(ds, 8, seed=2, start_index=3), 3))
    for (x, y), (fx, fy) in zip(resumed, fresh[3:]):
        np.testing.assert_array_equal(x, fx)
        np.testing.assert_array_equal(y, fy)


def test_host_slices_concatenate_to_the_global_batch():
    ds, jds = _datasets()
    glob = list(itertools.islice(pipe.make_train_iterator(ds, 8, seed=4, start_index=2), 3))
    hosts = [list(itertools.islice(pipe.make_train_iterator(
        ds, 8, seed=4, start_index=2, host_index=h, host_count=4), 3)) for h in range(4)]
    for s in range(3):
        np.testing.assert_array_equal(np.concatenate([hosts[h][s][0] for h in range(4)]),
                                      glob[s][0])
        rx, _ = next(itertools.islice(jpipe.make_train_iterator(
            jds, 8, seed=4, start_index=2 + s, host_index=1, host_count=4), 1))
        np.testing.assert_array_equal(hosts[1][s][0], rx)
    with pytest.raises(ValueError, match="divisible"):
        next(pipe.make_train_iterator(ds, 8, host_count=3))
    with pytest.raises(ValueError, match="host_index"):
        next(pipe.make_train_iterator(ds, 8, host_index=4, host_count=4))


def test_loader_workers_keep_the_stream_order():
    ds, _ = _datasets()
    it = pipe.make_train_iterator(ds, 8, seed=5, workers=2, read_buffer_batches=2)
    got = list(itertools.islice(it, 5))
    it.close()  # stops the workers
    want = list(itertools.islice(pipe.make_train_iterator(ds, 8, seed=5), 5))
    for (x, y), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(x, wx)
        np.testing.assert_array_equal(y, wy)


SMALL = {"model.conv_channels": "8,16", "model.convs_per_stage": 1, "model.embed_dim": 32,
         "model.hidden_units": 64, "model.n_classes": 8, "model.compute_dtype": "float32",
         "model.dropout_rate": 0.0, "frontend.impl": "xla", "data.clip_seconds": 2.0,
         "data.n_train_clips": 16, "data.n_eval_clips": 8, "data.pipeline": "grain",
         "train.batch_size": 4, "train.num_steps": 10, "train.log_every": 1,
         "train.eval_every": 100, "train.checkpoint_every": 0, "train.data_parallel": 1}


def test_ten_fit_steps_on_the_pipeline_match_jax(tmp_path, monkeypatch):
    """fit() with data.pipeline="grain" on both packages from JAX's initial
    weights: the ten logged losses within rtol 1e-4, as the train steps are
    held (tests/test_torch_train.py); the checkpoint keeps JAX's sampler
    state."""
    jcfg = jax_get_config("us8k_fused_frontend", {**SMALL, "workspace": str(tmp_path / "j")})
    tcfg = get_config("us8k_fused_frontend", {**SMALL, "workspace": str(tmp_path / "t"),
                                              "train.checkpoint_every": 10})
    jmodel = jax_build_model(jcfg.model)
    jst = jstate.create_train_state(jcfg, jmodel, jnp.zeros((4, 2, 96, 64), jnp.float32))
    flat = _flat_jax(jst.params, jst.batch_stats)

    def bridged(cfg, device=None, seed=None):
        model = build_model(cfg, device=device)
        model.load_state_dict(flat_to_state_dict(flat, model))
        return model

    monkeypatch.setattr(loop, "build_model", bridged)
    ours = loop.fit(tcfg, log=False, device="cpu")
    ref = jloop.fit(jcfg, log=False)
    losses = [h["loss"] for h in ours.history]
    assert len(losses) == 10
    np.testing.assert_allclose(losses, [h["loss"] for h in ref.history], rtol=1e-4, atol=0)
    _, sampler_state = loop.resume(tcfg, device="cpu")
    assert sampler_state == {"pipeline": "grain", "seed": tcfg.train.seed, "step": 10}
