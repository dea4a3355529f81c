"""The PyTorch port's train loop on the CPU at a small size: fit() learns
(as tests/test_train.py holds the reference to), an interrupted and resumed
run equals an uninterrupted one, the device-resident and host-fed paths
agree per staging wire, preemption checkpoints and returns, checkpoints
keep the last N, unported options raise, and the ``train`` verb prints the
reference's JSON line."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu import __main__ as jax_cli  # noqa: E402
from mla_tpu_torch import __main__ as cli  # noqa: E402
from mla_tpu_torch.config import (  # noqa: E402
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
    get_config,
)
from mla_tpu_torch.data.synthetic import make_dataset  # noqa: E402
from mla_tpu_torch.models.zoo import build_model  # noqa: E402
from mla_tpu_torch.train import loop  # noqa: E402
from mla_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from mla_tpu_torch.train.state import create_train_state, make_eval_step  # noqa: E402
from tests.torch_port_common import fake_summary_writer  # noqa: E402

# us8k_fused_frontend cut to the CPU: the fused front-end's plain version
WAVE_SMALL = {"model.conv_channels": "8,16", "model.convs_per_stage": 1,
              "model.embed_dim": 32, "model.hidden_units": 64, "model.n_classes": 8,
              "model.compute_dtype": "float32", "model.dropout_rate": 0.2,
              "data.clip_seconds": 2.0, "data.n_train_clips": 16, "data.n_eval_clips": 8,
              "train.batch_size": 4, "train.num_steps": 10, "train.log_every": 1,
              "train.eval_every": 100, "train.checkpoint_every": 5}


def _wave_cfg(workspace, **over):
    return get_config("us8k_fused_frontend", {**WAVE_SMALL, "workspace": str(workspace), **over})


def _features_cfg(workspace, steps=60):
    """tests/test_train.py::_tiny_cfg of the reference, multi-level, features."""
    return Config(
        name="test_features", workspace=str(workspace),
        model=ModelConfig(variant="multi_level_attention", trunk="none", n_classes=8,
                          n_blocks=2, hidden_units=64, conv_channels=(8, 16),
                          convs_per_stage=1, dropout_rate=0.2, compute_dtype="float32"),
        data=DataConfig(dataset="synthetic_audioset", n_train_clips=64, n_eval_clips=32,
                        clip_seconds=2.0),
        train=TrainConfig(batch_size=16, num_steps=steps, eval_every=steps,
                          checkpoint_every=steps, log_every=10, learning_rate=3e-3,
                          data_parallel=1))


def _params(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def test_fit_features_loss_decreases_and_beats_chance(tmp_path):
    res = loop.fit(_features_cfg(tmp_path), log=False, device="cpu")
    losses = [h["loss"] for h in res.history]
    assert losses[-1] < losses[0] * 0.8, losses
    stats = res.eval_stats[-1]
    # 8 classes, ~2 active per clip -> chance mAP ~ 0.25
    assert stats["mAP"] > 0.4, stats
    assert np.isfinite(stats["d_prime"])
    assert res.counts == {"train_steps": 60, "eval_batches": 2}


def test_fit_waveform_learns_and_counts_front_end_calls(tmp_path):
    cfg = _wave_cfg(tmp_path, **{"train.num_steps": 30, "train.eval_every": 15,
                                 "train.learning_rate": 3e-3})
    res = loop.fit(cfg, log=True, device="cpu")
    losses = [h["loss"] for h in res.history]
    assert losses[-1] < losses[0] * 0.8, losses
    assert res.eval_stats[-1]["mAP"] > 0.3  # 8 single-label classes: chance ~ 0.125
    # each train step and each eval batch runs the front-end once
    assert res.counts == {"train_steps": 30, "eval_batches": 2 * 2}
    rows = (tmp_path / "scalars.csv").read_text().splitlines()
    assert rows[0] == "step,key,value" and any(",mAP," in r for r in rows)
    assert (tmp_path / "logs" / "0000.log").exists()


@pytest.mark.parametrize("balanced", [True, False])
def test_resumed_run_equals_uninterrupted(tmp_path, balanced):
    """5 steps, then auto_resume to 10 == 10 uninterrupted steps: the
    sampler position (or the host RNG's state), Adam's moments and the
    dropout masks, which are drawn from (train.seed, step), all carry over."""
    over = {"data.balanced_sampling": balanced}
    full = loop.fit(_wave_cfg(tmp_path / "full", **over), log=False, device="cpu")
    part = _wave_cfg(tmp_path / "part", **over, **{"train.num_steps": 5})
    assert loop.fit(part, log=False, device="cpu").state.step == 5
    resumed = loop.fit(dataclasses.replace(part, train=dataclasses.replace(
        part.train, num_steps=10)), log=False, auto_resume=True, device="cpu")
    assert [h["step"] for h in resumed.history] == list(range(6, 11))
    np.testing.assert_allclose([h["loss"] for h in resumed.history],
                               [h["loss"] for h in full.history[5:]], rtol=1e-6, atol=0)
    a, b = _params(resumed.state), _params(full.state)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=1e-6)


@pytest.mark.parametrize("stage", ["float32", "int16", "uint8", "adpcm4"])
def test_device_resident_matches_host_feed(tmp_path, stage):
    """The training set staged once in its wire form with a gather by index
    gives the same trajectory as batches encoded and uploaded per step."""
    over = {"data.staging_dtype": stage, "train.eval_every": 5}
    dev = loop.fit(_wave_cfg(tmp_path / "dev", **over), log=False, device="cpu")
    host = loop.fit(_wave_cfg(tmp_path / "host", **over, **{"data.device_resident": False}),
                    log=False, device="cpu")
    np.testing.assert_allclose([h["loss"] for h in dev.history],
                               [h["loss"] for h in host.history], rtol=1e-6, atol=1e-7)
    assert np.isfinite([h["loss"] for h in dev.history]).all()
    for a, b in zip(dev.eval_stats, host.eval_stats):
        assert a == pytest.approx(b, rel=1e-6)


def test_device_resident_eval_matches_host_eval(tmp_path):
    """18 eval clips in batches of 16: one full window and a shifted one."""
    cfg = _wave_cfg(tmp_path, **{"data.n_eval_clips": 18, "train.batch_size": 16,
                                 "train.num_steps": 2})
    res = loop.fit(cfg, log=False, device="cpu")
    ds = make_dataset(cfg.data, cfg.model.n_classes, "eval", "waveform")
    step = make_eval_step(cfg, res.state.model, "waveform")
    dev = torch.device("cpu")
    counts = {"eval_batches": 0}
    host = loop.evaluate(cfg, res.state, ds, step, dev, counts=counts)
    resident = loop.evaluate(cfg, res.state, ds, step, dev,
                             x_device=torch.from_numpy(ds.x), counts=counts)
    assert counts["eval_batches"] == 4
    assert resident == pytest.approx(host, rel=1e-6)


def test_request_preemption_checkpoints_and_returns(tmp_path, monkeypatch):
    cfg = _wave_cfg(tmp_path, **{"train.checkpoint_every": 0})
    write = loop.ScalarWriter.write

    def write_then_preempt(self, step, scalars):
        write(self, step, scalars)
        if step == 3:
            loop.request_preemption()

    monkeypatch.setattr(loop.ScalarWriter, "write", write_then_preempt)
    handler = signal.getsignal(signal.SIGTERM)
    res = loop.fit(cfg, log=False, device="cpu")
    assert res.interrupted and res.history[-1]["step"] == 3 and res.state.step == 3
    assert signal.getsignal(signal.SIGTERM) == handler  # the handler is put back
    mgr = CheckpointManager(os.path.join(str(tmp_path), "checkpoints", cfg.name))
    assert mgr.steps() == [3]
    state, sampler_state = loop.resume(cfg, device="cpu")
    assert state.step == 3 and sampler_state is not None
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, res.state.model.state_dict()[k]), k


def test_checkpoint_manager_keeps_the_last_n(tmp_path):
    cfg = _wave_cfg(tmp_path, **{"train.ema_decay": 0.5})
    state = create_train_state(cfg, build_model(cfg.model, device="cpu", seed=0))
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    assert mgr.latest_step() is None
    for step in range(1, 6):
        state.step = step
        mgr.save(step, state, {"step": step}, config={"name": cfg.name})
    assert mgr.steps() == [4, 5]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000004.pt", "step_00000005.pt"]
    fresh = create_train_state(cfg, build_model(cfg.model, device="cpu", seed=1))
    restored, sampler_state = mgr.restore(fresh, step=4)
    assert restored.step == 4 and sampler_state == {"step": 4}
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    for k, v in state.ema_params.items():
        assert torch.equal(restored.ema_params[k], v), k
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(fresh)


@pytest.mark.parametrize("override,err,what", [
    # data and tensor parallelism are ported: without a process group the
    # world is one device, and the reference's make_mesh errors say so
    ({"train.model_parallel": 2}, ValueError, "model_parallel=2 must divide device count 1"),
    ({"train.data_parallel": 2}, ValueError,
     r"data_parallel\*model_parallel = 2\*1 exceeds 1 devices"),
])
def test_unported_options_raise(tmp_path, override, err, what):
    """Tensor and data parallelism beyond the world (one device in a single
    process) raise the reference's ``make_mesh`` errors."""
    cfg = _wave_cfg(tmp_path, **override)
    with pytest.raises(err, match=what):
        loop.fit(cfg, log=False, device="cpu")


@pytest.mark.parametrize("override,what", [
    ({"data.pipeline": "grain"}, "grain"),
    ({"data.dataset": "synthetic_events"}, "synthetic_events"),
    ({"train.tensorboard": True}, "TensorBoard"),
    ({"data.dataset": "hdf5"}, "hdf5"),
])
def test_formerly_unported_options_train(tmp_path, monkeypatch, override, what):
    """Options that once raised as unported (the grain pipeline, the
    synthetic_events corpus, TensorBoard, hdf5 packs) now train two steps."""
    if what == "hdf5":  # a pack of the synthetic set, for train and eval
        from mla_tpu_torch.data import hdf5

        base = _wave_cfg(tmp_path)
        ds = make_dataset(base.data, base.model.n_classes)
        hdf5.pack_hdf5(str(tmp_path / "p.h5"), ds.x, ds.y, ds.ids)
        override = {**override, "data.hdf5_path": str(tmp_path / "p.h5"),
                    "data.eval_hdf5_path": str(tmp_path / "p.h5")}
    calls = fake_summary_writer(monkeypatch)  # tests/test_torch_logging.py holds the real one
    cfg = _wave_cfg(tmp_path, **override)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_steps=2, eval_every=2, checkpoint_every=0))
    result = loop.fit(cfg, log=False, device="cpu")
    assert result.counts["train_steps"] == 2 and np.isfinite(result.history[-1]["loss"])
    if what == "TensorBoard":
        assert ("loss", result.history[0]["loss"], 1) in calls and calls[-1] == "close"


def test_fit_needs_a_card_unless_cpu_is_named(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.fit(_wave_cfg(tmp_path), log=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["train", "--config", "us8k_fused_frontend", "--workspace", str(tmp_path)])


def test_train_verb_prints_the_reference_json_line(tmp_path, capsys):
    sets = [f"{k}={v}" for k, v in WAVE_SMALL.items()] + ["train.num_steps=6",
                                                          "train.eval_every=6"]
    args = ["train", "--config", "us8k_fused_frontend", "--workspace", str(tmp_path),
            "--device", "cpu", "--set", *sets]
    assert cli.main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"final_loss", "mAP", "mAUC", "d_prime", "step"}
    assert np.isfinite(out["final_loss"]) and out["step"] == 6
    # --resume restores the last checkpoint (step 6, saved at the end) and runs on
    assert cli.main(args[:-2] + ["train.num_steps=8", "train.eval_every=8", "--resume"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == 8
    # non-finite stats print as strings, as the reference's CLI prints them
    stats = {"final_loss": 0.5, "mAP": float("nan"), "d_prime": float("inf"), "x": [1.0]}
    assert cli._jdump(stats) == jax_cli._jdump(stats)
    assert cli._parse_sets(["a.b=1", "c=x=y"]) == jax_cli._parse_sets(["a.b=1", "c=x=y"])
