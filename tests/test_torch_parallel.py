"""The PyTorch port's mesh and process-group helpers against the JAX
package's: ``make_mesh`` shapes and errors for the same arguments over 8
devices (JAX's 8 virtual CPU devices, the port's eight CPU shards), the
batch placement helpers, ``local_batch_slice`` / ``is_primary`` /
``initialize`` in one process (tests/test_distributed.py's cases), and the
order in which ``initialize`` resolves its arguments and environment."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.parallel import distributed as jdist  # noqa: E402
from mla_tpu.parallel import mesh as jmesh  # noqa: E402
from mla_tpu_torch.parallel import distributed, mesh  # noqa: E402

CPU8 = ["cpu"] * 8
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
       "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "TPU_WORKER_HOSTNAMES")


@pytest.mark.parametrize("dp,mp", [(-1, 1), (-1, 2), (4, 2), (2, 1), (-1, 8), (1, 4)])
def test_make_mesh_shapes_match_jax(dp, mp):
    ref = jmesh.make_mesh(dp, mp)
    ours = mesh.make_mesh(dp, mp, devices=CPU8)
    assert ours.axis_names == tuple(ref.axis_names) == (mesh.DATA_AXIS, mesh.MODEL_AXIS)
    assert ours.shape == dict(ref.shape)
    assert ours.devices.shape == ref.devices.shape and not ours.multiprocess


@pytest.mark.parametrize("dp,mp", [(-1, 3), (3, 3), (0, 1), (16, 1), (-1, 0), (5, 2)])
def test_make_mesh_errors_match_jax(dp, mp):
    with pytest.raises(ValueError) as ref:
        jmesh.make_mesh(dp, mp)
    with pytest.raises(ValueError) as ours:
        mesh.make_mesh(dp, mp, devices=CPU8)
    assert str(ours.value) == str(ref.value)


def test_make_mesh_defaults_to_the_visible_cards():
    if torch.cuda.is_available():
        assert mesh.make_mesh().size == torch.cuda.device_count()
    else:  # no card: no device, and the reference's error for the empty grid
        with pytest.raises(ValueError, match="exceeds 0 devices"):
            mesh.make_mesh()


def test_batch_placement_on_a_single_process_mesh():
    m = mesh.make_mesh(4, 2, devices=CPU8)
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    parts = mesh.shard_batch({"x": x, "y": x[:, 0]}, m)
    assert len(parts) == 4 and parts[1]["x"].shape == (2, 3)
    np.testing.assert_array_equal(mesh.fetch([p["x"] for p in parts]), x)
    np.testing.assert_array_equal(mesh.fetch(mesh.put_local_batch(x, m, 8)), x)
    reps = mesh.put_replicated(x, m)
    assert len(reps) == 4 and reps[0] is reps[3]  # one copy per distinct device
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_batch(x[:6], m)
    with pytest.raises(ValueError, match="process group"):
        m.group()


def test_single_process_helpers_match_jax(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False and jdist.initialize() is False
    assert distributed.is_primary() is jdist.is_primary() is True
    assert (distributed.process_count(), distributed.process_index()) == (
        jax.process_count(), jax.process_index())
    s, ref = distributed.local_batch_slice(32), jdist.local_batch_slice(32)
    assert (s.start, s.stop) == (ref.start, ref.stop) == (0, 32)
    assert distributed.local_batch_slice(33) == slice(0, 33)  # one process divides all
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    assert distributed.local_batch_slice(32) == slice(16, 32)
    assert distributed.is_primary() is False
    with pytest.raises(ValueError, match="global batch 33 not divisible by 2 processes"):
        distributed.local_batch_slice(33)


@pytest.fixture
def calls(monkeypatch):
    """initialize's environment cleared and its group call recorded."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    seen = []
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: seen.append((backend, kw["init_method"],
                                                           kw["world_size"], kw["rank"])))
    monkeypatch.setattr(distributed.torch.cuda, "is_available", lambda: False)
    return seen


@pytest.mark.parametrize("env,kwargs,want", [
    ({}, {}, None),
    # the reference's names: more than one process only
    ({"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "1"}, {}, None),
    ({"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"}, {},
     ("gloo", "tcp://h:1", 2, 1)),
    # the launcher's: any size, one rank included
    ({"MASTER_ADDR": "m", "MASTER_PORT": "9", "WORLD_SIZE": "1", "RANK": "0"}, {},
     ("gloo", "tcp://m:9", 1, 0)),
    # the launcher's names before the reference's
    ({"MASTER_ADDR": "m", "MASTER_PORT": "9", "WORLD_SIZE": "4", "RANK": "3",
      "JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"}, {},
     ("gloo", "tcp://m:9", 4, 3)),
    # explicit arguments before both; a URL passes as it is
    ({"MASTER_ADDR": "m", "MASTER_PORT": "9", "WORLD_SIZE": "4", "RANK": "3"},
     {"coordinator_address": "file:///tmp/s", "num_processes": 2, "process_id": 0,
      "backend": "nccl"}, ("nccl", "file:///tmp/s", 2, 0)),
    # an address alone, or a count alone, is not enough
    ({"WORLD_SIZE": "2", "RANK": "1"}, {}, None),
    ({}, {"coordinator_address": "h:1"}, None),
])
def test_initialize_resolution_order(monkeypatch, calls, env, kwargs, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert distributed.initialize(**kwargs) is (want is not None)
    assert calls == ([] if want is None else [want])
