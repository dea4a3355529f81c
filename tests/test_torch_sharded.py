"""Context-parallel scoring of the PyTorch port: ``tag_clip_time_sharded``
on an 8-shard CPU mesh against JAX's on its 8 virtual devices (the four
cases of tests/test_sharded_serve.py, 34 patches: not a multiple of 8); the
single-process combine of shard states against pairwise merges and JAX's
shard_map psum; and ``psum_stream_state`` on two gloo ranks against the
whole-clip pool, for the exp, max and sigmoid gates."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P  # noqa: E402

from mla_tpu.ops import attention_pool as jap  # noqa: E402
from mla_tpu.parallel import mesh as jmesh  # noqa: E402
from mla_tpu.serve.sharded import tag_clip_time_sharded as jax_time_sharded  # noqa: E402
from mla_tpu_torch.ops import attention_pool as ap  # noqa: E402
from mla_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mla_tpu_torch.serve.sharded import tag_clip_time_sharded  # noqa: E402
from mla_tpu_torch.serve.streaming import tag_clip  # noqa: E402
from tests.torch_port_common import configs, jax_weights, launch_ranks, torch_state_dict  # noqa: E402,E501

TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_sharded_serve.py's
PSUM_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_attention_pool.py's
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def wav():
    return (np.random.default_rng(7).standard_normal(16000 * 33) * 0.1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _setup(variant, seed):
    jcfg, tcfg = configs({"model.variant": variant, "model.n_classes": 7,
                          "model.n_blocks": 2, "model.hidden_units": 48})
    variables, flat = jax_weights(jcfg.model, seed=seed)
    return jcfg, tcfg, variables, torch_state_dict(tcfg.model, flat)


@pytest.mark.parametrize("variant,seed", [("multi_level_attention", 0), ("multi_attention", 2),
                                          ("avg_pool", 3), ("max_pool", 3),
                                          ("single_attention", 1)])
def test_time_sharded_equals_jax_and_whole_clip(wav, variant, seed):
    jcfg, tcfg, variables, sd = _setup(variant, seed)
    mesh = make_mesh(devices=CPU8)
    assert mesh.shape == {"data": 8, "model": 1}
    ours = tag_clip_time_sharded(tcfg, sd, wav, mesh, device="cpu")
    ref = jax_time_sharded(jcfg, variables, wav, jmesh.make_mesh())
    np.testing.assert_allclose(ours, ref, **TOL)
    np.testing.assert_allclose(ours, tag_clip(tcfg, sd, wav, device="cpu"), **TOL)


def test_time_sharded_over_the_model_axis_and_fewer_shards(wav):
    """The axis argument picks the mesh axis; 3 shards pad 34 patches to 36."""
    _, tcfg, _, sd = _setup("multi_level_attention", 0)
    whole = tag_clip(tcfg, sd, wav, device="cpu")
    for mesh, axis in ((make_mesh(1, 3, devices=["cpu"] * 3), "model"),
                       (make_mesh(devices=["cpu"] * 3), "data")):
        np.testing.assert_allclose(tag_clip_time_sharded(tcfg, sd, wav, mesh, axis=axis,
                                                         device="cpu"), whole, **TOL)


def _shard_states(g, c, n, act):
    per = g.shape[1] // n
    return [ap.update_stream_state(ap.init_stream_state((g.shape[0], g.shape[2])),
                                   torch.from_numpy(g[:, i * per:(i + 1) * per]),
                                   torch.from_numpy(c[:, i * per:(i + 1) * per]), act)
            for i in range(n)]


@pytest.mark.parametrize("act", ["exp", "max", "sigmoid"])
def test_combine_equals_merges_and_jax_psum(act):
    rng = np.random.default_rng(1234)
    g = (rng.standard_normal((2, 16, 4)) * 5).astype(np.float32)
    c = rng.standard_normal((2, 16, 4)).astype(np.float32)
    g[0, 8:] = -np.inf  # four of the eight shards fully masked for clip 0
    states = _shard_states(g, c, 8, act)
    combined = ap.combine_stream_states(states, act)
    folded = functools.reduce(lambda a, b: ap.merge_stream_states(a, b, act), states)
    for x, y in zip(combined, folded):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)

    def local(gl, cl):
        st = jap.update_stream_state(jap.init_stream_state((2, 4)), gl, cl, act)
        return jap.stream_finalize(jap.psum_stream_state(st, "t", act))

    mesh = JaxMesh(np.asarray(jax.devices()), ("t",))
    ref = shard_map(local, mesh=mesh, in_specs=(P(None, "t", None), P(None, "t", None)),
                    out_specs=P(None, None))(jnp.asarray(g), jnp.asarray(c))
    np.testing.assert_allclose(ap.stream_finalize(combined).numpy(), np.asarray(ref),
                               **PSUM_TOL)
    if act != "max":
        whole = jap.attention_pool(jnp.asarray(g[1:]), jnp.asarray(c[1:]), act)
        np.testing.assert_allclose(ap.stream_finalize(combined)[1:].numpy(),
                                   np.asarray(whole), **PSUM_TOL)


def test_psum_stream_state_on_two_ranks(tmp_path):
    """Each rank folds its half of the clip; the all-reduced state
    finalizes to the whole clip's pool on both ranks."""
    rng = np.random.default_rng(5)
    job = {"cases": ["psum"], "psum": {}}
    for act in ("exp", "max", "sigmoid"):
        g = (rng.standard_normal((2, 10, 4)) * 5).astype(np.float32)
        g[1, :5] = -np.inf  # rank 0 holds nothing of clip 1
        job["psum"][act] = (g, rng.standard_normal((2, 10, 4)).astype(np.float32))
    ranks = launch_ranks(job, tmp_path)
    for act, (g, c) in job["psum"].items():
        want = ap.stream_finalize(ap.combine_stream_states(_shard_states(g, c, 2, act), act))
        for r in ranks:
            torch.testing.assert_close(r["psum"][act], want, rtol=1e-6, atol=1e-6)
        if act != "max":
            whole = jap.attention_pool(jnp.asarray(g), jnp.asarray(c), act)
            np.testing.assert_allclose(ranks[0]["psum"][act].numpy(), np.asarray(whole),
                                       **PSUM_TOL)
