"""Tensor parallelism of the PyTorch port against the reference's: the rule
(``param_shardings``) on every flat name of the shipped presets, the shards
bit for bit against JAX's addressable shards on the 8-device virtual mesh,
the column- and row-parallel forward against JAX's sharded forward, the
train step on 2 gloo ranks (a (1, 2) mesh) and 4 ((2, 2)) against JAX's step
jitted with ``param_shardings`` in-shardings and against the port's
one-process step, ``fit`` with ``train.model_parallel`` > 1 against the
single-process fit, checkpoints across ``model_parallel``, the server with
weights sharded over a single-process (2, 2) grid against JAX's server with
TP-placed variables, and ``dryrun_multichip``. One launch of each rank
count (tests/torch_tp_worker.py) runs every case, the two at once. The
reference encodes ADPCM through its native library (``mla_tpu.data.native``),
pinned for the whole module by ``reference_native_libraries``, never through
its numpy / scipy fallback."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import csv  # noqa: E402
import os  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mla_tpu.config import get_config as jax_get_config  # noqa: E402
from mla_tpu.models.convert import flat_to_params  # noqa: E402
from mla_tpu.models.zoo import build_model as jax_build_model  # noqa: E402
from mla_tpu.parallel import mesh as jmesh  # noqa: E402
from mla_tpu.serve.server import BatchedStreamingServer as JaxServer  # noqa: E402
from mla_tpu.train import state as jstate  # noqa: E402
from mla_tpu_torch.config import get_config  # noqa: E402
from mla_tpu_torch.models.convert import (  # noqa: E402
    _from_torch_layout,
    _torch_key,
    flat_shapes,
    flat_to_state_dict,
    state_dict_to_flat,
)
from mla_tpu_torch.models.zoo import build_model  # noqa: E402
from mla_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from mla_tpu_torch.parallel import tensor  # noqa: E402
from mla_tpu_torch.serve.server import BatchedStreamingServer  # noqa: E402
from mla_tpu_torch.serve.streaming import _samples_per_patches  # noqa: E402
from mla_tpu_torch.train import checkpoint, loop  # noqa: E402
from mla_tpu_torch.train import state as tstate  # noqa: E402
from tests.test_torch_dp import _adam_mu, _flat_jax  # noqa: E402
from tests.torch_port_common import (  # noqa: E402
    configs,
    jax_weights,
    launch_ranks,
    reference_native_libraries,
    torch_state_dict,
)

pytestmark = pytest.mark.usefixtures("reference_native_libraries")

B, N_SAMPLES = 8, 32000  # the global batch
HIDDEN = 32
# the last conv stage is as wide as the hidden layer, so the rule shards a
# batch norm's bias too; dropout 0 (JAX's masks come from another generator)
STEP = {"model.conv_channels": "8,32", "model.convs_per_stage": 1, "model.embed_dim": 16,
        "model.hidden_units": HIDDEN, "model.n_classes": 8, "model.compute_dtype": "float32",
        "model.dropout_rate": 0.0, "data.clip_seconds": 2.0, "train.batch_size": B,
        "frontend.impl": "xla"}
VARIANTS = {"plain": {}, "clip": {"train.gradient_clip_norm": 0.01},
            "ema": {"train.ema_decay": 0.9}}
MESHES = {2: (1, 2), 4: (2, 2)}  # ranks -> (data, model)
SHARDED = ["block0.fc0.bias", "block0.fc0.weight", "att.cla.weight", "att.gate.weight",
           "trunk_module.bn1_0.bias", "trunk_module.embed.weight"]
TOL = 1e-5  # loss, parameters, statistics, f32
GRAD_ATOL, GRAD_RTOL = 1e-7, 2e-4  # tests/test_torch_dp.py's
DECIDED = 100 * tstate.ADAM_EPS
FIT = {**STEP, "model.dropout_rate": 0.2, "data.clip_seconds": 1.0, "data.n_train_clips": 16,
       "data.n_eval_clips": 8, "train.batch_size": 4, "train.num_steps": 6,
       "train.log_every": 1, "train.eval_every": 3, "train.checkpoint_every": 3,
       "train.ema_decay": 0.9, "train.gradient_clip_norm": 1.0}
# heads for the forward: tests/test_parallel.py's single_attention, and the
# flagship's multi-level head, both on feature input
FORWARD = {"single_attention": {"model.variant": "single_attention", "model.trunk": "none",
                                "model.n_classes": 6, "model.n_blocks": 2,
                                "model.hidden_units": 64, "model.compute_dtype": "float32"},
           "multi_level": {"model.variant": "multi_level_attention", "model.trunk": "none",
                           "model.n_classes": 6, "model.n_blocks": 3,
                           "model.hidden_units": 64, "model.compute_dtype": "float32"}}


def _jax_tp_step(overrides, flat, x, y, mesh_shape):
    """JAX's step from the ``flat`` weights, jitted with the rule's
    in-shardings on a (data, model) mesh of the virtual devices: (state
    after, loss)."""
    jcfg = jax_get_config("us8k_fused_frontend", overrides)
    jmodel = jax_build_model(jcfg.model)
    jst = jstate.create_train_state(jcfg, jmodel, jnp.zeros((B, 2, 96, 64), jnp.float32))
    tree = jax.tree.map(jnp.asarray, flat_to_params(flat))
    jst = jst.replace(params=tree["params"], batch_stats=tree["batch_stats"],
                      opt_state=jstate.make_optimizer(jcfg).init(tree["params"]),
                      ema_params=tree["params"] if jcfg.train.ema_decay > 0 else None)
    mesh = jmesh.make_mesh(*mesh_shape, devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
    sh = jmesh.param_shardings(mesh, jst, jcfg.model.hidden_units)
    bsh = jmesh.batch_sharding(mesh, 2)
    step = jax.jit(jstate.make_train_step(jcfg, jmodel, "waveform", clip_samples=N_SAMPLES),
                   in_shardings=(sh, bsh, bsh), out_shardings=(sh, jmesh.replicated(mesh)))
    jst, loss = step(jax.device_put(jst, sh), jax.device_put(x, bsh), jax.device_put(y, bsh))
    return jst, float(loss)


def _jax_forward(overrides, x, mesh_shape):
    """(flat weights, JAX's forward with TP-placed params on a mesh); the
    biases moved off their zero init, so a bias added on every rank shows."""
    jcfg = jax_get_config("default", overrides)
    model = jax_build_model(jcfg.model)
    flat = _flat_jax(model.init(jax.random.key(0), jnp.asarray(x))["params"])
    rng = np.random.default_rng(5)
    for k, a in flat.items():
        if k.endswith("/bias"):
            flat[k] = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    variables = {"params": jax.tree.map(jnp.asarray, flat_to_params(flat)["params"])}
    mesh = jmesh.make_mesh(*mesh_shape, devices=jax.devices()[:mesh_shape[0] * mesh_shape[1]])
    placed = jax.device_put(variables, jmesh.param_shardings(mesh, variables,
                                                             jcfg.model.hidden_units))
    out = jax.jit(model.apply)(placed, jax.device_put(x, jmesh.batch_sharding(mesh, 3)))
    return flat, np.asarray(out)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(21)
    x = (0.1 * rng.standard_normal((B, N_SAMPLES))).astype(np.float32)
    y = (rng.random((B, 8)) < 0.3).astype(np.float32)
    fx = rng.standard_normal((4, 10, 128)).astype(np.float32)
    # JAX's own initial state, as tests/test_torch_dp.py starts from: from
    # weights perturbed off it (torch_port_common.jax_weights) the port's
    # one-process step and JAX's already differ past GRAD_RTOL on a few
    # entries of the deep conv's gradient (ReLU and max-pool decisions
    # within an ulp of a tie), tensor parallelism or not
    jcfg = jax_get_config("us8k_fused_frontend", STEP)
    jst0 = jstate.create_train_state(jcfg, jax_build_model(jcfg.model),
                                     jnp.zeros((B, 2, 96, 64), jnp.float32))
    flat = _flat_jax(jst0.params, jst0.batch_stats)
    # a checkpoint written at model_parallel 1, for the ranks to restore
    restore_ws = str(tmp / "mp1")
    single_cfg = get_config("us8k_fused_frontend", {**FIT, "train.num_steps": 3})
    loop.fit(single_cfg, workspace=restore_ws, log=False, device="cpu")
    jobs, refs = {}, {}
    for n, mesh_shape in MESHES.items():
        jobs[n] = {"cases": ["forward", "step", "fit"] + (["restore"] if n == 2 else []),
                   "mesh": mesh_shape, "forward": {}, "step": {},
                   "fit": {"overrides": FIT, "workspace": str(tmp / f"fit{n}")},
                   "restore": {"workspace": restore_ws}}
        for name, over in FORWARD.items():
            fflat, fout = _jax_forward(over, fx, mesh_shape)
            jobs[n]["forward"][name] = {"overrides": over, "flat": fflat, "x": fx}
            refs[(n, "forward", name)] = fout
        for name, over in VARIANTS.items():
            dp, mp = mesh_shape
            over = {**STEP, **over, "train.data_parallel": dp, "train.model_parallel": mp}
            jobs[n]["step"][name] = {"overrides": over, "flat": flat, "x": x, "y": y}
    for n in MESHES:
        (tmp / f"r{n}").mkdir()
    with ThreadPoolExecutor(2) as pool:
        futures = {n: pool.submit(launch_ranks, jobs[n], tmp / f"r{n}", n, "torch_tp_worker")
                   for n in MESHES}
        # JAX's sharded steps while the ranks run; every JAX init draws the
        # same weights (the seed), which the ranks replace by ``flat``
        for n, mesh_shape in MESHES.items():
            for name, over in VARIANTS.items():
                refs[(n, "step", name)] = _jax_tp_step({**STEP, **over}, flat, x, y,
                                                       mesh_shape)
        ranks = {n: f.result() for n, f in futures.items()}
    return {"ranks": ranks, "refs": refs, "jobs": jobs, "tmp": tmp, "flat": flat, "x": x,
            "y": y, "restore_ws": restore_ws, "single_cfg": single_cfg}


# --- the rule and the placements ---

def _jax_flat_specs(sh_tree):
    flat = jax.tree_util.tree_flatten_with_path(
        sh_tree, is_leaf=lambda v: isinstance(v, jax.sharding.NamedSharding))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
            for path, s in flat}


@pytest.mark.parametrize("preset", ["audioset_full_dp", "streaming_inference",
                                    "us8k_fused_frontend"])
def test_param_shardings_equal_jax_for_every_flat_name(preset):
    """Every flat name of the preset's tree as shipped, at (4, 2): the port's
    spec (on flax shapes from the port's own state_dict) equals JAX's
    ``param_shardings`` on the flax tree; 15 names are sharded on the
    flagship and serving trees (3 column-parallel fc0 kernels and their
    biases, 6 row-parallel attention kernels, the trunk's embed kernel, and
    the two 512-wide bn3 biases), and the torch dimension of each follows
    the transpose."""
    jcfg, cfg = jax_get_config(preset), get_config(preset)
    jmodel = jax_build_model(jcfg.model)
    abstract = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                                  jnp.zeros((1, 2, 96, 64), jnp.float32)))
    jm = jmesh.make_mesh(4, 2)
    want = _jax_flat_specs(jmesh.param_shardings(jm, abstract, jcfg.model.hidden_units))
    sd = build_model(cfg.model, device="meta").state_dict()
    mesh = pmesh.make_mesh(4, 2, devices=["cpu"] * 8)
    got = {k: p.spec for k, p in pmesh.param_shardings(mesh, flat_shapes(sd),
                                                       cfg.model.hidden_units).items()}
    assert got == want
    sharded = {k for k, s in got.items() if s}
    if preset != "us8k_fused_frontend":
        assert len(sharded) == 15, sorted(sharded)
        assert {"params/trunk_module/bn3_0/bias", "params/trunk_module/bn3_1/bias",
                "params/trunk_module/embed/kernel", "params/att2/cla/kernel"} <= sharded
    dims = tensor.shard_dims(sd, 2, cfg.model.hidden_units)
    assert len(dims) == len(sharded)
    for k, d in dims.items():
        spec = got[f"params/{k.rsplit('.', 1)[0].replace('.', '/')}/" +
                   ("kernel" if k.endswith("weight") and sd[k].dim() == 2 else "bias")]
        assert d == {(None, "model"): 0, ("model", None): 1, ("model",): 0}[spec], k


def test_divisibility_guard_and_placements():
    """At model = 3 the flagship's 512-wide kernels do not split: every
    spec is replicated, as JAX's guard has it; ``replicated`` and
    ``batch_sharding`` carry JAX's specs; a TP layer needs a group or a
    device list."""
    jcfg, cfg = jax_get_config("audioset_full_dp"), get_config("audioset_full_dp")
    jmodel = jax_build_model(jcfg.model)
    abstract = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                                  jnp.zeros((1, 2, 96, 64), jnp.float32)))
    jm = jmesh.make_mesh(2, 3, devices=jax.devices()[:6])
    want = _jax_flat_specs(jmesh.param_shardings(jm, abstract, 512))
    mesh = pmesh.make_mesh(2, 3, devices=["cpu"] * 6)
    sd = build_model(cfg.model, device="meta").state_dict()
    got = {k: p.spec for k, p in pmesh.param_shardings(mesh, flat_shapes(sd), 512).items()}
    assert got == want and not any(got.values())
    # a nested tree too, as the reference's unit test has it
    params = {"block0": {"fc0": {"kernel": np.zeros((128, 64)), "bias": np.zeros(64)}},
              "att": {"gate": {"kernel": np.zeros((64, 17)), "bias": np.zeros(17)}}}
    sh = pmesh.param_shardings(pmesh.make_mesh(4, 2, devices=["cpu"] * 8), params, 64)
    assert sh["block0"]["fc0"]["kernel"].spec == (None, "model")
    assert sh["block0"]["fc0"]["bias"].spec == ("model",)
    assert sh["att"]["gate"]["kernel"].spec == ("model", None)
    assert sh["att"]["gate"]["bias"].spec == ()
    assert pmesh.replicated(mesh).spec == tuple(jmesh.replicated(jm).spec) == ()
    assert pmesh.batch_sharding(mesh, 3).spec == tuple(jmesh.batch_sharding(jm, 3).spec)
    with pytest.raises(ValueError, match="process group or a device list"):
        tensor.ModelAxis()


def test_shards_equal_jax_addressable_shards():
    """``shard_state_dict`` of the flat weights for each (data, model)
    coordinate of a (4, 2) mesh, bit for bit against the shard JAX's device
    at that coordinate holds after ``jax.device_put(params,
    param_shardings(...))``."""
    jcfg, _ = configs({"model.conv_channels": "8,32", "model.hidden_units": 32})
    variables, flat = jax_weights(jcfg.model, seed=4)
    jm = jmesh.make_mesh(4, 2)
    placed = jax.device_put(variables, jmesh.param_shardings(jm, variables, 32))
    mesh = pmesh.make_mesh(4, 2, devices=["cpu"] * 8)
    coords = {dev: (d, m) for (d, m), dev in np.ndenumerate(jm.devices)}
    ours = {c: tensor.shard_state_dict(flat, mesh, 32, c) for c in coords.values()}
    leaves = jax.tree_util.tree_flatten_with_path(placed)[0]
    n_sharded = 0
    for path, arr in leaves:
        key = "/".join(str(k.key) for k in path)
        for shard in arr.addressable_shards:
            mine = ours[coords[shard.device]][_torch_key(key)].numpy()
            np.testing.assert_array_equal(_from_torch_layout(mine), np.asarray(shard.data),
                                          err_msg=key)
        n_sharded += arr.sharding.spec != jax.sharding.PartitionSpec()
    # three blocks: 3 fc0 kernels and biases, 6 attention kernels, the
    # trunk's embed kernel and the 32-wide bn1_0 bias
    assert n_sharded == 14


# --- forward, step and fit over the ranks ---

@pytest.mark.parametrize("n", list(MESHES))
@pytest.mark.parametrize("head", list(FORWARD))
def test_tp_forward_equals_jax_tp_forward(run, n, head):
    """The head on features with column- and row-parallel Dense over the
    "model" group (each data rank's rows) and over a single-process device
    list (the whole batch), against JAX's forward with TP-placed params:
    rtol 1e-5, atol 1e-6 (tests/test_parallel.py's)."""
    want = run["refs"][(n, "forward", head)]
    dp = MESHES[n][0]
    got = np.concatenate([run["ranks"][n][r]["forward"][head].numpy()
                          for r in range(0, n, MESHES[n][1])])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for r in range(n):  # the model group's ranks hold the same output
        d = r // MESHES[n][1]
        np.testing.assert_array_equal(run["ranks"][n][r]["forward"][head].numpy(),
                                      got[d * len(got) // dp:(d + 1) * len(got) // dp])
    spec = run["jobs"][n]["forward"][head]
    cfg = get_config("default", spec["overrides"])
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(flat_to_state_dict(spec["flat"], model))
    tensor.tensor_parallel(model, tensor.ModelAxis(devices=["cpu"] * MESHES[n][1]),
                           cfg.model.hidden_units)
    with torch.no_grad():
        local = model(torch.from_numpy(spec["x"])).numpy()
    np.testing.assert_allclose(local, want, rtol=1e-5, atol=1e-6)


def _one_process(spec):
    """The port's one-process step on the whole batch from the same weights."""
    over = {k: v for k, v in spec["overrides"].items()
            if k not in ("train.data_parallel", "train.model_parallel")}
    cfg = get_config("us8k_fused_frontend", over)
    model = build_model(cfg.model, device="cpu")
    model.load_state_dict(flat_to_state_dict(spec["flat"], model))
    st = tstate.create_train_state(cfg, model)
    step = tstate.make_train_step(cfg, model, "waveform", clip_samples=N_SAMPLES)
    st, loss = step(st, torch.from_numpy(spec["x"]), torch.from_numpy(spec["y"]))
    beta1 = tstate.ADAM_BETAS[0]
    grads = {n: st.optimizer.state[p]["exp_avg"] / (1 - beta1)
             for n, p in model.named_parameters()}
    return float(loss), state_dict_to_flat(grads), state_dict_to_flat(model.state_dict())


def _close_grads(got, want, what):
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g, rtol=0,
                                   atol=GRAD_ATOL + GRAD_RTOL * np.abs(g).max(),
                                   err_msg=f"gradient {k} against {what}")


@pytest.mark.parametrize("n", list(MESHES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tp_step_equals_jax_tp_step_and_one_process(run, n, variant):
    """One step on the (1, 2) and (2, 2) meshes: every rank the same loss
    and the same whole state; the rows by data coordinate; the loss,
    parameters, batch statistics and EMA shadow against JAX's sharded step,
    the gradients against it and against the port's one-process step."""
    ranks = [r["step"][variant] for r in run["ranks"][n]]
    spec = run["jobs"][n]["step"][variant]
    jst, jloss = run["refs"][(n, "step", variant)]
    dp, mp = MESHES[n]
    per = B // dp
    assert [r["rows"] for r in ranks] == [(r // mp * per, (r // mp + 1) * per)
                                          for r in range(n)]
    assert [r["index"] for r in ranks] == [r // mp for r in range(n)]
    assert ranks[0]["shard_names"] == sorted(SHARDED)
    assert len({r["loss"] for r in ranks}) == 1
    for r in ranks[1:]:
        for k in ranks[0]["flat"]:
            np.testing.assert_array_equal(r["flat"][k], ranks[0]["flat"][k], err_msg=k)
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], jloss, rtol=TOL, atol=0)
    loss1, grads1, _ = _one_process(spec)
    np.testing.assert_allclose(got["loss"], loss1, rtol=TOL, atol=0)
    _close_grads(got["grads"], grads1, "the one-process step")
    beta1 = tstate.ADAM_BETAS[0]
    jgrads = {k: mu / (1 - beta1) for k, mu in _flat_jax(_adam_mu(jst.opt_state)).items()}
    _close_grads(got["grads"], jgrads, "JAX's sharded step")
    lr = tstate.lr_schedule(get_config("us8k_fused_frontend", spec["overrides"]))(0)
    params = _flat_jax(jst.params)
    for k, g in jgrads.items():
        decided = np.abs(g) >= DECIDED
        np.testing.assert_allclose(got["flat"][k][decided], params[k][decided], rtol=0,
                                   atol=TOL, err_msg=f"params {k}")
        assert np.all(np.abs(got["flat"][k] - spec["flat"][k])[~decided]
                      <= lr * (1 + 1e-6) + 1e-7), k
        if variant == "ema":
            ema = np.asarray(_flat_jax(jst.ema_params)[k])
            np.testing.assert_allclose(got["ema"][k][decided], ema[decided], rtol=0,
                                       atol=TOL, err_msg=f"ema {k}")
    assert (got["ema"] is None) == (variant != "ema")
    for k, v in _flat_jax({}, jst.batch_stats).items():
        np.testing.assert_allclose(got["flat"][k], v, rtol=0, atol=TOL, err_msg=k)


def _scalars(path):
    with open(path) as fh:
        return [(int(r["step"]), r["key"], float(r["value"])) for r in csv.DictReader(fh)
                if r["key"] != "clips_per_sec"]


@pytest.fixture(scope="module")
def single_fit(run):
    ws = run["tmp"] / "single_fit"
    res = loop.fit(get_config("us8k_fused_frontend", FIT), workspace=str(ws), device="cpu")
    return ws, res


@pytest.mark.parametrize("n", list(MESHES))
def test_tp_fit_equals_single_process_fit(run, single_fit, n):
    """Six steps with dropout, the global-norm clip, EMA and two evals at
    model_parallel 2 (and data 2 on four ranks): scalars.csv within 1e-5 of
    the single-process fit's, every rank with the same history and whole
    state, and that state within 1e-5 of the single process's."""
    ws, single = single_fit
    ranks = [r["fit"] for r in run["ranks"][n]]
    got = _scalars(os.path.join(run["jobs"][n]["fit"]["workspace"], "scalars.csv"))
    want = _scalars(ws / "scalars.csv")
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want], rtol=1e-5, atol=1e-5)
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"] and r["eval"] == ranks[0]["eval"]
        for k, v in ranks[0]["payload"]["model"].items():
            assert torch.equal(r["payload"]["model"][k], v), k
    assert ranks[0]["counts"] == {"train_steps": 6, "eval_batches": 2 * 2}
    for k, v in single.state.model.state_dict().items():
        np.testing.assert_allclose(ranks[0]["payload"]["model"][k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


def test_tp_checkpoint_resumes_bit_equal_at_model_parallel_1(run):
    """The mp = 2 fit's step-6 checkpoint (written whole by rank 0)
    restores at model_parallel 1 bit for bit: parameters, statistics,
    Adam's moments, the EMA shadow and the step; and an mp = 1 checkpoint
    restored over "model" gives each rank its slices and gathers back to
    the saved state bit for bit."""
    payload = run["ranks"][2][0]["fit"]["payload"]
    cfg = get_config("us8k_fused_frontend", FIT)
    state, _ = loop.resume(cfg, run["jobs"][2]["fit"]["workspace"], device="cpu")
    mine = checkpoint.train_state_payload(state)
    assert mine["step"] == payload["step"] == 6
    for part in ("model", "ema"):
        assert list(mine[part]) == list(payload[part])
        for k, v in payload[part].items():
            assert torch.equal(mine[part][k], v), (part, k)
    for i, s in payload["optimizer"]["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(mine["optimizer"]["state"][i][k], s[k]), (i, k)
    # the other way: the mp = 1 checkpoint restored on two ranks
    single, _ = loop.resume(run["single_cfg"], run["restore_ws"], device="cpu")
    saved = checkpoint.train_state_payload(single)
    mesh = pmesh.make_mesh(1, 2, devices=["cpu"] * 2)
    hidden = run["single_cfg"].model.hidden_units
    for m, r in enumerate(run["ranks"][2]):
        got = r["restore"]
        assert got["step"] == 3
        want_local = tensor.shard_state_dict(saved["model"], mesh, hidden, (0, m))
        for k, v in want_local.items():
            assert torch.equal(got["local"][k], v), k
        for part in ("model", "ema"):
            for k, v in saved[part].items():
                assert torch.equal(got["payload"][part][k], v), (part, k)
        for i, s in saved["optimizer"]["state"].items():
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(got["payload"]["optimizer"]["state"][i][k], s[k]), (i, k)


# --- the server with weights sharded over a single-process grid ---

SERVE = {"model.n_classes": 9, "model.n_blocks": 2, "model.hidden_units": 16}


@pytest.fixture(scope="module")
def serving():
    jcfg, tcfg = configs(SERVE)
    (v1, f1), (_, f2) = jax_weights(jcfg.model, seed=8), jax_weights(jcfg.model, seed=9)
    wav = (np.random.default_rng(2).standard_normal(16000 * 30) * 0.1).astype(np.float32)
    n = _samples_per_patches(tcfg.frontend, 7)
    streams = [wav[:n], wav[n:2 * n], (wav[:n] * 0.3).astype(np.float32)]
    return jcfg, tcfg, v1, torch_state_dict(tcfg.model, f1), \
        torch_state_dict(tcfg.model, f2), streams


def _session(srv, streams, packed=False):
    sids = [srv.open() for _ in streams]
    for sid, s in zip(sids, streams):
        for i in range(0, len(s), 7000):
            srv.feed(sid, s[i:i + 7000])
        while (srv.tick_packed() if packed else srv.tick()):
            pass
    for sid in sids:
        srv.flush(sid)
    return [np.asarray(srv.scores(sid)) for sid in sids], srv.timeline(sids[1])


@pytest.mark.parametrize("packed", [False, True])
def test_tp_server_equals_jax_tp_server(serving, packed):
    """adpcm4, ring 8, 4 streams over a single-process (2, 2) CPU grid with
    the weights sharded over it (a tensor-parallel replica per data row),
    by tick() or the packed tick, against JAX's mesh server with TP-placed
    variables on the same bytes (1e-4); then a reload with sharded weights
    keeps the layout and matches an unsharded server on them (1e-5)."""
    jcfg, tcfg, v1, sd1, sd2, streams = serving
    jm = jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
    placed = jax.device_put(v1, jmesh.param_shardings(jm, v1, 16))
    kw = dict(max_streams=4, chunk_patches=5, transfer_dtype="adpcm4", timeline_cap=8)
    want, (wstart, wlevels) = _session(JaxServer(jcfg, placed, mesh=jm, **kw), streams)
    mesh = pmesh.make_mesh(2, 2, devices=["cpu"] * 4)
    srv = BatchedStreamingServer(tcfg, tensor.place_sharded(sd1, mesh, 16), mesh=mesh,
                                 device="cpu", **kw)
    assert srv._tp_rows is not None and len(srv.model) == 2
    assert all(tensor.layout_of(m).axis.size == 2 for m in srv.model)
    got, (start, levels) = _session(srv, streams, packed)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    assert start == wstart
    for (w, f), (jw, jf) in zip(levels, wlevels):
        np.testing.assert_allclose(w, jw, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(f, jf, rtol=1e-4, atol=1e-4)
    srv.reload_weights(tensor.place_sharded(sd2, mesh, 16))
    assert all(tensor.layout_of(m) is not None for m in srv.model)
    for sid in range(srv.S):
        if srv._bufs[sid] is not None:
            srv.close(sid)
    got2, _ = _session(srv, streams[:2], packed)
    plain = BatchedStreamingServer(tcfg, sd2, device="cpu", **kw)
    want2, _ = _session(plain, streams[:2])
    for g, w in zip(got2, want2):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_dryrun_multichip_on_the_cpu(capsys):
    """The twin of the reference's dryrun over 8 CPU grid entries, (4, 2)."""
    from mla_tpu_torch.entry import dryrun_multichip

    res = dryrun_multichip(8, device="cpu")
    assert res["mesh"] == (4, 2) and res["tensor_parallel_server"]
    assert "dryrun_multichip ok: mesh=(4,2)" in capsys.readouterr().out
