"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py): one
small configuration for both packages, JAX-initialized weights in the flat
format, and their conversion into the port's ``state_dict``.

Weights are made once by JAX ``model.init`` and perturbed with numpy, so
biases, batch-norm scales and running statistics are not at their
trivial init values; both sides then read the same arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np

from mla_tpu.config import get_config as jax_get_config
from mla_tpu.models.convert import flat_to_params, params_to_flat
from mla_tpu.models.zoo import build_model as jax_build_model
from mla_tpu_torch.config import get_config as torch_get_config
from mla_tpu_torch.models.convert import flat_to_state_dict
from mla_tpu_torch.models.zoo import build_model as torch_build_model

SMALL = {
    "model.conv_channels": "8,16",
    "model.convs_per_stage": 1,
    "model.embed_dim": 16,
    "model.hidden_units": 32,
    "model.n_classes": 5,
    "model.compute_dtype": "float32",
}


def configs(overrides=None, preset="streaming_inference"):
    """(jax Config, port Config) of one preset, both cut to SMALL plus
    ``overrides``."""
    ov = {**SMALL, **(overrides or {})}
    return jax_get_config(preset, ov), torch_get_config(preset, ov)


def jax_weights(jax_model_cfg, seed=0):
    """(flax variables, flat weights) for ``jax_model_cfg``, perturbed off
    their init values with a numpy generator seeded by ``seed``."""
    model = jax_build_model(jax_model_cfg)
    shape = ((1, 2, jax_model_cfg.embed_dim) if jax_model_cfg.trunk == "none"
             else (1, 2, 96, 64))
    variables = model.init(jax.random.key(seed), jnp.zeros(shape, jnp.float32))
    flat = params_to_flat(jax.tree.map(np.asarray, dict(variables["params"])), prefix="params/")
    if "batch_stats" in variables:
        flat.update(params_to_flat(jax.tree.map(np.asarray, dict(variables["batch_stats"])),
                                   prefix="batch_stats/"))
    rng = np.random.default_rng(seed + 100)
    for key, a in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("bias", "mean"):
            flat[key] = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        elif leaf in ("scale", "var"):
            flat[key] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
    tree = flat_to_params(flat)
    return {k: tree[k] for k in tree}, flat


def torch_state_dict(torch_model_cfg, flat):
    """The port's state_dict for ``torch_model_cfg`` from flat weights."""
    return flat_to_state_dict(flat, torch_build_model(torch_model_cfg, device="cpu"))


def torch_model(torch_model_cfg, flat):
    model = torch_build_model(torch_model_cfg, device="cpu")
    model.load_state_dict(flat_to_state_dict(flat, model))
    return model


def fake_summary_writer(monkeypatch):
    """Stand ``torch.utils.tensorboard`` in with a recording SummaryWriter
    (its import loads tensorflow where that is installed, ~15 s); returns
    the list of calls: ("init", log_dir), (tag, value, step), "flush",
    "close"."""
    import sys
    import types

    calls = []

    class SummaryWriter:
        def __init__(self, log_dir):
            calls.append(("init", log_dir))

        def add_scalar(self, tag, value, step):
            calls.append((tag, value, step))

        def flush(self):
            calls.append("flush")

        def close(self):
            calls.append("close")

    module = types.ModuleType("torch.utils.tensorboard")
    module.SummaryWriter = SummaryWriter
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", module)
    return calls


# --- the HTTP fronts: one request sequence sent to the port's and JAX's ---

def http_call(base, method, path, body=None, ctype="application/octet-stream", headers=None):
    """One request -> (status, JSON reply); error statuses are returned,
    not raised. Every request carries a 30 s client timeout."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", ctype)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def assert_replies_match(got, want, tol):
    """The port's reply against JAX's for one request: the same status and
    JSON keys; top-k and timeline labels equal, their numbers within
    ``tol``; every other value equal (error texts excepted)."""
    (status, obj), (want_status, want_obj) = got, want
    assert status == want_status, (got, want)
    assert sorted(obj) == sorted(want_obj), (obj, want_obj)
    for k, v in obj.items():
        w = want_obj[k]
        if k in ("top_k", "classes"):
            assert [n for n, _ in v] == [n for n, _ in w], (k, v, w)
            np.testing.assert_allclose([p for _, p in v], [p for _, p in w], **tol)
        elif k in ("weights", "probs"):
            np.testing.assert_allclose(np.asarray(v), np.asarray(w), **tol)
        elif k == "hop_s":
            np.testing.assert_allclose(v, w, rtol=1e-12)
        elif k != "error":
            assert v == w, (k, v, w)


def both(bases, method, path, body=None, ctype="application/octet-stream", headers=None,
         tol=None):
    """Send one request to the port's front (bases[0]) and then JAX's
    (bases[1]); assert their replies match; return the port's."""
    got = http_call(bases[0], method, path, body, ctype, headers)
    want = http_call(bases[1], method, path, body, ctype, headers)
    assert_replies_match(got, want, tol or dict(rtol=1e-4, atol=1e-5))
    return got
