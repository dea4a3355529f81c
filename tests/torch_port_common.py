"""Shared helpers for the PyTorch port's tests (tests/test_torch_*.py): one
small configuration for both packages, JAX-initialized weights in the flat
format, and their conversion into the port's ``state_dict``.

Weights are made once by JAX ``model.init`` and perturbed with numpy, so
biases, batch-norm scales and running statistics are not at their
trivial init values; both sides then read the same arrays.

Also: the JAX package's native libraries, built for the port's tests
without a race (``reference_native``).
"""

import contextlib
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mla_tpu.config import get_config as jax_get_config
from mla_tpu.data import native as jax_ingest
from mla_tpu.models.convert import flat_to_params, params_to_flat
from mla_tpu.models.zoo import build_model as jax_build_model
from mla_tpu.serve import native_front as jax_front
from mla_tpu_torch.config import get_config as torch_get_config
from mla_tpu_torch.models.convert import flat_to_state_dict
from mla_tpu_torch.models.zoo import build_model as torch_build_model

ROOT = Path(__file__).resolve().parents[1]

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


# --- multi-process runs: ranks of tests/torch_dp_worker.py over gloo ---

RANK_TIMEOUT_S = 120  # each rank's limit: a hung collective fails the test


def launch_ranks(job, tmp_path, n=2, worker="torch_dp_worker"):
    """Run ``job`` (a dict the worker's cases read) in ``n`` ranks of
    ``tests/<worker>.py`` over a gloo group with a ``file://`` store under
    ``tmp_path`` (no ports, so no bind race); returns each rank's {case:
    result}. A rank that fails or outlives RANK_TIMEOUT_S fails the call,
    and every rank is killed."""
    import os
    import subprocess
    import sys

    import torch

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    job_path, store = tmp_path / "job.pt", tmp_path / "store"
    torch.save(job, job_path)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "JAX_COORDINATOR_ADDRESS")}
    env.update(PYTHONPATH=root, WORLD_SIZE=str(n), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"tests.{worker}", str(job_path), f"file://{store}",
         str(tmp_path / f"rank{r}.pt")],
        cwd=root, env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, bad
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(n)]


# --- the JAX package's native libraries, without the collection-time race ---
#
# The reference builds native/lib<name>.so in place, unlocked, and caches a
# failed load for the life of the process (``_LIB = False``). Under xdist
# every worker reaches those loaders while importing the test modules, so on
# a fresh tree the workers race to write and load the same files, and a
# worker that loads a half-written library keeps ``False`` for the run.

# The reference's own g++ argv (``_build_and_load`` in
# mla_tpu/serve/native_front.py and mla_tpu/data/native.py), less
# "<src> -o <lib>".
REFERENCE_GXX = ("g++", "-O3", "-std=c++17", "-fPIC", "-march=native", "-shared", "-pthread")
REFERENCE_NATIVE_DIR = ROOT / "build" / "reference_native"


@functools.lru_cache(maxsize=1)
def _gxx_target() -> str:
    """What ``-march=native`` resolves to here (a build for another CPU is
    never loaded)."""
    try:
        return subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                              capture_output=True, text=True, check=True).stdout
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the reference's native libraries cannot be "
                           "built") from e


def build_reference_native(name, src=None, out_root=None) -> Path:
    """A directory laid out as the reference's loader reads its
    ``_SRC_DIR``: ``<name>.cpp``, a copy of the unedited ``native/<name>.cpp``
    (or ``src``), and ``lib<name>.so`` built from it with ``REFERENCE_GXX``.
    One directory per hash of source, argv and target under ``out_root``
    (``REFERENCE_NATIVE_DIR``); the build runs under an exclusive ``flock``
    and lands by ``os.replace``, so no process sees a half-written file.
    Raises with g++'s output if the build fails."""
    src = Path(src or ROOT / "native" / f"{name}.cpp")
    out_root = Path(out_root or REFERENCE_NATIVE_DIR)
    code = src.read_bytes()
    digest = hashlib.sha256(code + " ".join(REFERENCE_GXX).encode()
                            + _gxx_target().encode()).hexdigest()[:16]
    out = out_root / f"{name}_{digest}"
    lib = out / f"lib{name}.so"
    out.mkdir(parents=True, exist_ok=True)
    with open(out_root / f"{name}_{digest}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            # the source first: the loader rebuilds in place if it is newer than the library
            (out / f"{name}.cpp").write_bytes(code)
            tmp = out / f"lib{name}.{os.getpid()}.so.tmp"
            proc = subprocess.run([*REFERENCE_GXX, str(out / f"{name}.cpp"), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed for {src.name} (exit {proc.returncode}):\n"
                                   f"{proc.stderr}{proc.stdout}")
            os.replace(tmp, lib)
    return out


REFERENCE_NATIVE_MODULES = {"serve_front": jax_front, "audio_ingest": jax_ingest}


@contextlib.contextmanager
def reference_native():
    """The JAX package's native front (``mla_tpu.serve.native_front``) and
    ingest library (``mla_tpu.data.native``), loaded by the reference's own
    loaders from ``build_reference_native``'s directories, whatever a
    collection-time race left in the process: each module's ``_SRC_DIR``
    points there and its cached ``_LIB`` is reset, both restored on exit.
    Yields {name: CDLL}. A failed build or load raises; nothing skips."""
    with pytest.MonkeyPatch.context() as mp:
        libs = {}
        for name, module in REFERENCE_NATIVE_MODULES.items():
            where = build_reference_native(name)
            mp.setattr(module, "_SRC_DIR", str(where))
            mp.setattr(module, "_LIB", None)
            libs[name] = module._lib()
            if libs[name] is None:
                raise RuntimeError(f"{module.__name__} did not load {where / f'lib{name}.so'}")
        yield libs


@pytest.fixture(scope="module")
def reference_native_libraries():
    """``reference_native`` for a whole test module: the reference takes its
    native wav decode, resampler and ADPCM encoders (``mla_tpu.data.audio_io``,
    ``mla_tpu.data.adpcm``) and its native front, never their fallbacks."""
    with reference_native() as libs:
        yield libs
