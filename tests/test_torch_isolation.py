"""The PyTorch port stands alone: importing every ``mla_tpu_torch`` module
loads no JAX, flax, optax or ``mla_tpu`` module, and ``chip_smoke.py`` and
``bench_torch.py`` import none of them either."""

import sys

sys.modules["conftest"].QUICK_MODULES.add(__name__.rsplit(".", 1)[-1])

import ast  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402

import pytest  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mla_tpu")

_PROBE = """
import importlib, pkgutil, sys
import mla_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mla_tpu_torch.__path__, "mla_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
print(" ".join(sorted(m for m in sys.modules if m.split(".")[0] in {forbidden!r})))
"""


def test_port_modules_import_no_jax_and_nothing_of_mla_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", _PROBE.format(forbidden=set(FORBIDDEN))],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_modules, loaded = out.stdout.splitlines()
    # every module was imported: 56 before the parallel package and the
    # context-parallel scorer (parallel/__init__.py, distributed.py, mesh.py,
    # serve/sharded.py) joined, 61 with the tensor-parallel layers
    # (parallel/tensor.py), 59 since the three kernel-timing scripts left ops/
    assert int(n_modules) >= 59
    assert loaded == ""


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", ["chip_smoke.py", "bench_torch.py", "mla_tpu_torch"])
def test_sources_name_no_forbidden_import(path):
    full = os.path.join(ROOT, path)
    files = [full] if full.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(full) for f in fs if f.endswith(".py")]
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & set(FORBIDDEN), (f, roots & set(FORBIDDEN))
