"""No benchmark process loads JAX or the JAX package, the reference loads
nothing of the program, and a run without its card prints no result."""

import ast
import subprocess
import sys
import textwrap

import pytest

from benchmark import core

REFERENCE_IMPORTS = {"__future__", "contextlib", "math", "statistics", "typing", "numpy",
                     "torch"}


def _imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    return names


@pytest.mark.parametrize("name", ["model.py", "compare.py", "__init__.py"])
def test_reference_imports_torch_and_numpy_only(name):
    assert _imports(core.BENCH / "reference" / name) <= REFERENCE_IMPORTS


def test_forbidden_names_compare_whole():
    loaded = {"mla_tpu_torch", "mla_tpu_torch.serve", "jaxtyping"}
    bad = set(core.FORBIDDEN)
    assert not ({m.split(".")[0] for m in loaded} & bad)
    assert {m.split(".")[0] for m in {"mla_tpu.ops", "jax.numpy"}} & bad == {"mla_tpu", "jax"}


def _python(code: str, timeout: int = 300) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=core.ROOT,
                          capture_output=True, text=True, timeout=timeout)


def test_reference_alone_loads_nothing_of_the_program():
    p = _python("""
        import sys
        import benchmark.reference.model, benchmark.reference.compare
        print(sorted({m.split('.')[0] for m in sys.modules} & {'mla_tpu_torch', 'mla_tpu', 'jax'}))
    """)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_of_every_traffic_kind_loads_no_jax():
    """Every module a run loads (the harness, each traffic driver run at the
    tiny size, every reader): mla_tpu_torch is in, jax and mla_tpu are not."""
    p = _python("""
        import sys
        sys.path.insert(0, 'benchmark/tests')
        from conftest import tiny_run
        from benchmark import core
        man = core.manifest()
        for cell in ('audioset-tag-b128', 'audioset-train-b256', 'stream-int16-s256-c5'):
            run, traffic = tiny_run(cell, seconds=0.5, params={'chunk_patches': 1}
                                    if cell.startswith('stream') else None)
            traffic.run(run)
            for m in core.metrics_of(man, cell)['per_layer']:
                core.load_module(core.BENCH / 'metrics' / (m['name'] + '.py'), 'r_' + m['name'])
        print('mla_tpu_torch' in sys.modules, core.forbidden_loaded())
    """, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "True []"


def test_run_without_a_card_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "audioset-tag-b128",
                        "--seed", "2147483659", "--seconds", "1", "--trace", "0"], cwd=core.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
