"""Shared helpers of the benchmark's own tests: a cell run at a tiny size on
the CPU through the harness's own traffic drivers, and the fixture that
decides whether a card is present."""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import core  # noqa: E402
from benchmark.tracing import Tracer  # noqa: E402

# widths cut for the CPU; f32 throughout, so the program and the reference
# agree to rounding and every planted fault stands out
TINY = {"model.conv_channels": [8, 16], "model.convs_per_stage": 1, "model.embed_dim": 16,
        "model.hidden_units": 32, "model.n_classes": 7, "model.compute_dtype": "float32",
        "frontend.precision": "highest", "data.clip_seconds": 2.0}
TINY_TRAIN = {"train.frontend_precision": "highest", "train.batch_size": 4,
              "data.n_train_clips": 16}
TINY_PARAMS = {"train": {}, "tag": {"batch": 2, "pool_batches": 2, "keep_every": 1},
               "stream": {"streams": 3, "clients": 2}}


def tiny_run(cell_name: str, seconds: float = 1.0, seed: int = 3, params=None,
             trace: bool = False):
    """(run, traffic module) for ``cell_name`` at the tiny size on the CPU."""
    files = core.cell_files(core.manifest(), cell_name)
    config = copy.deepcopy(files["config"])
    cell = copy.deepcopy(files["cell"])
    cut = dict(TINY, **(TINY_TRAIN if cell["kind"] == "train" else {}))
    overrides = dict(config.get("overrides") or {})
    for path, value in cut.items():
        block, key = path.split(".")
        config.setdefault(block, {})[key] = value
        overrides[path] = ",".join(map(str, value)) if isinstance(value, list) else str(value)
    config["overrides"] = overrides
    cell["params"].update(TINY_PARAMS[cell["kind"]], **(params or {}))
    run = core.Run(name=cell_name, seed=seed, seconds=seconds, trace=trace,
                   device=torch.device("cpu"), cell=cell, config=config)
    run.cfg = core.program_config(config)
    run.tracer = Tracer() if trace else None
    return run, core.load_module(files["traffic"], f"benchmark_traffic_{cell['kind']}")


def failing(out: dict) -> list:
    """The names of the numbers over their limits, and "failed" when any
    answer never came."""
    bad = [k for k, (v, lim) in out["checks"].items() if not v <= lim]
    return bad + (["failed"] if out["failed"] else [])


@pytest.fixture
def card():
    """The card, or a skip: decided here, never while a module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
