"""The control comes out not correct at each cell's own size, on the card:
the reference computed in fp8 (e4m3 operands, e5m2 gradients), put in the
program's place, against the reference in f32, on three seeds. Prints each
reading, with the planted faults' where a cell has them, as one JSON line.
On the card's machine, from the root of the checkout:

    python -m pytest benchmark/tests/test_bench_control.py -m card -s
"""

import json

import pytest

from benchmark import core

MAN = core.manifest()
SEEDS = (2147483701, 2147483713, 2147483731)


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_control_fails_at_the_cells_size(cell, card):
    import torch

    files = core.cell_files(MAN, cell)
    traffic = core.load_module(files["traffic"], f"benchmark_traffic_{files['cell']['kind']}")
    limits, failed = files["cell"]["limits"], []
    for seed in SEEDS:
        run = core.Run(name=cell, seed=seed, seconds=float(MAN["run_seconds"]), trace=False,
                       device=card, cell=files["cell"], config=files["config"])
        run.cfg = core.program_config(files["config"])
        readings = traffic.control(run)
        print(json.dumps({"cell": cell, "seed": seed, "limits": limits, "readings": readings}),
              flush=True)
        failed.append(any(readings["control"][k] > lim for k, lim in limits.items()))
        torch.cuda.empty_cache()
    assert all(failed), failed
