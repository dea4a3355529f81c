"""The numbers that decide ``correct``: each is a gap between what the
program produced and what the reference works out from the same weights and
inputs. Each workload file holds the limit of each of its numbers, and
PERF.md the readings they were set from."""

from __future__ import annotations

import statistics
from typing import Mapping, Sequence

import torch

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone (e.g. an attention gate's bias, which
# the softmax over time cancels): its change is not compared
QUIET_LEAF = 1e-3


def max_abs_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The widest gap between two tensors of probabilities or scores; a
    non-finite value of the program's reads as an infinite gap."""
    d = (program.float().to(reference.device) - reference.float()).abs()
    return float("inf") if not bool(torch.isfinite(d).all()) else float(d.max())


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    """The largest relative gap of one step's loss."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(program, reference)]
    return max(gaps) if all(g == g for g in gaps) else float("inf")


def norm_gap(program: Mapping[str, float], reference: Mapping[str, float],
             leaves: Sequence[str]) -> tuple:
    """(gap, leaf): the worst leaf's gap between the program's norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's."""
    med = statistics.median(reference[k] for k in leaves)
    worst, leaf = 0.0, None
    for k in leaves:
        a = program.get(k, float("nan"))
        g = abs(a - reference[k]) / max(reference[k], med)
        if g != g:
            return float("inf"), k
        if g > worst:
            worst, leaf = g, k
    return worst, leaf


def train_gaps(program: Mapping, reference: Mapping) -> dict:
    """The training cell's numbers: the first step's loss and every step's
    (the largest relative gap), the first gradient's norm (as the optimizer
    took it) and the change of the parameters after the steps, both by the
    worst leaf."""
    leaves = sorted(reference["grad_norms"])
    med = statistics.median(reference["grad_norms"][k] for k in leaves)
    moving = [k for k in leaves if reference["grad_norms"][k] >= QUIET_LEAF * med]
    grad, grad_leaf = norm_gap(program["grad_norms"], reference["grad_norms"], leaves)
    change, change_leaf = norm_gap(program["change_norms"], reference["change_norms"], moving)
    return {"loss1_gap": loss_gap(program["losses"][:1], reference["losses"][:1]),
            "loss_gap": loss_gap(program["losses"], reference["losses"]),
            "grad_gap": grad, "change_gap": change,
            "worst": {"grad": grad_leaf, "change": change_leaf},
            "quiet_leaves": sorted(set(leaves) - set(moving))}
