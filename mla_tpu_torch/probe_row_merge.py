"""Row-merge capability probe, the port of ``scripts/probe_mosaic_reshape.py``:

    python -m mla_tpu_torch.probe_row_merge

On the TPU the question was whether the compiler accepts an in-kernel
row-merge reshape [960, 160] -> [320, 480]. On the card both of the probe's
kernels are hand-written CUDA (``ops/row_merge.py``): the control ``x * 2``
and the row merge. Prints one JSON line with the reference's keys:
``row_merge_reshape_supported``, ``control_kernel_ok``, ``verdict``,
``platform`` (the torch device type), ``error``, ``control_error``.

A kernel that fails to build or launch raises; ``error`` and
``control_error`` report only a result that differs from the expected one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from mla_tpu_torch._device import resolve_device
from mla_tpu_torch.ops.row_merge import row_merge, scale2

SHAPE = (960, 160)
ROWS = 3  # 3 rows -> 1: [960, 160] -> [320, 480]


def probe(device=None) -> dict:
    """Run both kernels once on ``device`` (None = the card; raises without
    one unless device="cpu", which takes the plain versions)."""
    dev = resolve_device(device)
    x = np.arange(SHAPE[0] * SHAPE[1], dtype=np.float32).reshape(SHAPE)
    xt = torch.from_numpy(x).to(dev)
    control_ok = bool(np.array_equal(scale2(xt).cpu().numpy(), x * 2.0))
    merged = row_merge(xt, ROWS).cpu().numpy()
    ok = bool(np.array_equal(merged, x.reshape(SHAPE[0] // ROWS, ROWS * SHAPE[1])))
    return {
        "row_merge_reshape_supported": ok,
        "control_kernel_ok": control_ok,
        "verdict": ("genuine-reject" if control_ok and not ok
                    else "supported" if ok
                    else "inconclusive-compiler-unreachable"),
        "platform": dev.type,
        "error": None if ok else "ran but produced wrong values",
        "control_error": None if control_ok else "ran but produced wrong values",
    }


def main(device=None) -> int:
    print(json.dumps(probe(device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
