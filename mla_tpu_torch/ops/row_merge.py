"""The row-merge probe's kernels (``csrc/row_merge.cu``), ports of the
Pallas kernels in ``scripts/probe_mosaic_reshape.py``:

  ``scale2(x)``           ``control_kernel``: x * 2;
  ``row_merge(x, rows)``  ``kernel``: the row-merge reshape
                          [R, C] -> [R / rows, rows * C], with
                          out[r, j * C + c] = x[rows * r + j, c].

``row_merge`` has two kernels, chosen by ``row_merge_variant`` from the shape
and the two pointers: ``row_merge_bulk`` (TMA bulk copies, which need 16-byte
alignment) and ``row_merge_generic`` (one element per thread) for the rest.

Each wrapper launches its kernel for a CUDA tensor (or raises) and takes its
plain torch version (``scale2_reference``, ``row_merge_reference``) only for
a CPU tensor. ``LAUNCHES`` counts kernel launches per kernel and variant.
"""

from __future__ import annotations

import ctypes

import torch

from mla_tpu_torch.ops import _build

# kernel launches, for showing a run went through them
LAUNCHES = {"scale2": 0, "row_merge_bulk": 0, "row_merge_generic": 0}

_P, _L = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {"mla_scale2": [_P, _P, _L, _P],
               "mla_row_merge_bulk": [_P, _P, _L, _L, _L, _P],
               "mla_row_merge_generic": [_P, _P, _L, _L, _L, _P]}


def _check(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if x.numel() == 0:
        raise ValueError(f"{name}: x is empty")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, got {x.device}")


def _launch(fn: str, x: torch.Tensor, out: torch.Tensor, *sizes: int) -> None:
    lib = _build.load("row_merge", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn)(x.data_ptr(), out.data_ptr(), *sizes, stream)
    if err != 0:
        raise RuntimeError(f"{fn} kernel launch failed: cudaError {err}")


def scale2_reference(x: torch.Tensor) -> torch.Tensor:
    """The control kernel's plain torch version: x * 2."""
    return x * 2.0


def scale2(x: torch.Tensor) -> torch.Tensor:
    """x * 2 for a float32 tensor of any shape."""
    _check(x, "scale2")
    if x.device.type == "cpu":
        return scale2_reference(x)
    out = torch.empty_like(x)
    _launch("mla_scale2", x, out, x.numel())
    LAUNCHES["scale2"] += 1
    return out


def _merged_shape(x: torch.Tensor, rows: int):
    if x.dim() != 2:
        raise ValueError(f"row_merge: x must be [R, C], got shape {tuple(x.shape)}")
    r, c = x.shape
    if rows < 1 or r % rows:
        raise ValueError(f"row_merge: R = {r} is not a multiple of rows = {rows}")
    return r // rows, rows * c


def row_merge_variant(shape, rows: int, x_ptr: int, out_ptr: int) -> str:
    """Which kernel merges a [R, C] float32 buffer at ``x_ptr`` into
    ``out_ptr``: "bulk" when every bulk copy can be 16-byte aligned (a source
    row of C * 4 bytes, hence also an output row of rows * C * 4, is a
    multiple of 16, and both buffers start on a 16-byte boundary), else
    "generic"."""
    _, c = shape
    aligned = (4 * c) % 16 == 0 and (4 * rows * c) % 16 == 0
    return "bulk" if aligned and x_ptr % 16 == 0 and out_ptr % 16 == 0 else "generic"


def row_merge_reference(x: torch.Tensor, rows: int) -> torch.Tensor:
    """The row-merge kernel's plain torch version: a reshape, copied."""
    return x.reshape(_merged_shape(x, rows)).clone()


def row_merge(x: torch.Tensor, rows: int) -> torch.Tensor:
    """[R, C] float32 -> [R / rows, rows * C]: every ``rows`` consecutive
    rows merged into one."""
    _check(x, "row_merge")
    shape = _merged_shape(x, rows)
    if x.device.type == "cpu":
        return row_merge_reference(x, rows)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    variant = row_merge_variant(x.shape, rows, x.data_ptr(), out.data_ptr())
    _launch(f"mla_row_merge_{variant}", x, out, x.shape[0], x.shape[1], rows)
    LAUNCHES[f"row_merge_{variant}"] += 1
    return out


def bytes_moved(x: torch.Tensor) -> int:
    """Device-memory traffic either kernel must make (roofline denominator):
    the input read once and the output, of the same size, written once."""
    return 2 * x.numel() * x.element_size()
