"""The port's device rule, shared by every entry point.

``device=None`` means the card. Without one the entry point raises rather
than run on the CPU behind the caller's back; the CPU is used only when the
caller names it (the tests pass ``device="cpu"``). The TF32 policy lives
here too: the parity harness and the doctor read and pin the same flags.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

import torch


def resolve_device(device=None) -> torch.device:
    """``device=None`` is the card: bare "cuda" in a single process, and
    ``cuda:<rank_cuda_index()>`` under a launcher that sets LOCAL_RANK, so
    every rank of a process group takes its own card."""
    if device is None and "LOCAL_RANK" in os.environ and torch.cuda.is_available():
        return torch.device("cuda", rank_cuda_index())
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def rank_cuda_index() -> int:
    """The card of this process: LOCAL_RANK (0 without a launcher) modulo
    the visible cards, so ranks that outnumber the cards share them (two
    gloo ranks on one card both take cuda:0)."""
    return int(os.environ.get("LOCAL_RANK", "0")) % max(torch.cuda.device_count(), 1)


def tf32_flags() -> Dict:
    """The flags that decide whether f32 products and convolutions may
    round to TF32."""
    return {"matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}


@contextlib.contextmanager
def tf32_off():
    """f32 products and convolutions in full f32 inside, the caller's flags
    restored after."""
    precision, cudnn = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cudnn.allow_tf32 = cudnn
