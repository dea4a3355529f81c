"""The port's device rule, shared by every entry point.

``device=None`` means the card. Without one the entry point raises rather
than run on the CPU behind the caller's back; the CPU is used only when the
caller names it (the tests pass ``device="cpu"``).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
