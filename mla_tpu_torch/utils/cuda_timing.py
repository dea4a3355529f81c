"""Device times of short kernels on the card, with CUDA events.

``device_median_ms`` times bursts of back-to-back calls behind a spin
kernel; ``l2_cold`` rotates copies of an input so each call finds it in
device memory rather than in the L2 cache. Both need a card.
"""

from __future__ import annotations

import itertools
import statistics

import torch

SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's clock: longer than queueing a burst
L2_BYTES = 50e6  # the H100's L2 cache


def device_median_ms(fn, reps: int = 30, inner: int = 10, warmup: int = 3) -> float:
    """Median device time of one fn() call in ms: CUDA events around each of
    ``reps`` bursts of ``inner`` back-to-back calls. A spin kernel queued
    ahead of each burst holds the stream while the host queues the whole
    burst, so the events time the device's work, not the host's launch
    rate (a ~1 us kernel launched through ctypes would otherwise measure
    the host)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def l2_cold(x: torch.Tensor, offset: int = 0):
    """A function returning, on each call, the next of enough copies of x to
    fill the L2 twice, each a view that starts ``offset`` elements into its
    own buffer (so a misaligned input stays misaligned); with it, each call
    reads its input from device memory. Returns (next, number of copies)."""
    n = max(2, int(-(-2 * L2_BYTES // (x.numel() * x.element_size()))))
    copies = []
    for _ in range(n):
        buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
        view = buf[offset:].view(x.shape)
        view.copy_(x)
        copies.append(view)
    return itertools.cycle(copies).__next__, n
