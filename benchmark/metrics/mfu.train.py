"""The whole step's share of the card's bf16 peak: the model operations of
the clips processed in the traced window (counted by the yardstick from the
configuration's shapes) over the traced window's seconds."""

from benchmark.yardstick import PEAK_BF16_FLOPS


def read(run):
    c, s = run.counters, run.tracer.summary
    if not c.get("clips_traced") or not s:
        return None
    return 100.0 * c["clips_traced"] * c["flops_per_clip"] / s["window_s"] / PEAK_BF16_FLOPS
