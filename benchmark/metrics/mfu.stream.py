"""The served work's share of the card's bf16 peak while it was busy: the
model operations of the ready rows folded in the traced window (their
patches through front-end, trunk and heads, and one tail each) over the
card's busy seconds there. The served load is fixed by real time, so a
share of the window could never move; a share of the busy time does."""

from benchmark.yardstick import PEAK_BF16_FLOPS


def read(run):
    c, s = run.counters, run.tracer.summary
    if not c.get("traced_rows") or not s or s["busy_s"] <= 0:
        return None
    return 100.0 * c["traced_rows"] * c["row_flops"] / s["busy_s"] / PEAK_BF16_FLOPS
