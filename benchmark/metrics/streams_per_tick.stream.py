"""Streams folded per device tick over the window, from the tick loop's
own counters (``TickLoop.ticked_streams`` over ``TickLoop.ticks``)."""


def read(run):
    c = run.counters
    return c["ticked_streams"] / c["ticks"] if c.get("ticks") else None
