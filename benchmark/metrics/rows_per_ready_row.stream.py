"""Patch rows the tick's step computed per row that was ready: the sums
over the traced part's ticks of the program's ``mla.tick`` counts ``rows``
(the patch rows the server's step computed, by its own ``patch_rows``
count) over ``ready_rows`` (the ready streams' chunks)."""

from benchmark import program_spans as ps


def read(run):
    ticks = ps.traced(run, "mla.tick")
    ready = sum(s.attrs["ready_rows"] for s in ticks)
    return sum(s.attrs["rows"] for s in ticks) / ready if ready else None
