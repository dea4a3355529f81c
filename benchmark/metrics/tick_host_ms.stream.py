"""The tick thread's host time per tick, from the gather's start to the
step's assignment (the program's ``mla.tick`` spans): the median, in ms."""

from benchmark import program_spans as ps


def read(run):
    return ps.median([ps.host_ms(s) for s in ps.traced(run, "mla.tick")])
