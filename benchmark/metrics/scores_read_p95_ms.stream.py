"""A client's read of its scores once its stream has drained: the finalize
and the copy to the host, which waits for the card to reach it (the
program's ``mla.scores.read`` spans), 95th percentile by nearest rank, in ms."""

from benchmark import program_spans as ps


def read(run):
    return ps.p95([ps.host_ms(s) for s in ps.traced(run, "mla.scores.read")])
