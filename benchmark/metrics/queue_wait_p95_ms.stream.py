"""How long a chunk waited in the host queue: from the feed that made it
ready to the start of the tick's gather that took it (the program's
``mla.queue`` spans, one per chunk), 95th percentile by nearest rank, in ms."""

from benchmark import program_spans as ps


def read(run):
    return ps.p95([ps.host_ms(s) for s in ps.traced(run, "mla.queue")])
