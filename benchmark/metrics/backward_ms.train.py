"""The card's time of the train step's backward phase (the program's
``mla.train.backward`` spans): the median over the traced steps, in ms."""

from benchmark import program_spans as ps


def read(run):
    return ps.median(ps.device_ms(ps.traced(run, "mla.train.backward")))
