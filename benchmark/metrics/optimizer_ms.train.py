"""The card's time of the train step's optimizer phase (clipping, the
learning rate, the Adam update and the EMA; the program's
``mla.train.optimizer`` spans): the median over the traced steps, in ms."""

from benchmark import program_spans as ps


def read(run):
    return ps.median(ps.device_ms(ps.traced(run, "mla.train.optimizer")))
