"""The card's time of the train step's forward phase (augmentation, the
train-mode forward and the loss; the program's ``mla.train.forward``
spans): the median over the traced steps, in ms."""

from benchmark import program_spans as ps


def read(run):
    return ps.median(ps.device_ms(ps.traced(run, "mla.train.forward")))
