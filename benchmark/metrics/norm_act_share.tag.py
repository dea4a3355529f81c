"""The trunk's norm + activation share of the tag forward's device time:
100 x the card's time of the program's ``mla.trunk.norm_act`` spans (each
block's norm and ReLU) inside the traced forwards over that of the
forwards themselves (``mla.forward``), in %."""

from benchmark import program_spans as ps


def read(run):
    forwards = ps.traced(run, "mla.forward")
    whole = sum(ps.device_ms(forwards))
    if whole <= 0:
        return None
    return 100.0 * sum(ps.device_ms(ps.children(run, forwards, "mla.trunk.norm_act"))) / whole
