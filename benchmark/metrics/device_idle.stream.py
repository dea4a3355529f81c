"""The share of the traced window in which nothing ran on the card: one
less the union of the profiler's device intervals over the window."""

from benchmark.tracing import idle_percent


def read(run):
    return idle_percent(run)
