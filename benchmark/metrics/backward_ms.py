"""Summed ``eavit.backward`` span time in the profiled iteration.

Profiled host time, about twice the untraced time: compare it only
with the same metric read in another ``--trace 1`` run."""

from benchmark.metrics._spans import total_ms


def read(run):
    return total_ms(run, "eavit.backward")
