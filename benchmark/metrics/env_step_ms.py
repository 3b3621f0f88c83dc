"""Summed ``eavit.env_step`` span time in the profiled iteration: the host
fleet's steps, or the launches of the device env's steps.

Profiled host time, about twice the untraced time: compare it only
with the same metric read in another ``--trace 1`` run."""

from benchmark.metrics._spans import total_ms


def read(run):
    return total_ms(run, "eavit.env_step")
