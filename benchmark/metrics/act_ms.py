"""Median ``eavit.act`` span time: one act's host time, the frame upload and
the policy's launches.

Profiled host time, about twice the untraced time: compare it only
with the same metric read in another ``--trace 1`` run."""

from benchmark.metrics._spans import median_ms


def read(run):
    return median_ms(run, "eavit.act")
