"""Median kernel-launch calls inside one ``eavit.minibatch``."""

from benchmark.metrics._spans import median_launches


def read(run):
    return median_launches(run, "eavit.minibatch")
