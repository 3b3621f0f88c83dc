"""``eavit.prepare_batch`` span time in the profiled iteration: rewards,
intrinsic rewards, normalisers, GAE and the RND input.

Profiled host time, about twice the untraced time: compare it only
with the same metric read in another ``--trace 1`` run."""

from benchmark.metrics._spans import total_ms


def read(run):
    return total_ms(run, "eavit.prepare_batch")
