"""Host waits on the card inside ``eavit.update`` in the profiled
iteration: synchronize calls and blocking copies."""

from benchmark.metrics._spans import SYNC, counts


def read(run):
    found = counts(run, "eavit.update", SYNC)
    return sum(found) if found is not None else None
