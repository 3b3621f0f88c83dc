"""The roofline share of a group of kernels in the profiled iteration:
the least time the card could take for the group's work (the larger of its
operations over the peak rate and its bytes over the peak bandwidth) over
the group's summed device time."""

from __future__ import annotations

from typing import Optional

from benchmark.harness.peaks import PEAK_BYTES, PEAK_FLOPS


def share(run, group: str) -> Optional[float]:
    if run.trace is None:
        return None
    spec = run.groups[group]
    busy = run.trace.group_time(spec["patterns"])
    flops, nbytes = run.work.get(spec["work"], (0.0, 0.0))
    if busy <= 0.0 or flops <= 0.0:
        return None
    return 100.0 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) / busy
