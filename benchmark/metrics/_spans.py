"""The program's own spans (``eavit_tpu_torch/utils/trace.py``, host ranges
named ``eavit.*``) in the profiled iteration, and the CUDA runtime calls
under them.

A span's launches and syncs are the runtime calls that start within its
host interval, matched by time and not by thread: the autograd engine
launches the backward from its own thread while the main thread sits in
``eavit.backward``. Host times read in the profiled iteration are inflated
by the profiler (about twice, with about 10 us for each open span), as
``idle_share`` is, so a span time compares only with another ``--trace 1``
reading of the same metric; counts are not inflated.
"""

from __future__ import annotations

import bisect
import statistics
from typing import List, Optional

from benchmark.harness.trace import Interval, matches

LAUNCH = ("cudaLaunchKernel*", "cuLaunchKernel*", "cudaLaunchCooperativeKernel*")
# host waits on the card: the synchronize calls and the blocking copies
SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
        "cudaMemcpy", "cudaMemcpy2D", "cudaMemcpy3D", "cudaMemcpyPeer",
        "cudaMemcpyToSymbol", "cudaMemcpyFromSymbol")
RUNTIME = ("cuda[A-Z]*", "cu[A-Z]*")


def spans(run, name: str) -> List[Interval]:
    """The spans ``name`` inside the profiled iteration's window."""
    if run.trace is None:
        return []
    a, b = run.trace.window
    return [h for h in run.trace.host if h.name == name and h.start >= a and h.end <= b]


def total_ms(run, name: str) -> Optional[float]:
    """The summed time of the spans ``name`` in the profiled iteration."""
    found = spans(run, name)
    return 1e3 * sum(s.end - s.start for s in found) if found else None


def median_ms(run, name: str) -> Optional[float]:
    found = spans(run, name)
    return 1e3 * statistics.median(s.end - s.start for s in found) if found else None


def _starts(run, patterns) -> Optional[List[float]]:
    """The sorted start times of the runtime calls matching ``patterns``
    in the window; None where the trace holds no CUDA runtime call at all
    (a run on the CPU)."""
    a, b = run.trace.window
    runtime = [h for h in run.trace.host if a <= h.start <= b and matches(h.name, RUNTIME)]
    if not runtime:
        return None
    return sorted(h.start for h in runtime if matches(h.name, patterns))


def counts(run, name: str, patterns) -> Optional[List[int]]:
    """For each span ``name``, the runtime calls matching ``patterns`` that
    start within it; None where there is no such span or no runtime call."""
    found = spans(run, name)
    starts = _starts(run, patterns) if found else None
    if starts is None:
        return None
    return [bisect.bisect_left(starts, s.end) - bisect.bisect_left(starts, s.start)
            for s in found]


def median_launches(run, name: str) -> Optional[float]:
    """The median number of kernel-launch calls inside one span ``name``."""
    found = counts(run, name, LAUNCH)
    return statistics.median(found) if found else None
