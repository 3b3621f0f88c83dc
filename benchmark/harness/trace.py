"""Reading one profiled iteration: device intervals, busy time, idle gaps.

The profiler (``torch.profiler``, CPU and CUDA activities) records every
device activity (kernels, copies, fills) with its start and end, and the
host's operations and the benchmark's own annotations (``collect``,
``update``, ``readback``). The traced window is the profiled iteration: from
the start of its ``collect`` annotation to the end of its ``readback``.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

SPANS = ("collect", "update", "readback")


@dataclass
class Interval:
    name: str
    start: float  # seconds
    end: float


@dataclass
class Trace:
    window: Tuple[float, float]
    device: List[Interval]  # device activities inside the window
    host: List[Interval] = field(default_factory=list)  # host operations
    spans: List[Interval] = field(default_factory=list)  # the benchmark's annotations

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, in order."""
        out: List[Tuple[float, float]] = []
        for iv in sorted(self.device, key=lambda i: i.start):
            if out and iv.start <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], iv.end))
            else:
                out.append((iv.start, iv.end))
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def time_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for iv in self.device:
            out[iv.name] = out.get(iv.name, 0.0) + (iv.end - iv.start)
        return out

    def group_time(self, patterns: Sequence[str]) -> float:
        return sum(t for n, t in self.time_by_name().items() if matches(n, patterns))

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The ``top`` longest stretches of the window with no device
        activity, named by the benchmark's span and the innermost host
        operation over their middle."""
        edges = [self.window[0]]
        for s, e in self.busy():
            edges += [s, e]
        edges.append(self.window[1])
        gaps = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                      key=lambda g: g[0] - g[1])[:top]
        return [(self._host_at((a + b) / 2), b - a) for a, b in gaps]

    def _host_at(self, t: float) -> str:
        span = next((s.name for s in self.spans if s.start <= t <= s.end), "driver")
        inner = [h for h in self.host if h.start <= t <= h.end]
        if not inner:
            return span
        return f"{span}/{min(inner, key=lambda h: h.end - h.start).name}"


def matches(name: str, patterns: Sequence[str]) -> bool:
    return any(fnmatch.fnmatchcase(name, p) for p in patterns)


def from_profiler(prof) -> Trace:
    """The profiled iteration of a finished ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    on_device, host, spans, annotations = [], [], [], set()
    for ev in events:
        iv = Interval(ev.name(), ev.start_ns() * 1e-9, ev.end_ns() * 1e-9)
        if ev.device_type().name == "CUDA":
            on_device.append((iv, ev.is_user_annotation()))
        elif iv.name in SPANS:
            spans.append(iv)
        else:
            host.append(iv)
            if ev.is_user_annotation():
                annotations.add(iv.name)
    # kernels, copies and fills; not the host's annotations (ours and the
    # optimizer's), which the profiler mirrors onto the device's timeline
    device = [iv for iv, ann in on_device
              if not ann and iv.name not in annotations and iv.name not in SPANS]
    starts = [s.start for s in spans if s.name == "collect"]
    ends = [s.end for s in spans if s.name == "readback"]
    if not starts or not ends:
        raise RuntimeError("the profiled iteration has no collect/readback annotation")
    window = (min(starts), max(ends))
    inside = [Interval(d.name, max(d.start, window[0]), min(d.end, window[1]))
              for d in device if d.end > window[0] and d.start < window[1]]
    return Trace(window, inside, host, spans)
