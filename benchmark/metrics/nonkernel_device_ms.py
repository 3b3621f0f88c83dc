"""Device time of the profiled iteration outside every kernel group
(``kernels/*.json``): library products, elementwise kernels, copies, the RND
trunk, Adam."""

from benchmark.harness.trace import matches


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    patterns = [p for g in run.groups.values() for p in g["patterns"]]
    return 1e3 * sum(t for n, t in run.trace.time_by_name().items()
                     if not matches(n, patterns))
