"""Share of the profiled iteration's wall time with no device activity."""


def read(run):
    if run.trace is None or not run.trace.device or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
