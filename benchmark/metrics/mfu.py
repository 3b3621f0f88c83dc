"""The iteration's model operations (``work/``: acts, RND passes, the
update's forward and backward, nothing recomputed) times the window's
iterations over the window's time over the bf16 peak."""

from benchmark.harness.peaks import PEAK_FLOPS


def read(run):
    if run.window_s <= 0:
        return None
    return 100.0 * run.model_flops * run.iterations / run.window_s / PEAK_FLOPS
