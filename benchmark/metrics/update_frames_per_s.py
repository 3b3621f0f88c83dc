"""Frames over the summed ``update`` spans of the window."""


def read(run):
    t = sum(r["update"] for r in run.spans)
    return run.frames_per_iteration * len(run.spans) / t if t > 0 else None
