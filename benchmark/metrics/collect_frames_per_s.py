"""Frames over the summed ``collect`` spans of the window."""


def read(run):
    t = sum(r["collect"] for r in run.spans)
    return run.frames_per_iteration * len(run.spans) / t if t > 0 else None
