"""Env frames collected and learned from per second of the window."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 else None
