"""Process start to the first timed iteration."""


def read(run):
    return run.setup_s
