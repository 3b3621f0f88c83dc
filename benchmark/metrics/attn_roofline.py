"""Attention kernels' share of their roofline (``kernels/attn.json``)."""

from benchmark.metrics._roofline import share


def read(run):
    return share(run, "attn")
