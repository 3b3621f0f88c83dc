"""FFN kernels' share of their roofline (``kernels/ffn.json``)."""

from benchmark.metrics._roofline import share


def read(run):
    return share(run, "ffn")
