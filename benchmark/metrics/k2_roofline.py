"""``k2_roofline``: K2 (csrc/pack.cu, precomputed codes, batch rows)
against its byte bound, in %: the bytes its traced launches had to move
(benchmark/roofline_k2.py) over the device's bandwidth, divided by their
device time."""

from benchmark.roofline import share


def read(view):
    return share(view, "k2")
