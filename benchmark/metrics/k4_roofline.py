"""``k4_roofline``: K4 (csrc/xxh32.cu, per block) against its byte bound, in %:
the bytes its traced launches had to move (benchmark/roofline.py) over
the device's bandwidth, divided by their device time."""

from benchmark.roofline import share


def read(view):
    return share(view, "k4")
