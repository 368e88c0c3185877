"""``sp_checksum_ms``: host ms a block in the long-stream tier's
``sp.encode.checksum`` spans (parallel/sp.py): K4 launched over the
block, in the traced requests; None where the program opens no such
span."""

from benchmark.spans import span_ms


def read(view):
    return span_ms(view, "sp.encode.checksum")
