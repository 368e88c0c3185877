"""``sp_pack_ms``: host ms a block in the long-stream tier's
``sp.encode.pack`` spans (parallel/sp.py): the frame's word buffer
cleared and K1 launched, in the traced requests; None where the program
opens no such span."""

from benchmark.spans import span_ms


def read(view):
    return span_ms(view, "sp.encode.pack")
