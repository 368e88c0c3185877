"""``sp_fetch_ms``: host ms a block in the long-stream tier's
``sp.encode.fetch`` spans (parallel/sp.py): the wait for the card, the
frame's bytes to the host, its header and trailer, in the traced
requests; None where the program opens no such span."""

from benchmark.spans import span_ms


def read(view):
    return span_ms(view, "sp.encode.fetch")
