"""``sp_codes_ms``: host ms a block in the long-stream tier's
``sp.encode.codes`` spans (parallel/sp.py): the codes' lengths and the
rows' start bits, in the traced requests; None where the program opens
no such span."""

from benchmark.spans import span_ms


def read(view):
    return span_ms(view, "sp.encode.codes")
