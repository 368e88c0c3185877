"""``sp_preprocess_ms``: host ms a block in the long-stream tier's
``sp.encode.preprocess`` spans (parallel/sp.py): the IWT or MODEL
residuals, in the traced requests; None where the program opens no such
span."""

from benchmark.spans import span_ms


def read(view):
    return span_ms(view, "sp.encode.preprocess")
