"""``adapt_select_ms``: host ms a batch in the adaptive tier's
``adapt.select`` spans (ops/adapt.py): each block's Golomb parameter
chosen, in the traced requests; None where the program opens no such
span."""

from benchmark.spans import span_ms


def read(view):
    return span_ms(view, "adapt.select")
