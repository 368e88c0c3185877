"""``adapt_codes_ms``: host ms a batch in the adaptive tier's
``adapt.codewords`` spans (ops/adapt.py): the codewords under each
block's chosen parameter, in the traced requests; None where the program
opens no such span."""

from benchmark.spans import span_ms


def read(view):
    return span_ms(view, "adapt.codewords")
