"""``sp_upload_ms``: host ms a block in the long-stream tier's
``sp.encode.upload`` spans (parallel/sp.py): the samples, and a MODEL
pass's model, copied to the card, in the traced requests; None where the
program opens no such span."""

from benchmark.spans import span_ms


def read(view):
    return span_ms(view, "sp.encode.upload")
