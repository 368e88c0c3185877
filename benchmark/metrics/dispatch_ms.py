"""``dispatch_ms.<cell kind>``: host ms a batch in the batch tier's
``stream.dispatch`` spans (models/stream.py): launching the device work,
with its small index uploads, in the traced requests."""

from benchmark.spans import span_ms


def read(view):
    return span_ms(view, "stream.dispatch")
