"""``stage_ms.<cell kind>``: host ms a batch in the batch tier's
``stream.stage`` spans (models/stream.py): parsing and checking the
frame headers, in the traced requests."""

from benchmark.spans import span_ms


def read(view):
    return span_ms(view, "stream.stage")
