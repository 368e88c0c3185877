"""``upload_ms.<cell kind>``: host ms a batch in the batch tier's
``stream.upload`` spans (models/stream.py): staging the samples or the
stream and copying them to the card, in the traced requests."""

from benchmark.spans import span_ms


def read(view):
    return span_ms(view, "stream.upload")
