"""``cast_ms.<cell kind>``: host ms a batch in the batch tier's
``stream.cast`` spans (models/stream.py): the decoded samples cast to
u16, in the traced requests."""

from benchmark.spans import span_ms


def read(view):
    return span_ms(view, "stream.cast")
