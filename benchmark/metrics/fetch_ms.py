"""``fetch_ms.<cell kind>``: host ms a batch in the batch tier's
``stream.fetch`` spans (models/stream.py): the copies to the host, with
the wait for the device work queued before them and the checks that read
them, in the traced requests."""

from benchmark.spans import span_ms


def read(view):
    return span_ms(view, "stream.fetch")
