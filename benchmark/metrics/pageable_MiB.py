"""``pageable_MiB.<cell kind>``: MiB a batch copied between the host's
pageable memory and the card by the batch tier (models/stream.py's
``_upload`` and ``_fetch``), over every batch the run encoded or decoded;
None where the program keeps no such counters or the trace saw no device
work."""

from benchmark.spans import stream_counters


def read(view):
    if view is None or not view.trace.device:
        return None
    c = stream_counters()
    if c is None or not c["batches"]:
        return None
    return c["pageable_bytes"] / c["batches"] / 2 ** 20
