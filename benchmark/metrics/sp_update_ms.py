"""``sp_update_ms``: host ms a block in the long-stream tier's
``sp.chain.update`` spans (parallel/sp.py): LongStreamCompressor's model
update, its uploads and its int32 fetch, in the traced requests; None
where the program opens no such span."""

from benchmark.spans import span_ms


def read(view):
    return span_ms(view, "sp.chain.update")
