"""The program's own spans and counters, read for the per-layer metrics.

A span is a ``torch.profiler`` range the program opens (a
``user_annotation`` record on the host); the batch tier's are
``stream.upload``, ``stream.stage``, ``stream.dispatch``,
``stream.fetch`` and ``stream.cast`` (models/stream.py).  The transfer
counters are plain ints on models/stream.py's ``_upload`` and ``_fetch``,
over the whole run; a program without them reads None.
"""

from __future__ import annotations

import sys

__all__ = ["span_ms", "stream_counters"]

STREAM = "airs_compression_tpu_torch.models.stream"


def span_ms(view, name: str) -> "float | None":
    """Host ms a batch in the spans named ``name`` that start inside the
    traced requests, or None where there is none."""
    if view is None or not view.batches:
        return None
    t = view.trace
    durs = [dur for cat, n, ts, dur in t.host
            if cat == "user_annotation" and n == name and t.t0 <= ts <= t.t1]
    if not durs:
        return None
    return sum(durs) / view.batches * 1e3


def stream_counters() -> "dict | None":
    """The batch tier's pageable bytes (uploaded and fetched) and the
    batches it encoded and decoded, or None where the program is not
    loaded or keeps no such counters."""
    mod = sys.modules.get(STREAM)
    up, fetch = getattr(mod, "_upload", None), getattr(mod, "_fetch", None)
    if not hasattr(up, "pageable_bytes") or not hasattr(
            fetch, "pageable_bytes"):
        return None
    return {"pageable_bytes": up.pageable_bytes + fetch.pageable_bytes,
            "batches": (getattr(mod, "encoded_batches", 0)
                        + getattr(mod, "decoded_batches", 0))}
