"""``sp_pageable_MiB``: MiB a block copied between the host's pageable
memory and the card by the long-stream tier (parallel/sp.py's ``_upload``
and ``_fetch``), over every block the run encoded (its
``encoded_blocks``); None where the program keeps no such counters or
the trace saw no device work."""

import sys

SP = "airs_compression_tpu_torch.parallel.sp"


def read(view):
    if view is None or not view.trace.device:
        return None
    mod = sys.modules.get(SP)
    up, fetch = getattr(mod, "_upload", None), getattr(mod, "_fetch", None)
    blocks = getattr(mod, "encoded_blocks", 0)
    if not (hasattr(up, "pageable_bytes") and hasattr(fetch, "pageable_bytes")
            and blocks):
        return None
    return (up.pageable_bytes + fetch.pageable_bytes) / blocks / 2 ** 20
