"""``adapt_candidates``: candidate parameters costed a block by the
adaptive tier's choice (ops/adapt.py's ``costed_candidates`` over its
``selected_blocks``), over every block the run chose for; None where the
program keeps no such counters or chose for no block."""

import sys

ADAPT = "airs_compression_tpu_torch.ops.adapt"


def read(view):
    mod = sys.modules.get(ADAPT)
    blocks = getattr(mod, "selected_blocks", 0)
    costed = getattr(mod, "costed_candidates", None)
    if not blocks or costed is None:
        return None
    return costed / blocks
