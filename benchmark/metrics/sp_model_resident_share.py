"""``sp_model_resident_share``: the share of the MODEL blocks that
parallel/sp.py's ``LongStreamCompressor`` encoded whose model was already
an int32 tensor on the encode's device when the block began (its
``model_resident_blocks`` over ``model_blocks``), over every block the run
encoded; None where the program keeps no such counters or encoded no
MODEL block."""

import sys

SP = "airs_compression_tpu_torch.parallel.sp"


def read(view):
    mod = sys.modules.get(SP)
    blocks = getattr(mod, "model_blocks", 0)
    resident = getattr(mod, "model_resident_blocks", None)
    if not blocks or resident is None:
        return None
    return resident / blocks
