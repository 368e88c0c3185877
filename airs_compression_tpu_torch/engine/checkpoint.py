"""Checkpoint / resume of compression state.

Port of ``airs_compression_tpu/engine/checkpoint.py``.  Every AIRSPACE
block is attributable to its model chain through the (identifier,
sequence_number) header fields (reference cmp.c:265-279), so the state
needed to resume a chain mid-stream is (identifier, sequence number, model
array).  This module persists and restores it for the host
:class:`~airs_compression_tpu_torch.engine.context.CmpContext` and for the
batched :class:`~airs_compression_tpu_torch.models.stream.BatchCompressor`
/ ``BatchDecompressor``.

The ``.npz`` keys and the magic are the JAX package's, so a checkpoint
written by one package loads in the other.  A batch model that lives on
the card is written from a host copy and restored onto the object's
``device``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_context", "load_context", "save_batch_state",
           "load_batch_state"]

_MAGIC = "airs-tpu-ckpt-v1"


def save_context(ctx, path: str) -> None:
    """Persist a CmpContext's chain state to an .npz file."""
    model = ctx.model if ctx.model is not None else np.zeros(0, np.int16)
    np.savez(path, magic=_MAGIC, kind="context",
             sequence_number=ctx.sequence_number,
             identifier=ctx.identifier,
             model_size=ctx._model_size,
             model=model)


def load_context(ctx, path: str) -> None:
    """Restore chain state saved by :func:`save_context` into ``ctx``.

    The context must have been constructed with the parameters the stream
    was being produced with (the format does not embed them beyond each
    block's pass settings).
    """
    data = np.load(path, allow_pickle=False)
    if str(data["magic"]) != _MAGIC or str(data["kind"]) != "context":
        raise ValueError("not an airs-tpu context checkpoint")
    ctx.sequence_number = int(data["sequence_number"])
    ctx.identifier = int(data["identifier"])
    ctx._model_size = int(data["model_size"])
    model = data["model"]
    ctx._model = model.astype(np.int16) if model.size else None


def save_batch_state(bc, path: str) -> None:
    """Persist a BatchCompressor/BatchDecompressor's chain state."""
    state = {"magic": _MAGIC, "kind": "batch",
             "batch": bc.batch, "n_samples": bc.n_samples,
             "model": bc.model.cpu().numpy()}
    if hasattr(bc, "seq"):
        state["seq"] = np.asarray(bc.seq)
    if hasattr(bc, "identifiers"):
        state["identifiers"] = np.asarray(bc.identifiers)
    np.savez(path, **state)


def load_batch_state(bc, path: str) -> None:
    """Restore chain state saved by :func:`save_batch_state` into ``bc``
    (the model onto ``bc.device``)."""
    data = np.load(path, allow_pickle=False)
    if str(data["magic"]) != _MAGIC or str(data["kind"]) != "batch":
        raise ValueError("not an airs-tpu batch checkpoint")
    if int(data["batch"]) != bc.batch or int(data["n_samples"]) != bc.n_samples:
        raise ValueError("checkpoint shape mismatch")
    bc.model = torch.as_tensor(data["model"], dtype=torch.int32,
                               device=bc.device)
    if "seq" in data and hasattr(bc, "seq"):
        seq = data["seq"]
        bc.seq = seq.copy() if seq.shape else int(seq)
    if "identifiers" in data and hasattr(bc, "identifiers"):
        bc.identifiers = data["identifiers"].copy()
