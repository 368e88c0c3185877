"""Chunked whole-file compression through the device pipeline.

Port of ``airs_compression_tpu/models/chunked.py``.  The reference CLI
compresses each input file as ONE block through one context
(programs/airspacecli.c:148-191, programs/file.c:435-488), which caps a file
at the 2^24-1-byte header field (lib/cmp_header.h:19).  This module extends
that to arbitrarily large inputs: the sample stream is split into
fixed-size chunks, each chunk becomes an ordinary self-delimiting AIRSPACE
block, and batches of chunks are encoded in parallel on the device
(models/stream.BatchCompressor, the packed stream of kernel K5).  The
output is a plain concatenated AIRSPACE stream — exactly what the reference
CLI produces for a file *list* — so any format decoder reassembles the
original stream.

Byte parity: with the same chunk grid, the output is bit-identical to
feeding the chunks through one host ``CmpContext`` sequentially (the
reference's one-context-per-file-list semantics): every chunk runs a
primary pass with a fresh identifier drawn in block order, including the
context-initialisation draw (cmp.c:203-208).  One caveat: when a block
falls back to uncompressed, its two extra identifier draws (cmp.c:380-392)
happen after the whole batch's primary draws rather than interleaved, so
identifier *values* (timestamps in production) can differ from a strictly
sequential host run on fallback-heavy data — the coding bytes never do.

``device`` (default ``"cuda"``) goes to every ``BatchCompressor`` and
``BatchDecompressor``; without CUDA it raises, and ``device="cpu"`` runs
the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np

from .. import _build
from ..engine.context import CmpContext
from ..engine.decode import DecoderState
from ..engine.host import decode_block
from ..format.dtypes import CmpType
from ..format.errors import CmpError, CmpErrorCode
from ..format.header import CmpHeader
from ..format.params import CmpParams, Preprocessing
from .stream import BatchCompressor, BatchDecompressor

__all__ = ["compress_chunked", "decompress_chunked",
           "DEFAULT_CHUNK_SAMPLES", "DEFAULT_BATCH",
           "DEVICE_STAGED_MIN_BYTES"]

# 8192 samples a block keeps the per-block header overhead at 0.13 %;
# 2048 blocks a device call = 32 MiB of samples a batch.
DEFAULT_CHUNK_SAMPLES = 8192
DEFAULT_BATCH = 2048


def compress_chunked(params: CmpParams, samples_u16,
                     chunk_samples: int = DEFAULT_CHUNK_SAMPLES,
                     batch: int = DEFAULT_BATCH,
                     compressor_cls=BatchCompressor,
                     device="cuda") -> bytes:
    """Compress one long u16 sample stream as concatenated AIRSPACE blocks.

    Chunks are independent primary-pass blocks (a chunk grid has no frame
    repetition, so model chains do not apply); ``params`` must therefore
    not request secondary iterations.  Full-size chunks are encoded on
    ``device``, ``batch`` at a time, each batch assembled into one packed
    stream on the device (``compress_frames_packed``); the tail remainder
    goes through the host context.  ``compressor_cls`` is called as
    ``compressor_cls(params, b, chunk_samples, device=device)``; a class
    without ``compress_frames_packed`` gives its ``compress_frames`` list
    instead.  Returns the concatenated stream.
    """
    device = _build.resolve_device(device)
    params.validate()
    if params.secondary_iterations:
        raise CmpError(
            CmpErrorCode.PARAMS_INVALID,
            "chunked file compression uses independent primary blocks; "
            "model chains across chunks are not meaningful")
    x = np.ascontiguousarray(np.asarray(samples_u16, dtype=np.uint16))
    n = x.size
    if n == 0:
        raise CmpError(CmpErrorCode.SRC_SIZE_WRONG, "empty input")
    if 2 * chunk_samples > (1 << 24) - 1:
        raise CmpError(CmpErrorCode.HDR_ORIGINAL_TOO_LARGE,
                       "chunk exceeds the 24-bit original_size field")

    # Create the host context FIRST: its initialisation identifier draw
    # (cmp.c:203-208) lands in the same slot as the reference one-context
    # run's, keeping the whole stream bit-identical; each chunk then draws
    # one identifier in block order (batched blocks inside
    # BatchCompressor, the tail inside compress_u16's engine reset).
    tail_ctx = CmpContext(params)

    n_full = n // chunk_samples
    out: "list" = []
    pos = 0
    i = 0
    while i < n_full:
        b = min(batch, n_full - i)
        bc = compressor_cls(params, b, chunk_samples, device=device)
        frames = x[pos: pos + b * chunk_samples].reshape(b, chunk_samples)
        if hasattr(bc, "compress_frames_packed"):
            out.append(bc.compress_frames_packed(frames, as_array=True)[0])
        else:  # a compressor that returns a list of frames
            out.extend(bc.compress_frames(frames))
        pos += b * chunk_samples
        i += b
    if pos < n:  # remainder block via the host codec
        out.append(tail_ctx.compress_u16(x[pos:]))
    return b"".join(memoryview(p) if isinstance(p, np.ndarray) else p
                    for p in out)


#: streams at least this large decode via the device-staged tier (the
#: compressed bytes upload once; the rows are gathered on the device) —
#: below it, the one-off upload dominates
DEVICE_STAGED_MIN_BYTES = 1 << 20


def decompress_chunked(stream: bytes, cmp_type: CmpType = CmpType.U16,
                       batch: int = DEFAULT_BATCH,
                       verify_checksum: bool = True,
                       device_staged: "bool | None" = None,
                       device="cuda") -> np.ndarray:
    """Decompress a concatenated AIRSPACE stream through the device decoder.

    The device-side counterpart of :func:`compress_chunked` — and the
    capability the reference CLI stubs out entirely
    (programs/airspacecli.c:421-423).  Headers are scanned host-side (each
    block is self-delimiting via ``compressed_size``); maximal runs of at
    most ``batch`` same-length blocks that carry no model-chain dependency
    (preprocessing != MODEL — the only method whose decode consumes prior
    state) are decoded on ``device`` by the header-driven batch decoder
    (models/stream.BatchDecompressor), each run at its own length;
    everything else decodes through the sequential host path with exact
    chain-state bookkeeping (engine/decode.DecoderState).  Output is the
    concatenated u16 sample stream, byte-identical to the host decoder's.
    """
    device = _build.resolve_device(device)
    n_total = len(stream)
    blocks: "list[tuple[int, CmpHeader]]" = []  # (offset, header)
    offset = 0
    while offset < n_total:
        hdr, hsz = CmpHeader.deserialize(stream[offset: offset + 22])
        if hdr.compressed_size < hsz:
            raise CmpError(CmpErrorCode.INT_HDR, "compressed_size inconsistent")
        if offset + hdr.compressed_size > n_total:
            raise CmpError(CmpErrorCode.INT_HDR, "truncated stream")
        blocks.append((offset, hdr))
        offset += hdr.compressed_size

    def eligible(h: CmpHeader) -> bool:
        return (h.preprocessing != int(Preprocessing.MODEL)
                and h.original_size > 0 and h.original_size % 2 == 0)

    out_parts: "list[np.ndarray | None]" = [None] * len(blocks)
    state = DecoderState(cmp_type)
    decoders: "dict[tuple[int, int], BatchDecompressor]" = {}
    if device_staged is None:
        device_staged = n_total >= DEVICE_STAGED_MIN_BYTES
    ds = None  # DeviceStream, uploaded lazily on the first device run

    # one-run-deep pipeline: a device run's finish (the only host sync)
    # is deferred until the NEXT run has been staged and dispatched, so
    # staging overlaps the in-flight decode; host-path blocks drain the
    # pipeline first because they consume chain state in block order
    pending = None

    def _flush() -> None:
        nonlocal pending
        if pending is None:
            return
        i0, j0, bd_p, st_p, dec_p = pending
        pending = None
        decoded = bd_p.finish(st_p, dec_p)
        for k, (_o, h) in enumerate(blocks[i0:j0]):
            samples = decoded[k]
            state.update_after_block(h, samples)
            out_parts[i0 + k] = samples

    i = 0
    while i < len(blocks):
        h0 = blocks[i][1]
        j = i
        while (j < len(blocks) and eligible(blocks[j][1])
               and blocks[j][1].original_size == h0.original_size
               and j - i < batch):
            j += 1
        if j - i >= 2:  # a device-worthy run of uniform independent blocks
            n_samples = h0.original_size // 2
            n_run = j - i
            # staged straight from the stream buffer by (offset, length)
            offs = np.fromiter(
                (blocks[k][0] for k in range(i, j)), np.int64, count=n_run)
            lens = np.fromiter(
                (blocks[k][1].compressed_size for k in range(i, j)),
                np.int64, count=n_run)
            bd = decoders.get((n_run, n_samples))
            if bd is None:
                # params only steer model bookkeeping, which these
                # chain-free blocks don't use; decode is header-driven.
                # Checksum trailers are verified inside the batch tier
                # (kernel K4 in finish — the reference computes it inline
                # per block, lib/compress/cmp.c:314-319).
                bd = BatchDecompressor(CmpParams(), n_run, n_samples,
                                       cmp_type,
                                       verify_checksum=verify_checksum,
                                       device=device)
                decoders[(n_run, n_samples)] = bd
            if device_staged:
                # device-staged tier: compressed bytes uploaded once, the
                # host parses the headers, the rows are gathered on the
                # device
                if ds is None:
                    ds = bd.upload_stream(stream)
                st = bd.stage_headers_at(stream, offs, lens)
                dec = bd.decode_staged_from(st, ds)
            else:
                st = bd.stage_frames_at(stream, offs, lens)
                dec = bd.decode_staged(st)
            _flush()  # previous run finishes AFTER this one dispatched
            pending = (i, j, bd, st, dec)
            i = j
        else:  # host path: single block, or one that needs chain state
            _flush()
            o, h = blocks[i]
            model = None
            if h.preprocessing == int(Preprocessing.MODEL):
                if h.sequence_number == 0:
                    raise CmpError(CmpErrorCode.INT_HDR,
                                   "MODEL preprocessing on a primary pass")
                model = state.model
                if model is None:
                    raise CmpError(CmpErrorCode.SRC_SIZE_MISMATCH,
                                   "MODEL block without chain state")
            samples, h, _size = decode_block(
                stream[o: o + h.compressed_size], model, verify_checksum)
            state.update_after_block(h, samples)
            out_parts[i] = samples
            i += 1
    _flush()
    if not out_parts:
        return np.zeros(0, np.uint16)
    return np.concatenate(out_parts)
