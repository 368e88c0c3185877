"""The long-stream tier: ONE long AIRSPACE block, encoded and decoded in
parallel on one card.

Port of ``airs_compression_tpu/parallel/sp.py``.  Its users compress one
acquisition as one block, up to the header's limit of 2^24-1 bytes of
samples, and decode it in parallel through a sidecar of per-chunk payload
bit lengths (4 bytes per 1024 samples).  The frames are byte-identical to
the JAX package's (and to the host codec's with the same identifier).

On one card the stream needs no halo exchange: it is preprocessed whole
(ops/preprocess.py, any method; IWT needs a power-of-two length, as the
JAX tier does on one device).  The JAX tier packed each shard's rows with
its TPU kernel and stitched the row streams with a doubling tree of
funnel-shift merges; here:

* **encode** — the codes' lengths are summed per row of
  :data:`~airs_compression_tpu_torch.ops.pack.ROW_CODES` codes, an
  exclusive scan gives every row its absolute start bit (the header's bits
  included), and ONE launch of kernel K1 in long-row mode packs every row
  straight into the frame's word stream, one CTA a row, ORing only the
  words a row shares with a neighbour (ops/pack.py).  The header bytes and
  the XXH32 trailer (kernel K4 over the one row of samples) go in on the
  host, as whole bytes, when the frame is fetched.
* **sidecar decode** — kernel K3 in window mode decodes every chunk from
  its start bit in the one word stream (ops/decode_kernel.py), without a
  window matrix; DIFF is inverted by a blocked cumsum; every chunk's end
  must land on its boundary (a lying sidecar or a corrupt payload raises
  ``INT_BITSTREAM``) and the trailer is checked by K4.
* **streaming encode** (:class:`ChunkedLongStreamEncoder`) — the carry of
  bit offset and previous sample stays on the card, each feed packs its
  codes with kernel K2 in long-row mode at the carried offset, and K4
  hashes each feed's whole 16-byte stripes on the card
  (:class:`~airs_compression_tpu_torch.ops.xxh32_device.StreamHasher`).

Under ``torch.profiler`` the steps are flat spans (utils/profiling.span):
the one-card encode's ``sp.encode.upload`` (the samples to the card, and
a model that is not there yet), ``sp.encode.preprocess`` (the IWT, DIFF
or MODEL residuals), ``sp.encode.codes`` (code lengths and row starts),
``sp.encode.pack`` (K1), ``sp.encode.checksum`` (K4) and
``sp.encode.fetch`` (the wait for the card, the frame's bytes to the
host, header and trailer); :class:`LongStreamCompressor`'s
``sp.chain.update`` (the model seeded from, or updated with, the block's
samples on the card); the sidecar decode's ``sp.decode.*``; the split's
``sp.mesh.*``.  The one-card paths copy between the host and the card
through :func:`_upload` and :func:`_fetch`, which count the bytes that
cross between the host's pageable memory and a CUDA device (the sidecar
decode's frame words go up through models/stream.py's, and count there);
:data:`encoded_blocks` counts the frames assembled,
:data:`model_blocks` the MODEL blocks a :class:`LongStreamCompressor`
encoded and :data:`model_resident_blocks` those whose model the card
already held.

Every function here takes ``device=`` (default ``"cuda"``, raising where
CUDA is absent).  :func:`compress_long_stream`, :class:`LongStreamCompressor`
and :class:`ChunkedLongStreamEncoder` also take ``mesh=`` (parallel/mesh.py),
which splits ONE stream over the ranks of a ``torch.distributed`` group,
as the JAX tier's ``mesh`` splits it over devices.  Every rank passes its
own contiguous ``n / size`` samples (of each chunk, for the chunked
encoder) and runs on the mesh's device:

* **halos** — DIFF takes the previous rank's last sample from one
  ``all_gather`` of one sample a rank; IWT exchanges one element with each
  neighbour per lifting pass (the first and last elements of every rank in
  one ``all_gather``), and once a level is down to one element a rank,
  every rank computes the deep levels from one small ``all_gather``;
  MODEL is elementwise;
* **offsets** — one ``all_gather`` of the ranks' payload bit counts; an
  exclusive scan of them from the header's bits gives each rank its start
  bit;
* **packing** — each rank packs its codes with K1 (K2 for the chunked
  encoder) in long-row mode into a word buffer that covers only its own
  span of the frame, shifted down by ``32 * (start_bit // 32)``;
* **assembly** — rank 0 gathers the spans (padded to the longest), ORs in
  the one word two neighbours may share, and writes the header and
  trailer;
* **XXH32** — each rank hashes its part with K4 in streaming mode, in rank
  order: the lanes and the at most 7 samples left over are relayed from
  rank r to rank r + 1 (``StreamHasher.state``), the last rank's going
  back to rank 0.  The relay is serial by nature: one hop a rank, and one
  round of hops per chunk for the chunked encoder.

Rank 0 returns the frame and the other ranks ``None``; every rank knows
the frame's size, so a :class:`LongStreamCompressor` takes its fallback on
every rank alike, and its identifiers are drawn on rank 0 and broadcast.
The steps of the split are profiler ranges ``sp.mesh.*``.

Not ported: the entropy clamp of the TPU packer (``cap_bits``, the
encoder's ``clamp=`` argument and its deferred-commit rollback): the
port's packers size the stream by the worst case and cannot overflow, so
:class:`ChunkedLongStreamEncoder` takes no ``clamp`` argument.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _build
from ..engine import context as _context
from ..format.errors import CmpError, CmpErrorCode
from ..format.header import CMP_HDR_MAX_SIZE, CMP_HDR_SIZE, CmpHeader
from ..format.params import CmpParams, EncoderType, Preprocessing
from ..models.stream import _bytes_to_be_words
from ..ops import golomb, pack, preprocess
from ..ops.assemble import be_bytes
from ..ops.decode_kernel import decode_windows
from ..ops.encode import PassConfig, make_pass_config, worst_case_words
from ..ops.xxh32_device import StreamHasher, checksum_stream_device
from ..utils.profiling import span
from .mesh import Mesh

__all__ = ["compress_long_stream", "LongStreamCompressor",
           "stream_chunk_index", "decompress_long_stream",
           "ChunkedLongStreamEncoder"]

_MAX_ORIGINAL_SIZE = (1 << 24) - 1  # the header's 24-bit original_size

#: frames assembled by :func:`_frame` in this process (one a block encoded
#: on one card, on rank 0 of a mesh, or by a chunked encoder)
encoded_blocks = 0
#: MODEL blocks encoded by a :class:`LongStreamCompressor` in this process,
#: and those of them whose model was already an int32 tensor on the
#: encode's device when the block began (no upload from the host)
model_blocks = 0
model_resident_blocks = 0


def _step(name: str):
    """A span over one step, named ``sp.<name>``
    (utils/profiling.range_times reads its host and device time); without
    a profiler running it is a shared null context and waits for
    nothing."""
    return span(f"sp.{name}")


def _upload(array: np.ndarray, device) -> torch.Tensor:
    """``array`` as a tensor on ``device``.  A copy to a CUDA device adds
    its bytes to ``_upload.pageable_bytes``: ``array`` is numpy memory,
    never pinned."""
    out = torch.from_numpy(array).to(device)
    if out.device.type == "cuda":
        _upload.pageable_bytes += array.nbytes
    return out


def _fetch(tensor: torch.Tensor) -> np.ndarray:
    """``tensor`` on the host, as a numpy array.  A copy from a CUDA
    device adds its bytes to ``_fetch.pageable_bytes``: ``.cpu()``
    allocates fresh pageable memory."""
    host = tensor.cpu().numpy()
    if tensor.device.type == "cuda":
        _fetch.pageable_bytes += host.nbytes
    return host


_upload.pageable_bytes = 0
_fetch.pageable_bytes = 0


def _host_samples(samples_u16) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(samples_u16, dtype=np.uint16))


def _to_device(x_np: np.ndarray, dev) -> torch.Tensor:
    """u16 samples -> sign-extended int32 on ``dev``."""
    return _upload(x_np.view(np.int16), dev).to(torch.int32)


def _model_tensor(model, dev) -> torch.Tensor:
    """An i16-valued model -> sign-extended int32 on ``dev``.  A tensor
    that needs no copy through the host is moved or cast where it lies
    (an int32 one already on ``dev`` is returned as it is); host memory
    goes up through :func:`_upload`."""
    if isinstance(model, torch.Tensor) and (model.device.type != "cpu"
                                            or dev.type == "cpu"):
        return model.to(dev, torch.int32)
    m = np.ascontiguousarray(np.asarray(model, np.int16))
    return _upload(m, dev).to(torch.int32)


def _frame_size(cfg: PassConfig, bits: int) -> int:
    """The frame's bytes for ``bits`` bits of header and payload."""
    if cfg.checksum:
        bits = bits + (-bits) % 8 + 32
    return (bits + 7) >> 3


def _frame(cfg: PassConfig, params: CmpParams, stream: torch.Tensor,
           bits: int, checksum: "int | None", n: int, identifier: int,
           sequence_number: int) -> bytes:
    """The frame's bytes from its word stream (payload from bit
    ``cfg.hdr_bits`` on, ``bits`` bits with the header's): the stream's
    bytes are fetched, the header (whole bytes, 16 or 22) and the trailer
    written over them on the host."""
    global encoded_blocks
    size = _frame_size(cfg, bits)
    words = stream[: (size + 3) // 4]
    frame = bytearray(_fetch(be_bytes(words[None])[0, :size]).tobytes())
    hdr = CmpHeader(
        compressed_size=size, original_size=2 * n, identifier=identifier,
        sequence_number=sequence_number, preprocessing=cfg.prep,
        checksum_enabled=1 if cfg.checksum else 0,
        encoder_type=cfg.enc_type,
        model_rate=(params.model_rate
                    if cfg.prep == int(Preprocessing.MODEL) else 0),
        encoder_param=cfg.g_par if cfg.enc_type else 0,
        encoder_outlier=cfg.outlier if cfg.enc_type else 0).serialize()
    frame[: len(hdr)] = hdr
    if checksum is not None:
        frame[size - 4: size] = checksum.to_bytes(4, "big")
    encoded_blocks += 1
    return bytes(frame)


def compress_long_stream(params: CmpParams, samples_u16,
                         identifier: int = 0, sequence_number: int = 0,
                         model=None, secondary: bool = False,
                         device="cuda", mesh: "Mesh | None" = None):
    """Compress ONE long u16 stream as a single AIRSPACE block on ``device``.

    ``model`` supplies the model state for MODEL preprocessing (an
    i16-valued array of the stream's length, or a tensor: an int32 one on
    ``device`` is used as it is); ``secondary`` selects the
    pass parameters (cmp.c:228-248).  Returns the frame's bytes, identical
    to the JAX package's ``compress_long_stream`` and to the host codec.
    For chain semantics use :class:`LongStreamCompressor`.  Its steps are
    profiler ranges ``sp.encode.{upload,preprocess,codes,pack,checksum,
    fetch}``.

    With ``mesh`` the stream is split over its ranks (see the module
    docstring): ``samples_u16`` and ``model`` are this rank's contiguous
    ``n / size`` samples, the work runs on ``mesh.device``, and rank 0
    returns the frame, the other ranks None.
    """
    if mesh is not None:
        return _compress_split(mesh, params, samples_u16, identifier,
                               sequence_number, model, secondary)[0]
    return _compress_one(params, samples_u16, identifier, sequence_number,
                         model, secondary, device)[0]


def _compress_one(params: CmpParams, samples_u16, identifier: int,
                  sequence_number: int, model, secondary: bool, device):
    """:func:`compress_long_stream` on one card.  Returns (the frame, the
    samples as uploaded: sign-extended int32 on the device)."""
    params.validate()
    dev = _build.resolve_device(device)
    x_np = _host_samples(samples_u16)
    n = x_np.size
    if 2 * n > _MAX_ORIGINAL_SIZE:
        raise CmpError(CmpErrorCode.HDR_ORIGINAL_TOO_LARGE)
    cfg = make_pass_config(params, secondary)
    if cfg.prep == int(Preprocessing.IWT) and n & (n - 1):
        raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                       f"IWT long-stream mode needs a power-of-two length, "
                       f"got {n}")
    needs_model = cfg.prep == int(Preprocessing.MODEL)
    if needs_model and model is None:
        raise CmpError(CmpErrorCode.PARAMS_INVALID,
                       "MODEL preprocessing requires model state")

    with _step("encode.upload"):
        x = _to_device(x_np, dev)
        m = _model_tensor(model, dev)[None] if needs_model else None
    with _step("encode.preprocess"):
        res = preprocess.preprocess_forward(cfg.prep, x[None], m)[0]
    with _step("encode.codes"):
        lens = golomb.code_lengths(res, cfg.enc_type, cfg.g_par,
                                   cfg.outlier)
        starts, payload_bits = pack.row_starts(lens, pack.ROW_CODES,
                                               cfg.hdr_bits)
    with _step("encode.pack"):
        stream = torch.zeros(worst_case_words(cfg, n), dtype=torch.int32,
                             device=dev)
        pack.pack_residuals_at(stream, res, pack.ROW_CODES, starts,
                               cfg.enc_type, cfg.g_par, cfg.outlier)
    fetch = [payload_bits]
    with _step("encode.checksum"):
        if cfg.checksum:
            fetch.append(checksum_stream_device(x))
    with _step("encode.fetch"):
        got = _fetch(torch.stack(fetch)).tolist()  # the one wait for the card
        return _frame(cfg, params, stream, cfg.hdr_bits + got[0],
                      got[1] if cfg.checksum else None, n, identifier,
                      sequence_number), x


# -- one stream split over the ranks of a mesh -----------------------------


def _split_length(mesh: Mesh, n_loc: int) -> int:
    """The stream's length from every rank's part; the parts must be equal
    (the JAX tier's ``n % size`` check, made on every rank alike)."""
    parts = mesh.gather_ints([n_loc])[:, 0]
    if (parts != n_loc).any():
        raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                       f"stream of {int(parts.sum())} samples does not "
                       f"split evenly over {mesh.size} ranks ({parts.tolist()})")
    return n_loc * mesh.size


def _neighbours(mesh: Mesh, v: torch.Tensor):
    """``v`` shifted by one element both ways along the split sequence:
    (left, right), each end taken from the neighbouring rank (a ring, as
    ``torch.roll`` on one rank) by one ``all_gather`` of every rank's first
    and last element."""
    ends = mesh.all_gather(torch.stack([v[0], v[-1]]))
    r, w = mesh.rank, mesh.size
    return (torch.cat([ends[(r - 1) % w, 1:], v[:-1]]),
            torch.cat([v[1:], ends[(r + 1) % w, :1]]))


def _iwt_level_split(mesh: Mesh, xs: torch.Tensor, m: int) -> torch.Tensor:
    """One forward lifting level over this rank's part of a subsequence of
    ``m`` elements split evenly in rank order: ops/preprocess._iwt_level on
    the joined subsequence.  The odd (detail) pass reads the original
    neighbours, the even (approximation) pass the detail-updated ones; the
    global ends (j == 0, j == m - 1) apply on the first and last rank."""
    j = mesh.rank * xs.numel() + torch.arange(xs.numel(), device=xs.device)
    is_odd = (j & 1) == 1
    left, right = _neighbours(mesh, xs)
    det = torch.where(j == m - 1, xs - left, xs - ((left + right) >> 1))
    y = torch.where(is_odd, preprocess.wrap16(det), xs)
    yl, yr = _neighbours(mesh, y)
    app = xs + ((yl + yr) >> 2)
    app = torch.where(j == 0, xs + (yr >> 1), app)
    app = torch.where(j == m - 1, xs + (yl >> 1), app)
    return torch.where(is_odd, y, preprocess.wrap16(app))


def _iwt_forward_split(mesh: Mesh, x: torch.Tensor, n: int) -> torch.Tensor:
    """The multi-level IWT of a stream of ``n`` samples split as ``x``
    (a power-of-two count a rank).  Levels with two or more subsequence
    elements a rank run split, with halos; the last ``log2(size)`` levels
    run on every rank over the ``size`` elements left, gathered once."""
    L = x.numel()
    out = x.clone()
    s = 1
    while s < n and L // s >= 2:
        out[::s] = _iwt_level_split(mesh, out[::s], n // s)
        s <<= 1
    if s < n:  # one element a rank left
        g = mesh.all_gather(out[::s]).reshape(-1)
        t = s
        while t < n:
            st = t // s
            g[::st] = preprocess._iwt_level(g[::st], inverse=False)
            t <<= 1
        out[::s] = g[mesh.rank: mesh.rank + 1]
    return out


def _residuals_split(mesh: Mesh, cfg: PassConfig, x: torch.Tensor,
                     m: "torch.Tensor | None", n: int) -> torch.Tensor:
    if cfg.prep == int(Preprocessing.DIFF):
        prev = mesh.all_gather(x[-1:])[mesh.rank - 1]
        if mesh.rank == 0:  # the stream's first sample is stored raw
            prev = torch.zeros_like(prev)
        return preprocess.wrap16(x - torch.cat([prev, x[:-1]]))
    if cfg.prep == int(Preprocessing.IWT):
        return _iwt_forward_split(mesh, x, n)
    return preprocess.preprocess_forward(cfg.prep, x[None], m)[0]


def _spans(mesh: Mesh, bits: np.ndarray, first_bit: int):
    """Where each rank's payload goes: from the (size, k) bit counts of its
    pieces (every rank's k pieces interleave: piece j of every rank, in
    rank order, then piece j + 1), each piece's absolute start bit (size,
    k), each rank's first word (size,) and its span's word count (size,).
    """
    per_piece = bits.sum(axis=0)
    piece0 = first_bit + np.cumsum(per_piece) - per_piece
    starts = piece0[None, :] + np.cumsum(bits, axis=0) - bits
    w0 = starts[:, 0] // 32
    end = starts[:, -1] + bits[:, -1]
    return starts, w0, np.maximum(1, (end - 32 * w0 + 31) // 32)


def _merge_spans(mesh: Mesh, stream: "torch.Tensor | None",
                 local: torch.Tensor, w0: np.ndarray,
                 n_words: np.ndarray) -> None:
    """Gather every rank's span (``local``, padded to the longest) on rank
    0 and OR each into ``stream`` at its first word; neighbours share at
    most one word, their bits disjoint."""
    with _step("mesh.gather"):
        spans = mesh.gather(local)
    if spans is None:
        return
    with _step("mesh.merge"):
        spans = spans.to(stream.device)
        for q in range(mesh.size):
            a, k = int(w0[q]), int(n_words[q])
            stream[a: a + k] |= spans[q, :k]


def _hash_round(mesh: Mesh, hasher: StreamHasher, x: torch.Tensor) -> None:
    """Hash this rank's piece ``x`` in rank order (K4, streaming): take the
    state from the rank before, hash, pass it on; the last rank passes it
    back to rank 0, which holds it between rounds."""
    with _step("mesh.relay"):
        r, w = mesh.rank, mesh.size
        like = torch.empty((StreamHasher.STATE_LEN,), dtype=torch.int64)
        if r > 0:
            hasher.load(mesh.recv(like, r - 1))
        hasher.update(x)
        if w > 1:
            mesh.send(hasher.state(), (r + 1) % w)
            if r == 0:
                hasher.load(mesh.recv(like, w - 1))


def _compress_split(mesh: Mesh, params: CmpParams, samples_u16,
                    identifier: int, sequence_number: int, model,
                    secondary: bool):
    """:func:`compress_long_stream` over the ranks of ``mesh``.  Returns
    (frame or None, the frame's size, this rank's samples as uploaded):
    rank 0 has the frame, every rank the size."""
    params.validate()
    dev = mesh.device
    x_np = _host_samples(samples_u16)
    n = _split_length(mesh, x_np.size)
    if 2 * n > _MAX_ORIGINAL_SIZE:
        raise CmpError(CmpErrorCode.HDR_ORIGINAL_TOO_LARGE)
    cfg = make_pass_config(params, secondary)
    L = x_np.size
    if cfg.prep == int(Preprocessing.IWT) and L & (L - 1):
        raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                       f"IWT long-stream mode needs a power-of-two length "
                       f"a rank, got {n}/{mesh.size}={L}")
    needs_model = cfg.prep == int(Preprocessing.MODEL)
    if needs_model and model is None:
        raise CmpError(CmpErrorCode.PARAMS_INVALID,
                       "MODEL preprocessing requires model state")

    with _step("mesh.upload"):
        x = _to_device(x_np, dev)
        m = _model_tensor(model, dev)[None] if needs_model else None
    with _step("mesh.codes"):
        res = _residuals_split(mesh, cfg, x, m, n)
        lens = golomb.code_lengths(res, cfg.enc_type, cfg.g_par,
                                   cfg.outlier)
    with _step("mesh.offsets"):
        bits = mesh.gather_ints([int(lens.sum())])
        starts, w0, n_words = _spans(mesh, bits, cfg.hdr_bits)
    with _step("mesh.pack"):
        r = mesh.rank
        local = torch.zeros(int(n_words.max()), dtype=torch.int32,
                            device=dev)
        rows, _ = pack.row_starts(lens, pack.ROW_CODES,
                                  int(starts[r, 0] - 32 * w0[r]))
        pack.pack_residuals_at(local, res, pack.ROW_CODES, rows,
                               cfg.enc_type, cfg.g_par, cfg.outlier)
    total_bits = cfg.hdr_bits + int(bits.sum())
    size = _frame_size(cfg, total_bits)
    stream = (torch.zeros((size + 3) // 4 + 1, dtype=torch.int32,
                          device=mesh.comm_device) if r == 0 else None)
    _merge_spans(mesh, stream, local, w0, n_words)
    checksum = None
    if cfg.checksum:
        hasher = StreamHasher(dev)
        _hash_round(mesh, hasher, x)
        checksum = hasher.intdigest() if r == 0 else None
    if r:
        return None, size, x
    with _step("mesh.fetch"):
        return _frame(cfg, params, stream, total_bits, checksum, n,
                      identifier, sequence_number), size, x


# -- parallel decode of ONE long block (sidecar-indexed) -------------------
#
# Golomb decoding is bit-serial: a block has no sync point of the format.
# A sidecar of per-chunk payload bit lengths lets every chunk start its
# cursor independently, so the stream decodes as a batch of chunk windows.
# The frame stays format-pure; the sidecar is derived from the samples and
# is validated on use: every chunk's decode must end on its boundary.


def stream_chunk_index(params: CmpParams, samples_u16,
                       chunk_samples: int = 1024, secondary: bool = False,
                       model=None, device="cuda") -> np.ndarray:
    """Per-chunk payload bit lengths of one long block (the sidecar), (n /
    chunk_samples,) int32, from the samples: preprocess and the codes'
    lengths on ``device``, summed per chunk.  No packing, no decode."""
    cfg = make_pass_config(params, secondary)
    if cfg.enc_type not in (1, 2):
        raise CmpError(CmpErrorCode.PARAMS_INVALID,
                       "chunk index applies to Golomb-coded blocks")
    if cfg.prep == int(Preprocessing.MODEL) and model is None:
        raise CmpError(CmpErrorCode.PARAMS_INVALID,
                       "MODEL preprocessing requires model state")
    dev = _build.resolve_device(device)
    x_np = _host_samples(samples_u16)
    n = x_np.size
    if n % chunk_samples:
        raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                       f"stream length {n} not divisible by chunk "
                       f"{chunk_samples}")
    m = (_model_tensor(model, dev)[None]
         if cfg.prep == int(Preprocessing.MODEL) else None)
    res = preprocess.preprocess_forward(cfg.prep, _to_device(x_np, dev)[None],
                                        m)
    lens = golomb.code_lengths(res, cfg.enc_type, cfg.g_par, cfg.outlier)
    # int32 is ample: a chunk's bits <= chunk * 48 < 2^31
    return _fetch(lens.reshape(-1, chunk_samples).sum(dim=-1)
                  .to(torch.int32))


def decompress_long_stream(frame: bytes, chunk_bits, model=None,
                           verify_checksum: bool = True,
                           device="cuda") -> np.ndarray:
    """Decode ONE long Golomb block chunk-parallel on ``device``.

    ``chunk_bits`` is the sidecar from :func:`stream_chunk_index`.  Every
    chunk is decoded from its start bit by kernel K3 in window mode; every
    chunk's end must land exactly on its boundary (a wrong or corrupt
    sidecar or payload raises ``INT_BITSTREAM``), and the trailing XXH32
    is verified when present.  Returns the uint16 samples.  Its steps are
    profiler ranges ``sp.decode.{upload,decode,inverse,check,checksum,
    fetch}``.
    """
    dev = _build.resolve_device(device)
    hdr, hsz = CmpHeader.deserialize(frame[:CMP_HDR_MAX_SIZE])
    if hdr.preprocessing > 3:
        raise CmpError(CmpErrorCode.INT_HDR,
                       f"unknown preprocessing {hdr.preprocessing}")
    if hdr.encoder_type not in (1, 2):
        raise CmpError(CmpErrorCode.PARAMS_INVALID,
                       "sidecar decode applies to Golomb-coded blocks")
    if not 1 <= hdr.encoder_param <= 0xFFFF:
        raise CmpError(CmpErrorCode.PARAMS_INVALID,
                       "bad Golomb parameter in header")
    if hdr.compressed_size > len(frame):
        raise CmpError(CmpErrorCode.INT_HDR, "truncated frame")
    n = hdr.original_size // 2
    chunk_bits = np.asarray(chunk_bits, np.int64)
    n_chunks = chunk_bits.size
    if n_chunks == 0 or n % n_chunks:
        raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                       "chunk index does not tile the stream")
    chunk = n // n_chunks
    dcfg = PassConfig(0, hdr.encoder_type, hdr.encoder_param,
                      hdr.encoder_outlier, bool(hdr.checksum_enabled), 0)
    hb = dcfg.hdr_bits  # 176: the extension is present (encoder != NONE)

    # absolute payload bit offset of each chunk; its window starts hb bits
    # earlier, so the decoder's header skip lands on its first code
    off = hsz * 8 + np.concatenate(([0], np.cumsum(chunk_bits)[:-1]))
    if (off[-1] + chunk_bits[-1] + 7) // 8 > hdr.compressed_size:
        raise CmpError(CmpErrorCode.INT_BITSTREAM,
                       "chunk index exceeds compressed_size")
    # windows sized by the LARGEST chunk (the sidecar is exact); a lying
    # sidecar is safe either way: the boundary check rejects it
    max_bits = min(int(chunk_bits.max()),
                   chunk * dcfg.worst_bits_per_sample)
    c_lane = max(1, (hb + max_bits + 63) // 32 + 2)
    if hdr.preprocessing == int(Preprocessing.MODEL):
        if model is None:
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           "MODEL preprocessing requires model state")
        m = _model_tensor(model, dev)[None]
    else:
        m = None

    with _step("decode.upload"):
        padded = np.zeros(len(frame) + (-len(frame)) % 4, np.uint8)
        padded[: len(frame)] = np.frombuffer(frame, np.uint8)
        words = _bytes_to_be_words(padded[None], dev)[0]
        # a window from below 0 or past the frame reads zeros either way;
        # clipped, a lying sidecar's offsets fit the kernel's int32
        start = _upload(np.clip(off - hb, -1, 32 * words.numel()), dev)
    with _step("decode.decode"):
        g, outlier = (torch.full((n_chunks,), v, dtype=torch.int64,
                                 device=dev)
                      for v in (hdr.encoder_param, hdr.encoder_outlier))
        vals, end = decode_windows(words, start, c_lane, hb, chunk,
                                   hdr.encoder_type, g, outlier)
    with _step("decode.inverse"):
        res = golomb.unzigzag(vals)
        if hdr.preprocessing == int(Preprocessing.DIFF):
            # blocked wraparound cumsum: per-chunk cumsums plus exclusive
            # chunk offsets (mod-2^16 addition is associative)
            within = torch.cumsum(res, dim=-1, dtype=torch.int64)
            rows = within[:, -1]
            offs = torch.cumsum(rows, dim=0) - rows
            samples = preprocess.wrap16(within + offs[:, None]).reshape(n)
        else:
            samples = preprocess.preprocess_inverse(hdr.preprocessing,
                                                    res.reshape(1, n), m)[0]
    with _step("decode.check"):
        got = _fetch(end).astype(np.int64)
        if not np.array_equal(got, hb + chunk_bits):
            raise CmpError(CmpErrorCode.INT_BITSTREAM,
                           "chunk decode did not land on its boundary "
                           "(corrupt payload or sidecar)")
    with _step("decode.checksum"):
        if verify_checksum and hdr.checksum_enabled:
            stored = int.from_bytes(
                frame[hdr.compressed_size - 4: hdr.compressed_size], "big")
            if int(checksum_stream_device(samples)) != stored:
                raise CmpError(CmpErrorCode.GENERIC, "checksum mismatch")
    with _step("decode.fetch"):
        return _fetch(samples.to(torch.int16)).view(np.uint16)


# -- streaming (chunk-fed) encode of ONE long block ------------------------


class ChunkedLongStreamEncoder:
    """Encode ONE long AIRSPACE block from a stream of sample chunks.

    Gives bytes IDENTICAL to :func:`compress_long_stream` over the
    concatenated chunks, but the samples arrive ``chunk_samples`` at a
    time: each :meth:`feed` preprocesses its chunk with the carried
    previous sample, packs its codes at the carried bit offset straight
    into the frame's word stream (kernel K2 in long-row mode) and hashes
    its whole stripes (kernel K4, streaming); the carry stays on the card,
    so a feed does not wait for it.  :meth:`feed_many` takes a (K,
    chunk_samples) buffer in one pass: one launch per kernel for K chunks.

    With ``mesh`` every chunk is split over the ranks: each rank feeds its
    contiguous ``chunk_samples / size`` samples of every chunk, a feed
    gathers the ranks' last samples (DIFF) and bit counts once, each rank
    packs its pieces into its span, the spans are ORed into the frame's
    stream, which lives on rank 0, and K4's state is relayed rank to rank,
    one round a chunk.  :meth:`finish` returns the frame on rank 0, None
    on the others.

    Preprocessing NONE, DIFF and MODEL stream exactly (DIFF carries one
    sample across chunks); IWT lifts across the whole stream and is
    rejected.  The JAX encoder's ``clamp`` argument is absent: it selects
    the TPU packer's entropy clamp, which the port does not have.
    """

    def __init__(self, params: CmpParams, total_samples: int,
                 chunk_samples: int, identifier: int = 0,
                 sequence_number: int = 0, secondary: bool = False,
                 device="cuda", mesh: "Mesh | None" = None):
        params.validate()
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else _build.resolve_device(device))
        self.params = params
        cfg = make_pass_config(params, secondary)
        if cfg.prep == int(Preprocessing.IWT):
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           "IWT cannot stream; use compress_long_stream")
        ranks = 1 if mesh is None else mesh.size
        if chunk_samples % ranks or total_samples % chunk_samples:
            raise CmpError(
                CmpErrorCode.SRC_SIZE_WRONG,
                f"chunk {chunk_samples} must divide the stream "
                f"{total_samples} and split evenly over {ranks} ranks")
        if 2 * total_samples > _MAX_ORIGINAL_SIZE:
            raise CmpError(CmpErrorCode.HDR_ORIGINAL_TOO_LARGE)
        self.cfg = cfg
        self.total = total_samples
        self.chunk = chunk_samples
        self.piece = chunk_samples // ranks  # the samples a rank feeds
        self.identifier = identifier
        self.sequence_number = sequence_number
        self._needs_model = cfg.prep == int(Preprocessing.MODEL)
        dev = self.device
        self._out = None
        if mesh is None or mesh.rank == 0:
            self._out = torch.zeros(
                worst_case_words(cfg, total_samples), dtype=torch.int32,
                device=dev if mesh is None else mesh.comm_device)
        self._carry = torch.tensor(cfg.hdr_bits, dtype=torch.int64,
                                   device=dev)
        self._prev = torch.zeros((1,), dtype=torch.int32, device=dev)
        self._hasher = StreamHasher(dev) if cfg.checksum else None
        self._fed = 0
        # each piece is packed as rows of the largest divisor of its
        # length up to ROW_CODES, so no row crosses into another piece
        self._row = next(d for d in range(min(self.piece, pack.ROW_CODES),
                                          0, -1) if self.piece % d == 0)

    def _samples(self, chunks) -> torch.Tensor:
        """Sign-extended int32 samples on the device: a host u16 array is
        uploaded, a tensor of u16 values (any integer type) is used where
        it lies (on the encoder's device: no copy through the host)."""
        if isinstance(chunks, torch.Tensor):
            v = chunks.to(self.device).to(torch.int32) & 0xFFFF
            return (v ^ 0x8000) - 0x8000
        return _to_device(_host_samples(chunks), self.device)

    def _codes(self, res: torch.Tensor):
        cfg = self.cfg
        hi, lo, lens = golomb.encode_codewords(res, cfg.enc_type, cfg.g_par,
                                               cfg.outlier)
        multi = cfg.enc_type == int(EncoderType.GOLOMB_MULTI)
        return hi if multi else None, lo, lens

    def _encode(self, x: torch.Tensor, model_chunks) -> None:
        cfg = self.cfg
        if cfg.prep == int(Preprocessing.DIFF):
            res = preprocess.wrap16(x - torch.cat([self._prev, x[:-1]]))
        elif self._needs_model:
            res = preprocess.model_forward(
                x, _model_tensor(model_chunks, self.device).reshape(-1))
        else:
            res = x
        hi, lo, lens = self._codes(res)
        starts, bits = pack.row_starts(lens, pack.ROW_CODES, self._carry)
        pack.pack_codes_at(self._out, hi, lo, lens, pack.ROW_CODES, starts,
                           cfg.worst_bits_per_sample)
        self._carry = self._carry + bits
        self._prev = x[-1:]
        if self._hasher is not None:
            self._hasher.update(x)
        self._fed += x.numel()

    def _encode_split(self, xs: torch.Tensor, model_chunks) -> None:
        """One feed of K chunks over the mesh: ``xs`` (K, piece) is this
        rank's piece of each."""
        cfg, mesh = self.cfg, self.mesh
        r, w = mesh.rank, mesh.size
        K = xs.shape[0]
        with _step("mesh.feed.codes"):
            if cfg.prep == int(Preprocessing.DIFF):
                lasts = mesh.all_gather(xs[:, -1])  # (size, K)
                prev = (lasts[r - 1] if r else
                        torch.cat([self._prev, lasts[-1, :-1]]))
                res = preprocess.wrap16(
                    xs - torch.cat([prev[:, None], xs[:, :-1]], dim=1))
                self._prev = lasts[-1, -1:]
            elif self._needs_model:
                res = preprocess.model_forward(xs, _model_tensor(
                    model_chunks, self.device).reshape(xs.shape))
            else:
                res = xs
            hi, lo, lens = self._codes(res.reshape(-1))
        with _step("mesh.feed.offsets"):
            row_bits = lens.reshape(K, -1, self._row).sum(dim=2)
            bits = mesh.all_gather(row_bits.sum(dim=1)).cpu().numpy()
            carry = int(self._carry)
            starts, w0, n_words = _spans(mesh, bits, carry)
        with _step("mesh.feed.pack"):
            local = torch.zeros(int(n_words.max()), dtype=torch.int32,
                                device=self.device)
            first = torch.from_numpy(starts[r] - 32 * w0[r]).to(self.device)
            rows = (first[:, None] + torch.cumsum(row_bits, dim=1)
                    - row_bits).reshape(-1)
            pack.pack_codes_at(local, hi, lo, lens, self._row, rows,
                               cfg.worst_bits_per_sample)
        _merge_spans(mesh, self._out, local, w0, n_words)
        self._carry = torch.tensor(carry + int(bits.sum()),
                                   dtype=torch.int64, device=self.device)
        if self._hasher is not None:
            for k in range(K):
                _hash_round(mesh, self._hasher, xs[k])
        self._fed += K * self.chunk

    def feed(self, chunk_u16, model_chunk=None) -> None:
        """Feed the next ``chunk_samples`` samples (with a mesh: this
        rank's piece of them): a host u16 array, or a tensor of u16
        values, used on the card where it lies."""
        size = (chunk_u16.numel() if isinstance(chunk_u16, torch.Tensor)
                else np.asarray(chunk_u16).size)
        if size != self.piece:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                           f"expected {self.piece}-sample chunks")
        self.feed_many(self._samples(chunk_u16).reshape(1, -1),
                       None if model_chunk is None
                       else np.asarray(model_chunk).reshape(1, -1))

    def feed_many(self, chunks, model_chunks=None) -> None:
        """Feed K chunks — a (K, chunk_samples) buffer (with a mesh: this
        rank's (K, chunk_samples / size) pieces) — in one pass (one launch
        of each kernel); host or device arrays as :meth:`feed`."""
        xs = self._samples(chunks)
        if xs.dim() != 2 or xs.shape[1] != self.piece:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                           f"expected (K, {self.piece}) chunk buffers")
        if self._fed + xs.shape[0] * self.chunk > self.total:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG, "stream overfed")
        if self._needs_model and model_chunks is None:
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           "MODEL preprocessing requires model chunks")
        if self.mesh is None:
            self._encode(xs.reshape(-1), model_chunks)
        else:
            self._encode_split(xs, model_chunks)

    def finish(self) -> "bytes | None":
        """The complete frame's bytes: header, payload and the digest (with
        a mesh: on rank 0; None on the other ranks)."""
        if self._fed != self.total:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                           f"fed {self._fed} of {self.total} samples")
        if self._out is None:
            return None
        bits = int(self._carry)
        checksum = (self._hasher.intdigest() if self._hasher is not None
                    else None)
        return _frame(self.cfg, self.params, self._out, bits, checksum,
                      self.total, self.identifier, self.sequence_number)


class LongStreamCompressor:
    """Multi-pass chain over long streams (one reference context).

    Mirrors the engine's pass selection, fallback and model update
    (cmp.c:213-393) for a chain of long blocks:

    * pass selection: seq 0 (or exhausted secondary iterations) runs the
      primary parameters and reseeds the model with the frame;
    * the uncompressed fallback triggers exactly when the compressed frame
      exceeds the uncompressed frame size, resets the chain, and draws two
      fresh identifiers (cmp.c:380-392);
    * the model stays on the card between calls: :attr:`model` is an
      int32 tensor of sign-extended i16 values on the compressor's
      device, seeded from a primary block's uploaded samples and replaced
      by the EMA update (cmp.c:120-129) of each block's uploaded samples,
      out of place, so a MODEL block copies only its samples up and its
      frame down.  Reading :attr:`model` copies nothing; assigning one (a
      numpy i16 or u16 array, as the JAX package carries it, or a tensor)
      uploads or converts it once, so one chain can move between the two
      (``np.asarray(lc.model.cpu())`` reads it back).

    With ``mesh`` each rank passes its part of every stream and keeps its
    part of the model on ``mesh.device``; :meth:`compress` returns the
    frame on rank 0 and None on the others.  Identifiers are drawn on
    rank 0 and broadcast, so every rank's chain state stays equal.
    """

    def __init__(self, params: CmpParams, device="cuda",
                 mesh: "Mesh | None" = None):
        params.validate()
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else _build.resolve_device(device))
        self.params = params
        self.seq = 0
        self.identifier = 0
        self.model = None
        self._n: "int | None" = None
        # reference cmp_initialise ends in cmp_reset, which draws an
        # identifier (cmp.c:203-208, :452-465); every primary-pass reset
        # then draws another
        self.reset()

    def _draw(self, k: int = 1) -> int:
        """The last of ``k`` identifier draws (on rank 0 of a mesh, which
        broadcasts it)."""
        if self.mesh is not None and self.mesh.rank:
            ident = 0
        else:
            for _ in range(k):
                ident = _context._new_identifier()
        if self.mesh is None:
            return ident
        return int(self.mesh.broadcast(
            torch.tensor([ident], dtype=torch.int64))[0])

    def _get_model(self) -> "torch.Tensor | None":
        return self._model

    def _set_model(self, value) -> None:
        self._model = (None if value is None
                       else _model_tensor(value, self.device))
        # whether the next MODEL block finds its model already on the card
        self._resident = self._model is value

    model = property(_get_model, _set_model, doc="""The chain's model:
        int32 (sign-extended i16 values) on the compressor's device, or
        None before a primary block.""")

    def reset(self) -> None:
        self.seq = 0
        self.identifier = self._draw()

    def _compress(self, params, x_np, seq: int, model=None,
                  secondary: bool = False):
        """(frame or None, its size, the samples as uploaded) on every
        rank."""
        if self.mesh is not None:
            return _compress_split(self.mesh, params, x_np, self.identifier,
                                   seq, model, secondary)
        frame, x = _compress_one(params, x_np, self.identifier, seq, model,
                                 secondary, self.device)
        return frame, len(frame), x

    def _keep(self, model: torch.Tensor, n: int) -> None:
        """The chain's next model, made on the card from a block of ``n``
        samples."""
        self._model = model
        self._resident = True
        self._n = n

    def compress(self, samples_u16) -> "bytes | None":
        x_np = _host_samples(samples_u16)
        primary = (self.seq == 0
                   or self.seq > self.params.secondary_iterations)
        if primary:
            self.reset()
        elif self.params.model_is_needed() and x_np.size != self._n:
            raise CmpError(CmpErrorCode.SRC_SIZE_MISMATCH)
        secondary = not primary
        cfg = make_pass_config(self.params, secondary)
        model_in = self._model if cfg.prep == int(Preprocessing.MODEL) \
            else None
        frame, size, x = self._compress(self.params, x_np, self.seq,
                                        model_in, secondary)
        if model_in is not None:
            global model_blocks, model_resident_blocks
            model_blocks += 1
            model_resident_blocks += self._resident

        n = x_np.size * (1 if self.mesh is None else self.mesh.size)
        unc_size = CMP_HDR_SIZE + 2 * n \
            + (4 if self.params.checksum_enabled else 0)
        if self.params.uncompressed_fallback_enabled and size > unc_size:
            # reference fallback: generic reset + engine reset draw two
            # fresh identifiers; the frame becomes NONE + UNCOMPRESSED at
            # seq 0
            self.identifier = self._draw(2)
            fb_params = dataclasses.replace(
                self.params,
                primary_preprocessing=Preprocessing.NONE,
                primary_encoder_type=EncoderType.UNCOMPRESSED)
            frame, _, x = self._compress(fb_params, x_np, 0)
            self._keep(x, x_np.size)
            self.seq = 1
            return frame

        if self.params.model_is_needed():
            with _step("chain.update"):
                if self.seq == 0:
                    self._keep(x, x_np.size)
                else:
                    # a new tensor: a model read before the block still
                    # holds the state it was read in
                    self._keep(preprocess.model_update(
                        x, self._model, self.params.model_rate,
                        unsigned=True), x_np.size)
        self.seq += 1
        return frame
