"""Batch compressor and decompressor over B lockstep chains.

Port of ``airs_compression_tpu/models/stream.py`` (the batch round trip,
the packed stream and the file-stream decode).  :class:`BatchCompressor`
drives the encoder (ops/encode.py, fixed-rate or adaptive) over B
independent block chains: one call compresses one frame per chain,
advancing every chain's pass state (sequence number, identifier, model)
with the exact semantics of B independent reference contexts processed in
block order (reference cmp.c:213-393).  It returns the frames as a list of
bytes or as one packed stream, assembled on the device (kernel K5).
:class:`BatchDecompressor` takes each block's decode configuration from
its header, decodes on the device (ops/decode.py), verifies the bitstream
length and the XXH32 trailer, and carries the model on the decode side;
frames come as a list of bytes, as spans of one stream staged on the host
(:meth:`~BatchDecompressor.stage_frames_at`), or as spans of one stream
uploaded once and gathered on the device
(:meth:`~BatchDecompressor.decompress_file_stream`).

Host responsibilities: identifier draws from the process timestamp source
in block order, including the double draw on an uncompressed fallback
(cmp.c:380-392 + engine re-reset), with fallen-back frames' header
identifier bytes patched after encoding; header parsing and validation of
the frames to decode (the native host core, native/airs_host.cpp, with
the numpy checks kept as its plain twin).

Mixed-phase batches (some chains on a primary pass, others on secondary —
possible after a fallback resets one chain) are encoded under both pass
configs and selected per block; on decode, each method group present in
the headers is decoded and selected per block.

Stateless streams may decode several batches in one launch
(``coalesce=`` on :meth:`BatchDecompressor.decompress_stream` and
:meth:`~BatchDecompressor.decompress_file_stream`): their rows are
stacked and K3 (and K4 where checksummed) runs once over the group.

Under ``torch.profiler`` each batch's host stages are flat spans
(utils/profiling.span): ``stream.upload`` (staging and host-to-device
copies), ``stream.stage`` (header staging), ``stream.dispatch`` (the
device work's launches), ``stream.fetch`` (device-to-host copies, with
the wait for the device work queued before them, and the checks that
read them) and ``stream.cast`` (the decoded samples' u16 view).  Every
copy between the host and the device goes through :func:`_upload` or
:func:`_fetch`, which count the bytes that cross between the host's
pageable memory and a CUDA device; :data:`encoded_batches` and
:data:`decoded_batches` count the batches.
"""

from __future__ import annotations

import collections
import dataclasses
import sys

import numpy as np
import torch

from .. import _build, native
from ..engine import context as _context
from ..format.dtypes import CmpType
from ..format.errors import CmpError, CmpErrorCode
from ..format.header import CMP_HDR_MAX_SIZE, CMP_HDR_SIZE, parse_headers_batch
from ..format.params import CmpParams, Preprocessing
from ..ops.adapt import DEFAULT_LADDER
from ..ops.assemble import assemble_stream, be_bytes
from ..ops.decode import decode_blocks_device, decode_blocks_uncompressed
from ..ops.encode import (
    PassConfig,
    adaptive_worst_case_words,
    encode_blocks_adaptive,
    encode_blocks_device,
    make_pass_config,
    model_update_step,
    worst_case_words,
)
from ..ops.u32 import MASK, from_bits, to_bits
from ..ops.xxh32_device import checksum_blocks_device
from ..utils.profiling import span

__all__ = ["BatchCompressor", "BatchDecompressor", "StagedFrames",
           "DecodedFrames", "DeviceStream"]

_LITTLE = sys.byteorder == "little"

#: batches encoded (:meth:`BatchCompressor._encode_frames`) and decoded
#: (:meth:`BatchDecompressor.finish`) in this process
encoded_batches = 0
decoded_batches = 0


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


def _fetch_u16(samples: torch.Tensor) -> np.ndarray:
    """(R, N) int32 samples as a caller-owned C-contiguous int16 array of
    their low 16 bits (the bits ``astype(np.uint16)`` keeps), narrowed on
    the samples' device so that half the bytes cross; the caller views
    it as uint16.  On the CPU the narrowed tensor's memory is returned,
    with no copy."""
    return _fetch(samples.to(torch.int16))


def _bytes_to_be_words(buf: np.ndarray, device) -> torch.Tensor:
    """(B, 4W) uint8 big-endian bytes -> (B, W) int32 word bits on device."""
    B, stride = buf.shape
    b = _upload(buf, device)
    if _LITTLE:
        b = b.reshape(B, stride // 4, 4).flip(-1).reshape(B, stride)
    return b.view(torch.int32)


class BatchCompressor:
    """Compress sequences of (B, N) u16 frames on the device, AIRSPACE-exact.

    ``adaptive=True`` picks every block's Golomb parameter from ``ladder``
    (default :data:`~airs_compression_tpu_torch.ops.adapt.DEFAULT_LADDER`)
    on GOLOMB_ZERO and GOLOMB_MULTI passes (ops/adapt.py).

    ``device`` defaults to ``"cuda"`` and raises where CUDA is absent;
    ``device="cpu"`` runs the kernels' plain PyTorch versions.
    """

    def __init__(self, params: CmpParams, batch: int, n_samples: int,
                 cmp_type: CmpType = CmpType.U16, adaptive: bool = False,
                 ladder=None, device="cuda"):
        params.validate()
        if 2 * n_samples > (1 << 24) - 1:
            raise CmpError(CmpErrorCode.HDR_ORIGINAL_TOO_LARGE)
        self.device = _build.resolve_device(device)
        self.params = params
        self.batch = batch
        self.n_samples = n_samples
        self.cmp_type = cmp_type
        self.primary_cfg = make_pass_config(params, False)
        self.secondary_cfg = (make_pass_config(params, True)
                              if params.secondary_iterations else None)
        self.fallback_cfg = None
        if params.uncompressed_fallback_enabled:
            fb_params = dataclasses.replace(
                params, primary_preprocessing=Preprocessing.NONE,
                primary_encoder_type=0)
            self.fallback_cfg = make_pass_config(fb_params, False)
        self.adaptive = adaptive
        self.ladder = (tuple(ladder) if ladder else DEFAULT_LADDER) \
            if adaptive else None
        passes = [c for c in (self.primary_cfg, self.secondary_cfg)
                  if c is not None]
        caps = [worst_case_words(c, n_samples) for c in passes]
        if adaptive:
            caps += [adaptive_worst_case_words(c, n_samples, self.ladder)
                     for c in passes if c.enc_type in (1, 2)]
        self.n_words = max(caps)
        # per-chain state (host side mirrors of reference cmp_context)
        self.seq = np.zeros(batch, dtype=np.int64)
        self.identifiers = np.zeros(batch, dtype=np.int64)
        self.model = torch.zeros((batch, n_samples), dtype=torch.int32,
                                 device=self.device)
        self._started = np.zeros(batch, dtype=bool)

    def load_state(self, model, seq, identifiers, started) -> None:
        """Continue chains from another compressor's state (numpy arrays
        read off a JAX-side ``BatchCompressor``: ``model``, ``seq``,
        ``identifiers``, ``_started``)."""
        model = np.asarray(model, dtype=np.int32)
        if model.shape != (self.batch, self.n_samples):
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                           f"model shape {model.shape}")
        self.model = _upload(model.copy(), self.device)
        self.seq = np.array(seq, dtype=np.int64)
        self.identifiers = np.array(identifiers, dtype=np.int64)
        self._started = np.array(started, dtype=bool)

    # -- identifier bookkeeping (block order, like sequential C contexts) --
    def _draw_ids(self, mask: np.ndarray) -> None:
        idxs = np.nonzero(mask)[0]
        if idxs.size:
            # one bulk draw, in block order like sequential C contexts
            self.identifiers[idxs] = _context._new_identifiers(idxs.size) \
                .astype(np.int64)

    def reset(self) -> None:
        """Reset every chain (reference cmp_reset semantics per block)."""
        self.seq[:] = 0
        self._draw_ids(np.ones(self.batch, dtype=bool))
        self._started[:] = False

    # -- main entry ------------------------------------------------------
    def _encode_frames(self, frames):
        """Encode one (B, N) frame per chain and advance the chain state.

        Returns ``(words, sizes, sizes_np, fell_np)``: the (B, n_words)
        int64 u32 frame words and the (B,) int32 frame sizes on the device,
        and the frame sizes and fallback flags on the host.  Fallback rows
        still carry the pre-reset identifier — the callers patch bytes
        8:14 from ``self.identifiers`` (:meth:`_patch_ids`).
        """
        global encoded_batches
        with span("stream.upload"):
            staged = self._upload_frames(frames)
        with span("stream.dispatch"):
            words, sizes, fell_back = self._queue_passes(*staged)
        with span("stream.fetch"):
            sizes_np = _fetch(sizes)
            fell_np = _fetch(fell_back)
        # sequence transitions: normal pass -> seq+1; fallback -> chain was
        # reset and the uncompressed pass ran at seq 0 -> next seq is 1
        self.seq = np.where(fell_np, 1, self.seq + 1)
        # the reference draws two fresh identifiers on fallback (generic
        # reset + engine reset, cmp.c:380-392), keeping the second
        fb = np.nonzero(fell_np)[0]
        if fb.size:
            ids = _context._new_identifiers(2 * fb.size)[1::2]
            self.identifiers[fb] = ids.astype(np.int64)
        encoded_batches += 1
        return words, sizes, sizes_np, fell_np

    def _upload_frames(self, frames):
        """Take the frames' low 16 bits as u16, select each chain's pass
        and upload the samples (sign-extended int32 on the device),
        sequence numbers and identifiers; returns them with the (B,)
        primary-pass mask.  A C-ordered, writeable u16 array is uploaded
        as it is, with no host copy."""
        arr = np.asarray(frames)
        if self.cmp_type is CmpType.I16_IN_I32:
            if arr.dtype.itemsize != 4:
                raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                               "I16_IN_I32 input must be 32-bit words")
            arr = arr & 0xFFFF
        if arr.shape != (self.batch, self.n_samples):
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                           f"expected {(self.batch, self.n_samples)}, "
                           f"got {arr.shape}")
        x_np = np.require(arr.astype(np.uint16, copy=False),
                          requirements=["C", "W"])

        # pass selection per chain (cmp.c:228-248)
        primary_mask = ((self.seq == 0)
                        | (self.seq > self.params.secondary_iterations))
        # chains entering a primary pass reset: seq->0, fresh identifier
        self.seq[primary_mask] = 0
        self._draw_ids(primary_mask)

        dev = self.device
        x = _upload(x_np.view(np.int16), dev).to(torch.int32)
        seq_dev = _upload(self.seq.astype(np.int32), dev)
        id_hi = _upload((self.identifiers >> 24) & 0xFFFFFF, dev)
        id_lo = _upload(self.identifiers & 0xFFFFFF, dev)
        return x, seq_dev, id_hi, id_lo, primary_mask

    def _queue_passes(self, x, seq_dev, id_hi, id_lo, primary_mask):
        """Queue the checksums, the pass or passes and their select, and
        the model update; returns ``(words, sizes, fell_back)`` on the
        device."""
        dev = self.device
        if self.params.checksum_enabled:
            checksum = checksum_blocks_device(x)
        else:
            checksum = torch.zeros((self.batch,), dtype=torch.int64,
                                   device=dev)

        def run(cfg):
            if self.adaptive and cfg.enc_type in (1, 2):  # ZERO or MULTI
                return encode_blocks_adaptive(
                    cfg, self.fallback_cfg, x, self.model, seq_dev, id_hi,
                    id_lo, checksum, self.n_words, self.ladder)[:3]
            return encode_blocks_device(cfg, self.fallback_cfg, x, self.model,
                                        seq_dev, id_hi, id_lo, checksum,
                                        self.n_words)

        if primary_mask.all() or self.secondary_cfg is None:
            words, sizes, fell_back = run(self.primary_cfg)
        elif not primary_mask.any():
            words, sizes, fell_back = run(self.secondary_cfg)
        else:
            w_p, s_p, f_p = run(self.primary_cfg)
            w_s, s_s, f_s = run(self.secondary_cfg)
            pm = _upload(primary_mask, dev)
            words = torch.where(pm[:, None], w_p, w_s)
            sizes = torch.where(pm, s_p, s_s)
            fell_back = torch.where(pm, f_p, f_s)

        # model transition (only meaningful when the chain keeps a model)
        if self.params.model_is_needed():
            self.model = model_update_step(
                x, self.model, seq_dev, fell_back, self.params.model_rate,
                self.cmp_type is CmpType.U16)
        return words, sizes, fell_back

    def _patch_ids(self, buf, starts, fell_np) -> None:
        """Write the fresh identifier of every fallen-back block into its
        frame's header bytes 8:14 (``buf`` a flat uint8 array, frame b at
        ``starts[b]``)."""
        for b in np.nonzero(fell_np)[0]:
            at = int(starts[b]) + 8
            buf[at: at + 6] = np.frombuffer(
                int(self.identifiers[b]).to_bytes(6, "big"), np.uint8)

    def compress_frames(self, frames) -> "list[bytes]":
        """Compress one (B, N) frame per chain; returns B AIRSPACE frames.

        Input dtype follows the constructor's ``cmp_type`` (reference
        sample_reader.h:9-78): U16/I16 take (B, N) 16-bit samples;
        I16_IN_I32 takes (B, N) int32 words whose low 16 bits are the
        samples (``original_size`` stays 2N — the *packed* size).
        """
        words, _, sizes_np, fell_np = self._encode_frames(frames)
        with span("stream.dispatch"):
            rb = be_bytes(words)
        with span("stream.fetch"):
            rb = _fetch(rb).reshape(-1)
        stride = self.n_words * 4
        self._patch_ids(rb, np.arange(self.batch) * stride, fell_np)
        return [rb[b * stride: b * stride + int(sizes_np[b])].tobytes()
                for b in range(self.batch)]

    def compress_frames_packed(self, frames, as_array: bool = False):
        """Compress one (B, N) frame per chain into ONE packed stream.

        Returns ``(stream, sizes)``: the B frames concatenated in block
        order (the AIRSPACE stream/file layout, reference
        programs/file.c:435-488), as ``bytes`` or, with ``as_array=True``,
        a uint8 numpy array, and the (B,) int32 frame sizes.  The frames
        are assembled on the device (kernel K5), so only the compressed
        bytes come back to the host.
        """
        words, sizes, sizes_np, fell_np = self._encode_frames(frames)
        with span("stream.dispatch"):
            arr = assemble_stream(words, sizes, int(sizes_np.sum()))
        with span("stream.fetch"):
            arr = _fetch(arr)
        starts = np.cumsum(sizes_np, dtype=np.int64) - sizes_np
        self._patch_ids(arr, starts, fell_np)
        return (arr if as_array else arr.tobytes()), sizes_np


@dataclasses.dataclass
class StagedFrames:
    """A staged batch: parsed header columns, plus the frame bytes.

    Host-staged (:meth:`BatchDecompressor.stage_frames`,
    :meth:`~BatchDecompressor.stage_frames_at`): ``buf`` holds the frames
    zero-padded to ``4 * n_words`` bytes.  Header-staged
    (:meth:`~BatchDecompressor.stage_headers_at`): ``buf`` is None and
    ``row_off``/``row_len`` locate the frames in a stream uploaded to the
    device, where :meth:`~BatchDecompressor.decode_staged_from` gathers
    them.
    """

    buf: "np.ndarray | None"     # (B, 4 * n_words) uint8, frames zero-padded
    n_words: int                 # decode row width in u32 words
    prep: "np.ndarray"           # (B,) int32
    enc: "np.ndarray"            # (B,) int32
    cs: "np.ndarray"             # (B,) int32 0/1
    seq: "np.ndarray"            # (B,) int32
    g: "np.ndarray"              # (B,) uint32
    outlier: "np.ndarray"        # (B,) uint32
    csize: "np.ndarray"          # (B,) int64
    stored_csum: "np.ndarray"    # (B,) uint32 (0 where cs == 0)
    row_off: "np.ndarray | None" = None   # (B,) int64 byte offsets
    row_len: "np.ndarray | None" = None   # (B,) int64 byte lengths
    # every block has block 0's method byte and encoder parameters (the
    # lockstep case): decode_staged then skips its method-group scan
    uniform: bool = False


def _combine_staged(sts: "list[StagedFrames]", nw: int) -> StagedFrames:
    """The header columns of several stagings as one batch of their rows
    (a coalesced launch's metadata); ``buf`` is None, the spans are
    concatenated where every member has them."""
    cat = np.concatenate
    firsts = {(int(s.prep[0]), int(s.enc[0]), int(s.cs[0]), int(s.g[0]),
               int(s.outlier[0])) for s in sts if s.prep.size}
    both = all(s.row_off is not None for s in sts)
    return StagedFrames(
        buf=None, n_words=nw,
        prep=cat([s.prep for s in sts]), enc=cat([s.enc for s in sts]),
        cs=cat([s.cs for s in sts]), seq=cat([s.seq for s in sts]),
        g=cat([s.g for s in sts]), outlier=cat([s.outlier for s in sts]),
        csize=cat([s.csize for s in sts]),
        stored_csum=cat([s.stored_csum for s in sts]),
        row_off=cat([s.row_off for s in sts]) if both else None,
        row_len=cat([s.row_len for s in sts]) if both else None,
        uniform=all(s.uniform for s in sts) and len(firsts) <= 1)


class _GroupFetch:
    """The outputs of one launch (a coalesced group's stacked rows, or one
    batch), fetched to the host once, not once a member: the end bits and
    checksums at the first member's checks, the samples once a member has
    passed them; the members window the host arrays."""

    __slots__ = ("samples", "end_bits", "csum", "_checks", "_samples")

    def __init__(self, samples, end_bits, csum):
        self.samples, self.end_bits, self.csum = samples, end_bits, csum
        self._checks = self._samples = None

    def checks(self):
        """(end bits as int64, computed checksums or None) on the host."""
        if self._checks is None:
            self._checks = (
                _fetch(self.end_bits).astype(np.int64),
                None if self.csum is None else _fetch(self.csum))
        return self._checks

    def host_samples(self) -> np.ndarray:
        """The samples' low 16 bits on the host (:func:`_fetch_u16`)."""
        if self._samples is None:
            self._samples = _fetch_u16(self.samples)
        return self._samples


@dataclasses.dataclass
class DecodedFrames:
    """Device-side decode result, integrity checks not yet applied.

    For a member of a coalesced launch, ``group`` is the launch's shared
    :class:`_GroupFetch` and ``lo`` the member's first row in it; then
    ``samples``/``end_bits``/``csum`` are the whole group's tensors, and
    :meth:`BatchDecompressor.finish` windows the group's one host fetch.
    """

    samples: torch.Tensor                # (B, N) int32
    end_bits: torch.Tensor               # (B,) payload end bit position
    csum: "torch.Tensor | None"          # (B,) int64 computed XXH32, or None
    group: "_GroupFetch | None" = None
    lo: int = 0


@dataclasses.dataclass(frozen=True)
class DeviceStream:
    """A compressed stream resident on the device (see
    :meth:`BatchDecompressor.upload_stream`)."""

    data: torch.Tensor   # (nbytes + guard,) uint8, length a multiple of 4
    nbytes: int          # valid stream length in bytes


def _gather_rows_device(data: torch.Tensor, offsets: torch.Tensor,
                        lens: torch.Tensor, nw: int) -> torch.Tensor:
    """(B, nw) int32 BE frame words gathered from a device-resident stream.

    Frames start at arbitrary byte offsets, so each row gathers nw + 1
    words at word granularity and funnel-shifts them by the byte
    remainder; bytes past each frame's length are zeroed, as the host
    staging's zero padding does.  ``offsets``/``lens`` are (B,) int64.
    """
    quads = data.view(-1, 4)
    W = quads.shape[0]
    idx = (offsets >> 2)[:, None] + torch.arange(nw + 1,
                                                 device=data.device)[None, :]
    q = quads[idx.clamp(0, W - 1)]
    if _LITTLE:
        q = q.flip(-1)
    rows = from_bits(q.contiguous().view(torch.int32)[..., 0])
    s = ((offsets & 3) * 8)[:, None]
    hi, lo = rows[:, :-1], rows[:, 1:]
    w = ((hi << s) & MASK) | (lo >> (32 - s))   # lo >> 32 is 0
    # word j keeps its top (len - 4j) bytes, none past the frame's end
    j4 = 4 * torch.arange(nw, device=data.device)[None, :]
    keep = (lens[:, None] - j4).clamp(0, 4) * 8
    return to_bits(w & ((MASK << (32 - keep)) & MASK))


# Staging validation outcomes by rank (same ordered check list as the JAX
# package's staging, so a given corrupt batch raises the same error)
_STAGE_CHECK_ERRORS = (
    (CmpErrorCode.INT_HDR, "header truncated"),
    (CmpErrorCode.INT_HDR, "extended header truncated"),
    (CmpErrorCode.INT_HDR, "frame shorter than header compressed_size"),
    (CmpErrorCode.SRC_SIZE_MISMATCH, None),
    (CmpErrorCode.INT_HDR, "unknown method"),
    (CmpErrorCode.PARAMS_INVALID, "bad Golomb parameter in header"),
    (CmpErrorCode.INT_HDR, "MODEL preprocessing on a primary pass"),
)


class BatchDecompressor:
    """Device decode of lockstep chains: B frames per call, model carried.

    The decode configuration of every block is taken from its parsed
    HEADER (method byte at offset 15, per-block ``encoder_param``/
    ``encoder_outlier`` in the extension, reference header.c:89-134), so
    mixed primary/secondary batches, adaptive streams and
    uncompressed-fallback frames decode exactly.

    Integrity contract (reference header.c:137-163): a block whose payload
    runs past its ``compressed_size`` raises ``CmpError(INT_BITSTREAM)``;
    blocks whose method byte carries the checksum bit are verified against
    their trailing XXH32 and a mismatch raises ``CmpError(GENERIC)``.
    ``verify_checksum=False`` opts out of the latter.

    ``device`` defaults to ``"cuda"`` and raises where CUDA is absent;
    ``device="cpu"`` runs the kernels' plain PyTorch versions.
    """

    #: rows per coalesced launch when ``coalesce`` is automatic: the JAX
    #: package's value (four of its decoder's 1024-lane tiles), kept so
    #: both packages group alike.  K3 runs one CTA a row at any row
    #: count, and the group size changes no output byte; tuning it for
    #: the H100 is later work.
    COALESCE_LANES = 4096

    def __init__(self, params: CmpParams, batch: int, n_samples: int,
                 cmp_type: CmpType = CmpType.U16,
                 verify_checksum: bool = True, device="cuda"):
        params.validate()
        self.device = _build.resolve_device(device)
        self.params = params
        self.batch = batch
        self.n_samples = n_samples
        self.cmp_type = cmp_type
        self.verify_checksum = verify_checksum
        self.model = torch.zeros((batch, n_samples), dtype=torch.int32,
                                 device=self.device)

    def load_state(self, model) -> None:
        """Continue from another decompressor's model (numpy array read
        off a JAX-side ``BatchDecompressor``)."""
        model = np.asarray(model, dtype=np.int32)
        if model.shape != (self.batch, self.n_samples):
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                           f"model shape {model.shape}")
        self.model = _upload(model.copy(), self.device)

    def _group_cfg(self, prep: int, enc: int, cs: int) -> PassConfig:
        """Decode PassConfig for one header method group.  The Golomb
        parameters travel per block (the headers' columns), so the config
        carries none."""
        return PassConfig(prep, enc, 0, 0, bool(cs), self.params.model_rate)

    # -- staging (host: the native core) -----------------------------------
    def stage_frames(self, frames: "list[bytes]") -> StagedFrames:
        """Parse + validate B frames into one zero-padded byte matrix.

        One join and one C scatter stage the frames (a memcpy and a tail
        memset a row), then one C pass parses and validates the headers
        and reads the checksum trailers (``native.stage_parse``), with the
        host decoder's per-frame check order: the first offending block
        raises its first failing check.
        """
        if len(frames) != self.batch:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG)
        with span("stream.stage"):
            lens = np.fromiter((len(f) for f in frames), np.int64,
                               count=self.batch)
            n_words, stride = self._staging_geometry(lens)
            buf = np.empty((self.batch, stride), np.uint8)  # C zeroes tails
            native.scatter_rows(b"".join(frames), lens, stride, buf)
            return self._stage_native(buf, lens, n_words)

    def _spans(self, stream, offsets, lens):
        """Validated (offsets, lens) int64 arrays of B frames in
        ``stream``; spans outside it raise ``SRC_SIZE_WRONG``."""
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        lens = np.ascontiguousarray(lens, dtype=np.int64)
        if lens.size != self.batch or offsets.size != self.batch:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG)
        if (offsets < 0).any() or (lens < 0).any() or (
                offsets + lens > len(stream)).any():
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                           "frame spans exceed the stream buffer")
        return offsets, lens

    def stage_frames_at(self, stream, offsets, lens) -> StagedFrames:
        """Stage B frames that live inside ONE contiguous buffer.

        The concatenated-stream (file) decode path: ``stream`` is bytes, a
        bytearray or a uint8 array (e.g.
        :meth:`BatchCompressor.compress_frames_packed` output), read in
        place, and the frames are located by (offset, length) pairs.  One
        C scatter straight from ``stream``, then the parse of
        :meth:`stage_frames`.
        """
        with span("stream.stage"):
            offsets, lens = self._spans(stream, offsets, lens)
            n_words, stride = self._staging_geometry(lens)
            buf = np.empty((self.batch, stride), np.uint8)  # C zeroes tails
            native.scatter_rows_at(stream, offsets, lens, stride, buf)
            return self._stage_native(buf, lens, n_words)

    def _stage_plain_at(self, stream, offsets, lens) -> StagedFrames:
        """Plain twin of :meth:`stage_frames_at` (and, but for the spans,
        of :meth:`stage_headers_at`): a numpy copy a row, then
        :meth:`_stage_from_buf`."""
        offsets, lens = self._spans(stream, offsets, lens)
        n_words, stride = self._staging_geometry(lens)
        buf = np.zeros((self.batch, stride), np.uint8)
        sv = np.frombuffer(stream, np.uint8)
        for b in range(self.batch):
            buf[b, : lens[b]] = sv[offsets[b]: offsets[b] + lens[b]]
        return self._stage_from_buf(buf, lens, n_words)

    @staticmethod
    def _staging_geometry(lens: "np.ndarray") -> "tuple[int, int]":
        max_len = int(lens.max()) if lens.size else 0
        n_words = (max_len + 3) // 4 + 2
        # width bucketed to a power of two as in the JAX package; the floor
        # keeps stride >= CMP_HDR_MAX_SIZE so the vectorized header parse
        # is in bounds even when EVERY frame is truncated, and the >= 2
        # spare words keep the decoder's reads past a frame on zeros
        n_words = 1 << max((n_words - 1).bit_length(), 3)
        return n_words, n_words * 4

    def _check_headers(self, h, lens: "np.ndarray") -> None:
        """Raise the first failing check of the first failing frame.

        Same per-frame order as CmpHeader.deserialize + the host decoder's
        guards; predicate order matches _STAGE_CHECK_ERRORS.
        """
        checks = (
            lens < CMP_HDR_SIZE,
            h.has_extension & (lens < CMP_HDR_MAX_SIZE),
            lens < h.compressed_size,
            h.original_size != 2 * self.n_samples,
            (h.preprocessing > 3) | (h.encoder_type > 2),
            ((h.encoder_type != 0)
             & ~((1 <= h.encoder_param) & (h.encoder_param <= 0xFFFF))),
            # MODEL preprocessing needs prior chain state; no encoder emits
            # it on a primary pass (reference cmp.c:228-254)
            (h.preprocessing == 3) & (h.sequence_number == 0),
        )
        fail_rank = np.full(lens.shape[0], len(checks), np.int64)
        for rank, bad in reversed(list(enumerate(checks))):
            fail_rank = np.where(bad, rank, fail_rank)
        bad_blocks = np.nonzero(fail_rank < len(checks))[0]
        if bad_blocks.size:
            b = int(bad_blocks[0])
            code, msg = _STAGE_CHECK_ERRORS[int(fail_rank[b])]
            raise CmpError(code, None if msg is None
                           else f"block {b}: {msg}")

    @staticmethod
    def _stored_checksums(h, trailer: "np.ndarray") -> "np.ndarray":
        """(B,) uint32 stored XXH32 from each frame's (B, 4) trailing
        bytes (BE u32 at compressed_size - 4), 0 where cs == 0."""
        tb = trailer.astype(np.uint32)
        stored = ((tb[:, 0] << 24) | (tb[:, 1] << 16)
                  | (tb[:, 2] << 8) | tb[:, 3])
        return np.where(h.checksum_enabled != 0, stored, 0).astype(np.uint32)

    @staticmethod
    def _staged(res, **where) -> StagedFrames:
        """A StagedFrames from ``native.stage_parse``'s result; a failed
        check raises its ``_STAGE_CHECK_ERRORS`` entry."""
        if len(res) == 2:
            rank, block = res
            code, msg = _STAGE_CHECK_ERRORS[rank]
            raise CmpError(code, None if msg is None
                           else f"block {block}: {msg}")
        prep, enc, cs, seq, g, outlier, csize, stored, uniform = res
        return StagedFrames(prep=prep, enc=enc, cs=cs, seq=seq, g=g,
                            outlier=outlier, csize=csize, stored_csum=stored,
                            uniform=uniform, **where)

    def _stage_native(self, buf: "np.ndarray", lens: "np.ndarray",
                      n_words: int) -> StagedFrames:
        return self._staged(native.stage_parse(buf, lens, self.n_samples),
                            buf=buf, n_words=n_words)

    def _stage_from_buf(self, buf: "np.ndarray", lens: "np.ndarray",
                        n_words: int) -> StagedFrames:
        """Plain twin of :meth:`_stage_native`: the numpy parse, checks
        and trailer read."""
        stride = n_words * 4
        h = parse_headers_batch(buf)
        self._check_headers(h, lens)
        idx = np.clip(h.compressed_size[:, None] - 4
                      + np.arange(4)[None, :], 0, stride - 1)
        firsts = [(c == c[0]).all() for c in (
            h.preprocessing, h.encoder_type, h.checksum_enabled,
            h.encoder_param, h.encoder_outlier)] if lens.size else []
        return StagedFrames(
            buf=buf, n_words=n_words,
            prep=h.preprocessing, enc=h.encoder_type,
            cs=h.checksum_enabled, seq=h.sequence_number,
            g=h.encoder_param, outlier=h.encoder_outlier,
            csize=h.compressed_size,
            stored_csum=self._stored_checksums(
                h, np.take_along_axis(buf, idx, axis=1)),
            uniform=bool(all(firsts)))

    # -- device-staged decode (stream resident on the device) -------------
    def upload_stream(self, stream) -> DeviceStream:
        """Upload a compressed stream (bytes or uint8 array) once.

        Pads to word alignment plus two guard words (the row gather reads
        one word past each frame's span before masking).  Pair with
        :meth:`stage_headers_at` + :meth:`decode_staged_from`: the host
        touches only the headers, and the host-to-device transfer carries
        the compressed bytes.
        """
        n = len(stream)
        with span("stream.upload"):
            arr = np.zeros(n + (-n) % 4 + 8, np.uint8)
            arr[:n] = np.frombuffer(stream, np.uint8)
            return DeviceStream(data=_upload(arr, self.device), nbytes=n)

    def stage_headers_at(self, stream, offsets, lens) -> StagedFrames:
        """Header-only staging for device-staged decode.

        Parses and validates every frame header straight out of
        ``stream`` (``native.stage_parse_at``: some thirty bytes read a
        frame), with the checks and order of :meth:`stage_frames_at`,
        without copying payloads: the result carries the frame spans
        (``row_off``/``row_len``) and no ``buf``;
        :meth:`decode_staged_from` gathers the rows on the device.
        """
        with span("stream.stage"):
            offsets, lens = self._spans(stream, offsets, lens)
            n_words, _ = self._staging_geometry(lens)
            return self._staged(
                native.stage_parse_at(stream, offsets, lens, self.n_samples),
                buf=None, n_words=n_words, row_off=offsets, row_len=lens)

    def decode_staged_from(self, st: StagedFrames,
                           ds: DeviceStream) -> DecodedFrames:
        """Decode a header-staged batch straight from the device stream:
        one row gather on the device, then :meth:`decode_staged`."""
        if st.row_off is None:
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           "decode_staged_from needs stage_headers_at "
                           "staging (row spans missing)")
        with span("stream.dispatch"):
            return self._decode_from(st, ds)

    def _decode_from(self, st: StagedFrames,
                     ds: DeviceStream) -> DecodedFrames:
        dev = self.device
        words = _gather_rows_device(
            ds.data, _upload(st.row_off, dev), _upload(st.row_len, dev),
            st.n_words)
        return self._decode(st, words)

    # -- device decode ----------------------------------------------------
    def decode_staged(self, st: StagedFrames,
                      words: "torch.Tensor | None" = None) -> DecodedFrames:
        """Run the device decode for a staged batch; everything returned
        stays on the device.  ``words`` (B, n_words) int32 BE word bits on
        the device replaces the upload of ``st.buf`` (the device-staged
        path).  The model-chain transition happens here, so back-to-back
        calls chain correctly before their :meth:`finish`.

        A staging of other than ``batch`` rows is a coalesced launch
        (:meth:`decode_staged_multi`): stateless, so its MODEL frames, if
        any, decode against a zero model, and no model is carried."""
        if words is None:
            if st.buf is None:
                raise CmpError(CmpErrorCode.PARAMS_INVALID,
                               "header-staged batch: decode it with "
                               "decode_staged_from")
            with span("stream.upload"):
                words = _bytes_to_be_words(st.buf, self.device)
        with span("stream.dispatch"):
            return self._decode(st, words)

    def _decode(self, st: StagedFrames, words: torch.Tensor) -> DecodedFrames:
        """:meth:`decode_staged` of uploaded words, with no span."""
        B = st.prep.shape[0]
        dev = self.device
        model = self.model if B == self.batch else None
        # header-driven dispatch: one device pass per method group present
        # (a uniform staging is one group, no scan needed)
        if st.uniform and B:
            groups = [(int(st.prep[0]), int(st.enc[0]), int(st.cs[0]), None)]
        else:
            key = st.prep.astype(np.int64) * 16 + st.enc * 2 + st.cs
            groups = [(k // 16, (k // 2) % 8, k % 2, key == k)
                      for k in map(int, np.unique(key))]
        samples = None
        end_bits = None
        for prep, enc, cs, mask in groups:
            if prep == 0 and enc == 0:
                s = decode_blocks_uncompressed(words, self.n_samples)
                e = torch.full((B,), 128 + 16 * self.n_samples,
                               dtype=torch.int32, device=dev)
            else:
                if prep == 3 and model is None:
                    model = torch.zeros((B, self.n_samples),
                                        dtype=torch.int32, device=dev)
                # full-batch per-lane parameters (lanes outside the group
                # decode garbage, discarded by the select below)
                g, o = st.g, st.outlier
                if mask is not None:
                    g, o = np.where(mask, g, 1), np.where(mask, o, 1)
                s, e = decode_blocks_device(
                    self._group_cfg(prep, enc, cs), words, model,
                    self.n_samples, _upload(g.astype(np.int64), dev),
                    _upload(o.astype(np.int64), dev))
            if samples is None:
                samples, end_bits = s, e
            else:
                m = _upload(mask, dev)
                samples = torch.where(m[:, None], s, samples)
                end_bits = torch.where(m, e, end_bits)

        csum = None
        if self.verify_checksum and (st.cs != 0).any():
            csum = checksum_blocks_device(samples)
        # model transition identical to the encoder's: per-block seq;
        # fallback frames carry seq 0, which reseeds the model exactly as
        # the encoder's fallback reseed does (cmp.c:380-392 + :304-311)
        if self.params.model_is_needed() and B == self.batch:
            self.model = model_update_step(
                samples, model, _upload(st.seq, dev),
                torch.zeros((B,), dtype=torch.bool, device=dev),
                self.params.model_rate, self.cmp_type is CmpType.U16)
        return DecodedFrames(samples=samples, end_bits=end_bits, csum=csum)

    # -- coalesced decode (several batches, one launch) --------------------
    def _check_coalescable(self) -> None:
        if self.params.model_is_needed():
            raise CmpError(
                CmpErrorCode.PARAMS_INVALID,
                "coalesced decode requires stateless (non-MODEL) streams")

    @staticmethod
    def _members(dec: DecodedFrames, sts) -> "list[DecodedFrames]":
        """One DecodedFrames a member of a coalesced launch, sharing one
        host fetch."""
        shared = _GroupFetch(dec.samples, dec.end_bits, dec.csum)
        los = np.cumsum([0] + [s.prep.shape[0] for s in sts[:-1]])
        return [DecodedFrames(samples=dec.samples, end_bits=dec.end_bits,
                              csum=dec.csum, group=shared, lo=int(lo))
                for lo in los]

    def decode_staged_multi(self, sts: "list[StagedFrames]") \
            -> "list[DecodedFrames]":
        """Decode several host-staged batches in ONE launch of K3 (and of
        K4 where checksummed) over their stacked rows.

        Each member is uploaded and its columns padded with zero words to
        the group's widest staging (zeros keep K3's reads past a frame on
        zeros), then the rows are concatenated on the device.  Stateless
        streams only: MODEL preprocessing carries chain state from batch
        to batch, so this raises ``PARAMS_INVALID`` for a decompressor
        whose params need a model.  Returns one DecodedFrames per member,
        in order; finish each against its own staging.
        """
        if len(sts) == 1:
            return [self.decode_staged(sts[0])]
        self._check_coalescable()
        if any(s.buf is None for s in sts):
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           "decode_staged_multi needs host staging "
                           "(header-staged member)")
        nw = max(s.n_words for s in sts)
        with span("stream.upload"):
            parts = [_bytes_to_be_words(s.buf, self.device) for s in sts]
        with span("stream.dispatch"):
            words = torch.cat([torch.nn.functional.pad(
                w, (0, nw - s.n_words)) for w, s in zip(parts, sts)])
            comb = _combine_staged(sts, nw)
            return self._members(self._decode(comb, words), sts)

    def decode_staged_from_multi(self, sts: "list[StagedFrames]",
                                 ds: DeviceStream) -> "list[DecodedFrames]":
        """:meth:`decode_staged_multi` for header-staged batches: one row
        gather over the whole group's spans on the device, then one
        launch.  Stateless streams only."""
        if len(sts) == 1:
            return [self.decode_staged_from(sts[0], ds)]
        self._check_coalescable()
        if any(s.row_off is None for s in sts):
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           "decode_staged_from_multi needs "
                           "stage_headers_at staging (row spans missing)")
        with span("stream.dispatch"):
            comb = _combine_staged(sts, max(s.n_words for s in sts))
            return self._members(self._decode_from(comb, ds), sts)

    def _coalesce_group(self, coalesce: "bool | int | None") -> int:
        """The launch group size that ``coalesce`` asks for.

        ``None``: automatic, up to :attr:`COALESCE_LANES` rows a launch
        and at most 8 batches for a stateless stream, 1 for MODEL.
        ``True``: the automatic size, at least 2; raises on MODEL.
        ``False``: 1.  An int: that size; below 1, or above 1 on MODEL,
        raises ``PARAMS_INVALID``.
        """
        stateful = self.params.model_is_needed()
        auto = min(8, self.COALESCE_LANES // max(self.batch, 1))
        if coalesce is None:
            return 1 if stateful else max(1, auto)
        if coalesce is False:
            return 1
        if coalesce is True:
            if stateful:
                raise CmpError(
                    CmpErrorCode.PARAMS_INVALID,
                    "coalesced decode requires stateless (non-MODEL) "
                    "streams")
            return max(2, auto)
        group = int(coalesce)
        if group < 1:
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           f"coalesce group must be >= 1, got {group}")
        if group > 1 and stateful:
            raise CmpError(
                CmpErrorCode.PARAMS_INVALID,
                "coalesced decode requires stateless (non-MODEL) streams")
        return group

    # -- integrity + fetch -------------------------------------------------
    def finish(self, st: StagedFrames, dec: DecodedFrames) -> np.ndarray:
        """Verify integrity and fetch the samples as (B, N) uint16.

        The samples are narrowed to 16 bits on the device and copied into
        fresh host memory that the caller owns, which no later decode
        overwrites; nothing is cast on the host.  A member of a
        coalesced launch reads its window of the group's one host fetch;
        error messages name the block's index in its own batch."""
        global decoded_batches
        with span("stream.fetch"):
            samples_np = self._fetch_checked(st, dec)
        with span("stream.cast"):
            out = samples_np.view(np.uint16)
        decoded_batches += 1
        return out

    @staticmethod
    def _fetch_checked(st: StagedFrames, dec: DecodedFrames) -> np.ndarray:
        """The (B, N) int16 samples on the host, fetched once the end bits
        and checksums, fetched first, have passed their checks."""
        group = dec.group or _GroupFetch(dec.samples, dec.end_bits, dec.csum)
        w = slice(dec.lo, dec.lo + st.csize.shape[0])
        end_all, calc_all = group.checks()
        end_np = end_all[w]
        calc = None if calc_all is None else calc_all[w]
        # bitstream-exhaustion check, mirroring the host decoder's
        # "payload exceeds compressed_size" guard: a corrupt payload must
        # raise, never silently return garbage
        limit = st.csize - np.where(st.cs != 0, 4, 0)
        over = np.nonzero((end_np + 7) // 8 > limit)[0]
        if over.size:
            raise CmpError(
                CmpErrorCode.INT_BITSTREAM,
                f"block {int(over[0])}: payload exceeds compressed_size")
        if calc is not None:
            bad = np.nonzero((st.cs != 0)
                             & (calc != st.stored_csum.astype(np.int64)))[0]
            if bad.size:
                b = int(bad[0])
                raise CmpError(
                    CmpErrorCode.GENERIC,
                    f"block {b}: checksum mismatch: stored "
                    f"{int(st.stored_csum[b]):#010x} != computed "
                    f"{int(calc[b]):#010x}")
        return group.host_samples()[w]

    def decompress_frames(self, frames: "list[bytes]") -> np.ndarray:
        """Decode one AIRSPACE frame per chain -> (B, N) uint16 samples."""
        st = self.stage_frames(frames)
        return self.finish(st, self.decode_staged(st))

    def _pipeline(self, stagings, launch, group: int, depth: int):
        """Launch ``group`` stagings at a time (the last group may be
        shorter) and finish each once ``depth * group`` later ones are
        queued; yields the (B, N) uint16 arrays in order."""
        in_flight = max(1, depth) * group
        pending = collections.deque()
        acc = []
        for st in stagings:
            acc.append(st)
            if len(acc) < group:
                continue
            pending.extend(zip(acc, launch(acc)))
            acc = []
            while len(pending) > in_flight:
                yield self.finish(*pending.popleft())
        if acc:
            pending.extend(zip(acc, launch(acc)))
        while pending:
            yield self.finish(*pending.popleft())

    def decompress_stream(self, batches,
                          coalesce: "bool | int | None" = None,
                          depth: int = 1):
        """Pipelined decode over consecutive batches (a generator).

        ``batches`` yields ``list[bytes]`` (staged here) or host-staged
        :class:`StagedFrames` (e.g. from :meth:`stage_frames_at` over a
        file buffer).  ``coalesce`` groups consecutive batches into ONE
        launch (:meth:`decode_staged_multi`): an int is the group size,
        ``True`` the automatic group (up to :attr:`COALESCE_LANES` rows),
        ``False`` one launch a batch; the default groups stateless
        streams automatically and decodes MODEL chains batch by batch
        (:meth:`_coalesce_group`).  Each group's decode is queued at once;
        a batch's :meth:`finish`, the only sync point, waits until
        ``depth`` later groups are queued, so the host staging of the
        next group overlaps the device decode of this one.  Grouping
        costs ``group - 1`` batches of latency and changes no output.
        Yields one (B, N) uint16 array per batch, in order.
        """
        group = self._coalesce_group(coalesce)
        stagings = (item if isinstance(item, StagedFrames)
                    else self.stage_frames(item) for item in batches)
        yield from self._pipeline(stagings, self.decode_staged_multi, group,
                                  depth)

    def decompress_file_stream(self, stream, offsets, lens,
                               coalesce: "bool | int | None" = None,
                               depth: int = 1):
        """Device-staged pipelined decode of a whole frame manifest.

        The compressed ``stream`` is uploaded once (:meth:`upload_stream`);
        then consecutive windows of ``batch`` frames are header-staged on
        the host (:meth:`stage_headers_at`) and decoded from the device
        stream, a group of windows a launch
        (:meth:`decode_staged_from_multi`).  ``offsets``/``lens`` locate
        every frame; the frame count must be a multiple of ``batch``.
        ``coalesce`` and ``depth`` as in :meth:`decompress_stream`.
        Yields one (B, N) uint16 array per window, in order.
        """
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        lens = np.ascontiguousarray(lens, dtype=np.int64)
        B = self.batch
        if lens.size != offsets.size or (B and lens.size % B):
            raise CmpError(
                CmpErrorCode.SRC_SIZE_WRONG,
                "manifest length must be a multiple of the batch size")
        group = self._coalesce_group(coalesce)
        ds = self.upload_stream(stream)
        stagings = (self.stage_headers_at(stream, offsets[w * B:(w + 1) * B],
                                          lens[w * B:(w + 1) * B])
                    for w in range(lens.size // B if B else 0))
        yield from self._pipeline(
            stagings, lambda sts: self.decode_staged_from_multi(sts, ds),
            group, depth)
