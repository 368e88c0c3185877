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

Not ported: the entropy clamp of the TPU packer (``cap_bits``, the
encoder's ``clamp=`` argument and its deferred-commit rollback): the
port's packers size the stream by the worst case and cannot overflow, so
:class:`ChunkedLongStreamEncoder` takes no ``clamp`` argument.  The split
of one stream over several cards (the JAX tier's ``mesh``) waits for the
port's ``torch.distributed`` tier; every function here takes ``device=``
(default ``"cuda"``, raising where CUDA is absent) in its place.
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

__all__ = ["compress_long_stream", "LongStreamCompressor",
           "stream_chunk_index", "decompress_long_stream",
           "ChunkedLongStreamEncoder"]

_MAX_ORIGINAL_SIZE = (1 << 24) - 1  # the header's 24-bit original_size


def _step(name: str):
    """A ``torch.profiler`` range over one step, named ``sp.<name>``
    (utils/profiling.range_times reads its host and device time); without
    a profiler running it costs a few microseconds and waits for nothing."""
    return torch.profiler.record_function(f"sp.{name}")


def _host_samples(samples_u16) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(samples_u16, dtype=np.uint16))


def _to_device(x_np: np.ndarray, dev) -> torch.Tensor:
    """u16 samples -> sign-extended int32 on ``dev``."""
    return torch.from_numpy(x_np.view(np.int16)).to(dev).to(torch.int32)


def _model_tensor(model, dev) -> torch.Tensor:
    """An i16-valued model array -> int32 on ``dev``."""
    m = np.ascontiguousarray(np.asarray(model, np.int16))
    return torch.from_numpy(m).to(dev).to(torch.int32)


def _frame(cfg: PassConfig, params: CmpParams, stream: torch.Tensor,
           bits: int, checksum: "int | None", n: int, identifier: int,
           sequence_number: int) -> bytes:
    """The frame's bytes from its word stream (payload from bit
    ``cfg.hdr_bits`` on, ``bits`` bits with the header's): the stream's
    bytes are fetched, the header (whole bytes, 16 or 22) and the trailer
    written over them on the host."""
    if cfg.checksum:
        total_bits = bits + (-bits) % 8 + 32
    else:
        total_bits = bits
    size = (total_bits + 7) >> 3
    words = stream[: (size + 3) // 4]
    frame = bytearray(be_bytes(words[None])[0, :size].cpu().numpy()
                      .tobytes())
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
    return bytes(frame)


def compress_long_stream(params: CmpParams, samples_u16,
                         identifier: int = 0, sequence_number: int = 0,
                         model=None, secondary: bool = False,
                         device="cuda") -> bytes:
    """Compress ONE long u16 stream as a single AIRSPACE block on ``device``.

    ``model`` supplies the model state for MODEL preprocessing (an
    i16-valued array of the stream's length); ``secondary`` selects the
    pass parameters (cmp.c:228-248).  Returns the frame's bytes, identical
    to the JAX package's ``compress_long_stream`` and to the host codec.
    For chain semantics use :class:`LongStreamCompressor`.  Its steps are
    profiler ranges ``sp.encode.{upload,codes,pack,checksum,fetch}``.
    """
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
    with _step("encode.codes"):
        res = preprocess.preprocess_forward(cfg.prep, x[None], m)[0]
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
        got = torch.stack(fetch).tolist()  # the one wait for the card
        return _frame(cfg, params, stream, cfg.hdr_bits + got[0],
                      got[1] if cfg.checksum else None, n, identifier,
                      sequence_number)


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
    return (lens.reshape(-1, chunk_samples).sum(dim=-1).to(torch.int32)
            .cpu().numpy())


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
        start = torch.from_numpy(np.clip(off - hb, -1, 32 * words.numel())
                                 ).to(dev)
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
        got = end.cpu().numpy().astype(np.int64)
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
        return samples.to(torch.int16).cpu().numpy().view(np.uint16)


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

    Preprocessing NONE, DIFF and MODEL stream exactly (DIFF carries one
    sample across chunks); IWT lifts across the whole stream and is
    rejected.  The JAX encoder's ``clamp`` argument is absent: it selects
    the TPU packer's entropy clamp, which the port does not have.
    """

    def __init__(self, params: CmpParams, total_samples: int,
                 chunk_samples: int, identifier: int = 0,
                 sequence_number: int = 0, secondary: bool = False,
                 device="cuda"):
        params.validate()
        self.device = _build.resolve_device(device)
        self.params = params
        cfg = make_pass_config(params, secondary)
        if cfg.prep == int(Preprocessing.IWT):
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           "IWT cannot stream; use compress_long_stream")
        if total_samples % chunk_samples:
            raise CmpError(
                CmpErrorCode.SRC_SIZE_WRONG,
                f"chunk {chunk_samples} must divide the stream "
                f"{total_samples}")
        if 2 * total_samples > _MAX_ORIGINAL_SIZE:
            raise CmpError(CmpErrorCode.HDR_ORIGINAL_TOO_LARGE)
        self.cfg = cfg
        self.total = total_samples
        self.chunk = chunk_samples
        self.identifier = identifier
        self.sequence_number = sequence_number
        self._needs_model = cfg.prep == int(Preprocessing.MODEL)
        dev = self.device
        self._out = torch.zeros(worst_case_words(cfg, total_samples),
                                dtype=torch.int32, device=dev)
        self._carry = torch.tensor(cfg.hdr_bits, dtype=torch.int64,
                                   device=dev)
        self._prev = torch.zeros((1,), dtype=torch.int32, device=dev)
        self._hasher = StreamHasher(dev) if cfg.checksum else None
        self._fed = 0

    def _samples(self, chunks) -> torch.Tensor:
        """Sign-extended int32 samples on the device: a host u16 array is
        uploaded, a tensor of u16 values (any integer type) is used where
        it lies (on the encoder's device: no copy through the host)."""
        if isinstance(chunks, torch.Tensor):
            v = chunks.to(self.device).to(torch.int32) & 0xFFFF
            return (v ^ 0x8000) - 0x8000
        return _to_device(_host_samples(chunks), self.device)

    def _encode(self, x: torch.Tensor, model_chunks) -> None:
        cfg = self.cfg
        if cfg.prep == int(Preprocessing.DIFF):
            res = preprocess.wrap16(x - torch.cat([self._prev, x[:-1]]))
        elif self._needs_model:
            res = preprocess.model_forward(
                x, _model_tensor(model_chunks, self.device).reshape(-1))
        else:
            res = x
        hi, lo, lens = golomb.encode_codewords(res, cfg.enc_type, cfg.g_par,
                                               cfg.outlier)
        starts, bits = pack.row_starts(lens, pack.ROW_CODES, self._carry)
        pack.pack_codes_at(
            self._out, hi if cfg.enc_type == int(EncoderType.GOLOMB_MULTI)
            else None, lo, lens, pack.ROW_CODES, starts,
            cfg.worst_bits_per_sample)
        self._carry = self._carry + bits
        self._prev = x[-1:]
        if self._hasher is not None:
            self._hasher.update(x)
        self._fed += x.numel()

    def feed(self, chunk_u16, model_chunk=None) -> None:
        """Feed the next ``chunk_samples`` samples: a host u16 array, or a
        tensor of u16 values, used on the card where it lies."""
        size = (chunk_u16.numel() if isinstance(chunk_u16, torch.Tensor)
                else np.asarray(chunk_u16).size)
        if size != self.chunk:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                           f"expected {self.chunk}-sample chunks")
        x = self._samples(chunk_u16).reshape(-1)
        if self._fed + self.chunk > self.total:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG, "stream overfed")
        if self._needs_model and model_chunk is None:
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           "MODEL preprocessing requires model chunks")
        self._encode(x, model_chunk)

    def feed_many(self, chunks, model_chunks=None) -> None:
        """Feed K chunks — a (K, chunk_samples) buffer — in one pass (one
        launch of each kernel); host or device arrays as :meth:`feed`."""
        xs = self._samples(chunks)
        if xs.dim() != 2 or xs.shape[1] != self.chunk:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                           f"expected (K, {self.chunk}) chunk buffers")
        if self._fed + xs.numel() > self.total:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG, "stream overfed")
        if self._needs_model and model_chunks is None:
            raise CmpError(CmpErrorCode.PARAMS_INVALID,
                           "MODEL preprocessing requires model chunks")
        self._encode(xs.reshape(-1), model_chunks)

    def finish(self) -> bytes:
        """The complete frame's bytes: header, payload and the digest."""
        if self._fed != self.total:
            raise CmpError(CmpErrorCode.SRC_SIZE_WRONG,
                           f"fed {self._fed} of {self.total} samples")
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
    * the model EMA update (cmp.c:120-129) runs on the card; the model is
      carried between calls as a numpy i16 array, as in the JAX package,
      so one chain can move between the two.
    """

    def __init__(self, params: CmpParams, device="cuda"):
        params.validate()
        self.device = _build.resolve_device(device)
        self.params = params
        self.seq = 0
        self.identifier = 0
        self.model: "np.ndarray | None" = None
        self._n: "int | None" = None
        # reference cmp_initialise ends in cmp_reset, which draws an
        # identifier (cmp.c:203-208, :452-465); every primary-pass reset
        # then draws another
        self.reset()

    def reset(self) -> None:
        self.seq = 0
        self.identifier = _context._new_identifier()

    def compress(self, samples_u16) -> bytes:
        x_np = _host_samples(samples_u16)
        primary = (self.seq == 0
                   or self.seq > self.params.secondary_iterations)
        if primary:
            self.reset()
        elif self.params.model_is_needed() and x_np.size != self._n:
            raise CmpError(CmpErrorCode.SRC_SIZE_MISMATCH)
        secondary = not primary
        cfg = make_pass_config(self.params, secondary)
        model_in = self.model if cfg.prep == int(Preprocessing.MODEL) else None
        frame = compress_long_stream(self.params, x_np,
                                     identifier=self.identifier,
                                     sequence_number=self.seq,
                                     model=model_in, secondary=secondary,
                                     device=self.device)

        unc_size = CMP_HDR_SIZE + 2 * x_np.size \
            + (4 if self.params.checksum_enabled else 0)
        if (self.params.uncompressed_fallback_enabled
                and len(frame) > unc_size):
            # reference fallback: generic reset + engine reset draw two
            # fresh identifiers; the frame becomes NONE + UNCOMPRESSED at
            # seq 0
            for _ in range(2):
                self.identifier = _context._new_identifier()
            fb_params = dataclasses.replace(
                self.params,
                primary_preprocessing=Preprocessing.NONE,
                primary_encoder_type=EncoderType.UNCOMPRESSED)
            frame = compress_long_stream(fb_params, x_np,
                                         identifier=self.identifier,
                                         sequence_number=0,
                                         device=self.device)
            self.model = x_np.view(np.int16).copy()
            self._n = x_np.size
            self.seq = 1
            return frame

        if self.params.model_is_needed():
            if self.seq == 0:
                self.model = x_np.view(np.int16).copy()
            else:
                upd = preprocess.model_update(
                    _to_device(x_np, self.device),
                    _model_tensor(self.model, self.device),
                    self.params.model_rate, unsigned=True)
                self.model = upd.cpu().numpy().astype(np.int16)
            self._n = x_np.size
        self.seq += 1
        return frame
