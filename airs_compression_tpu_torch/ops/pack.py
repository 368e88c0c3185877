"""Bit packers: K1 (residuals -> codes -> packed) and K2 (codes -> packed).

Counterparts of ``airs_compression_tpu/ops/pallas_pack.py`` (the TPU
kernels ``_residual_kernel``, entry ``pack_residuals_pallas``, and
``_codes_kernel``, entry ``pack_codes_tree_pallas``) and of the
``bitpack.pack_codes_tree`` contract (``ops/bitpack.py:267``): the codes of
each block concatenated MSB-first into a left-justified stream of
big-endian u32 words, plus the stream's length in bits.  Zero-length codes
contribute nothing.

* :func:`pack_residuals` (K1) — Golomb codes of each block's residuals,
  computed and packed in one kernel.
* :func:`pack_codes` (K2) — precomputed ``(hi, lo, lens)`` codes, e.g. the
  adaptive tier's per-block codewords (ops/adapt.py).

Both launch ``csrc/pack.cu`` on a CUDA tensor (one CTA per block, a tile
of codes at a time: a scan of the runs' code lengths, then each thread
packs its run in a register accumulator; ``tests/test_torch_pack_runs.py``
models it) and run the one plain version, :func:`pack_codes_plain`, on a
CPU tensor.

Long-row mode, for one long block (parallel/sp.py): :func:`row_starts`
cuts its codes into rows of ``row_len`` and gives each row its absolute
start bit from an exclusive scan of the rows' code-length sums;
:func:`pack_residuals_at` (K1) and :func:`pack_codes_at` (K2) then pack
every row in one launch straight into one stream: one thread-block cluster
a row, one tile a CTA, each tile's start bit from a scan of the tiles' bit
counts in the cluster's distributed shared memory, ORing the words a tile
shares with its neighbours.  Their plain version,
:func:`pack_codes_at_plain`, packs the rows with :func:`pack_codes_plain`
and splices them into the stream at their offsets.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import golomb
from .u32 import MASK, from_bits, to_bits

__all__ = ["worst_bits", "code_words", "payload_words", "pack_residuals",
           "pack_residuals_plain", "pack_codes", "pack_codes_plain",
           "ROW_CODES", "row_starts", "pack_residuals_at",
           "pack_residuals_at_plain", "pack_codes_at", "pack_codes_at_plain"]


def worst_bits(enc_type: int, g_par: int) -> int:
    """Longest code (bits) a sample can take under the encoder."""
    if enc_type == 0:
        return 16
    if enc_type == 1:
        return (int(g_par).bit_length() - 1) + 1 + 16
    return 48  # MULTI: 32-bit codeword + 16 raw bits


def code_words(max_bits: int, n: int) -> int:
    """Payload capacity C (u32 words) for n codes of at most max_bits."""
    return max(1, (max_bits * n + 31) // 32)


def payload_words(enc_type: int, g_par: int, n: int) -> int:
    """Payload capacity C (u32 words) for n codes of the worst length."""
    return code_words(worst_bits(enc_type, g_par), n)


def _check_args(residuals: torch.Tensor, enc_type: int, g_par: int) -> None:
    if residuals.dim() != 2:
        raise ValueError(f"residuals must be (B, N), got {residuals.shape}")
    if enc_type not in (0, 1, 2):
        raise ValueError(f"unknown encoder type {enc_type}")
    if enc_type and not 1 <= g_par <= 0xFFFF:
        raise ValueError(f"Golomb parameter {g_par} out of range")


def pack_codes_plain(hi, lo: torch.Tensor, lens: torch.Tensor,
                     max_bits: int):
    """Plain PyTorch version of :func:`pack_codes` (same contract).

    An exclusive cumsum of the code lengths gives each code its bit offset;
    each code is split into the <= 3 words it touches and added with
    ``scatter_add_``.  The pieces occupy disjoint bits, so the sum is an OR.
    """
    B, K = lens.shape
    C = code_words(max_bits, K)
    dev = lens.device
    ln = lens.to(torch.int64)
    lo = lo.to(torch.int64) & MASK
    hi = (torch.zeros_like(lo) if hi is None
          else hi.to(torch.int64) & MASK)
    ends = torch.cumsum(ln, dim=1)
    pos = ends - ln
    bits = ends[:, -1] if K else torch.zeros(B, dtype=torch.int64, device=dev)
    # left-justify each code in a 64-bit (w0, w1) pair (bitpack level 0);
    # zero-length codes contribute nothing; lo >> 32 is 0 for a 64-bit code
    short = ln <= 32
    w0 = torch.where(short, (lo << (32 - ln).clamp(0, 31)) & MASK,
                     ((hi << (64 - ln).clamp(0, 31))
                      | (lo >> (ln - 32).clamp(0, 32))) & MASK)
    w0 = torch.where(ln > 0, w0, 0)
    w1 = torch.where(short, 0, (lo << (64 - ln).clamp(0, 31)) & MASK)
    # then shift it right by its offset within the first word it touches
    s = pos & 31
    left = (32 - s).clamp(max=31)
    p0 = w0 >> s
    p1 = torch.where(s > 0, (w0 << left) & MASK, 0) | (w1 >> s)
    p2 = torch.where(s > 0, (w1 << left) & MASK, 0)
    wi = pos >> 5
    # pieces past C words (only from lengths over max_bits) are dropped,
    # as the kernel drops them: they pile into the cut column C + 1
    payload = torch.zeros((B, C + 2), dtype=torch.int64, device=dev)
    for k, piece in enumerate((p0, p1, p2)):
        payload.scatter_add_(1, (wi + k).clamp(max=C + 1), piece)
    return to_bits(payload[:, :C]), bits.to(torch.int32)


def pack_residuals_plain(residuals: torch.Tensor, enc_type: int, g_par: int,
                         outlier: int):
    """Plain PyTorch version of :func:`pack_residuals` (same contract)."""
    _check_args(residuals, enc_type, g_par)
    hi, lo, ln = golomb.encode_codewords(residuals, enc_type, g_par, outlier)
    return pack_codes_plain(hi, lo, ln, worst_bits(enc_type, g_par))


_RESIDUAL_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                      ctypes.c_uint, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p]


def pack_residuals(residuals: torch.Tensor, enc_type: int, g_par: int,
                   outlier: int):
    """Pack (B, N) sign-extended i16 residuals under one encoder config.

    Returns ``(payload, bits)``: payload (B, C) int32 holding the u32 bits
    of a left-justified big-endian word stream (C from
    :func:`payload_words`), bits (B,) int32 valid bits per block.  CUDA
    tensors go through kernel K1 (``csrc/pack.cu``), CPU tensors through
    :func:`pack_residuals_plain`.
    """
    if residuals.device.type == "cpu":
        return pack_residuals_plain(residuals, enc_type, g_par, outlier)
    if residuals.device.type != "cuda":
        raise ValueError(f"unsupported device {residuals.device}")
    _check_args(residuals, enc_type, g_par)
    B, N = residuals.shape
    C = payload_words(enc_type, g_par, N)
    res = residuals.to(torch.int32).contiguous()
    payload = torch.empty((B, C), dtype=torch.int32, device=res.device)
    bits = torch.empty((B,), dtype=torch.int32, device=res.device)
    if B == 0:
        return payload, bits
    fn = _build.function("pack", "airs_pack_residuals", _RESIDUAL_ARGTYPES)
    with torch.cuda.device(res.device):
        err = fn(_build.ptr(res), B, N, C, enc_type, g_par, outlier & MASK,
                 _build.ptr(payload), _build.ptr(bits), _build.stream_arg(res))
    _build.check("pack", err, "pack_residuals launch")
    pack_residuals.launches += 1
    return payload, bits


pack_residuals.launches = 0


_CODES_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]


def pack_codes(hi, lo: torch.Tensor, lens: torch.Tensor, max_bits: int):
    """Pack (B, K) precomputed codes into one bit stream per block.

    ``hi``/``lo`` hold each code's bits above / below bit 32 as u32 values
    (int64 or int32 bit patterns); ``hi`` may be None when every code is
    at most 32 bits.  ``lens`` (B, K) are the bit lengths, in
    ``[0, max_bits]``, ``max_bits <= 64``; bits of a code above its length
    are ignored.  Returns ``(payload, bits)``: payload (B, C) int32 u32
    bits of a left-justified big-endian word stream, C from
    :func:`code_words`, and bits (B,) int32.  CUDA tensors
    go through kernel K2 (``csrc/pack.cu``), CPU tensors through
    :func:`pack_codes_plain`.
    """
    if lens.dim() != 2 or lo.shape != lens.shape or (
            hi is not None and hi.shape != lens.shape):
        raise ValueError("hi, lo and lens must be (B, K) alike")
    if not 1 <= max_bits <= 64:
        raise ValueError(f"max_bits {max_bits} out of range")
    if lens.device.type == "cpu":
        return pack_codes_plain(hi, lo, lens, max_bits)
    if lens.device.type != "cuda":
        raise ValueError(f"unsupported device {lens.device}")
    B, K = lens.shape
    C = code_words(max_bits, K)
    lo32, hi32 = (None if v is None else (
        v if v.dtype == torch.int32 else to_bits(v.to(torch.int64) & MASK))
        .contiguous() for v in (lo, hi))
    ln32 = lens.to(torch.int32).contiguous()
    payload = torch.empty((B, C), dtype=torch.int32, device=lens.device)
    bits = torch.empty((B,), dtype=torch.int32, device=lens.device)
    if B == 0:
        return payload, bits
    fn = _build.function("pack", "airs_pack_codes", _CODES_ARGTYPES)
    with torch.cuda.device(lens.device):
        err = fn(None if hi32 is None else _build.ptr(hi32), _build.ptr(lo32),
                 _build.ptr(ln32), B, K, C, _build.ptr(payload),
                 _build.ptr(bits), _build.stream_arg(ln32))
    _build.check("pack", err, "pack_codes launch")
    pack_codes.launches += 1
    return payload, bits


pack_codes.launches = 0


# -- long-row mode ---------------------------------------------------------

#: codes per row in long-row mode: the batch path's N; at 2**22 samples a
#: long block is 512 rows (csrc/pack.cu gives a row up to 8 CTAs, one tile
#: each, fewer where the rows alone fill the card)
ROW_CODES = 8192


def row_starts(lens: torch.Tensor, row_len: int, first_bit):
    """Each row's absolute start bit for codes of lengths ``lens`` (K,),
    cut into rows of ``row_len`` (the last may be shorter).

    ``first_bit``: the first row's start (an int, or a 0-d tensor on the
    device: a bit offset carried there).  Returns ``(starts, bits)``:
    starts (R,) int32, ``first_bit`` plus an exclusive cumsum of the rows'
    code-length sums, and the rows' total bits as a 0-d int64 tensor.
    Nothing is fetched to the host.
    """
    K = lens.numel()
    R = max(1, -(-K // row_len))
    ln = lens.reshape(-1).to(torch.int64)
    if R * row_len != K:
        ln = torch.cat([ln, ln.new_zeros(R * row_len - K)])
    sums = ln.reshape(R, row_len).sum(dim=1)
    ends = torch.cumsum(sums, dim=0) + first_bit
    return (ends - sums).to(torch.int32), ends[-1] - first_bit


def _check_at(stream: torch.Tensor, K: int, row_len: int,
              starts: torch.Tensor) -> None:
    if stream.dim() != 1 or stream.dtype != torch.int32:
        raise ValueError("stream must be a (W,) int32 tensor")
    if row_len < 1:
        raise ValueError(f"row_len {row_len} must be positive")
    if starts.shape != (max(1, -(-K // row_len)),):
        raise ValueError(f"starts must hold one bit per row of {row_len} "
                         f"of the {K} codes, got {tuple(starts.shape)}")
    if K >= 1 << 31:
        raise ValueError(f"{K} codes overflow the kernel's row arithmetic")


def pack_codes_at_plain(stream: torch.Tensor, hi, lo: torch.Tensor,
                        lens: torch.Tensor, row_len: int,
                        starts: torch.Tensor, max_bits: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`pack_codes_at` (same contract).

    Packs the rows with :func:`pack_codes_plain`, shifts each row's words
    right by ``start % 32`` onto the stream's word grid and adds them in at
    ``start // 32``; the rows' bits, and any bits the stream holds there,
    are disjoint, so the sum is an OR.  Words past the stream are dropped.
    """
    K = lens.numel()
    _check_at(stream, K, row_len, starts)
    R = starts.numel()
    pad = R * row_len - K

    def rows(v):
        v = v.reshape(-1)
        return torch.cat([v, v.new_zeros(pad)]).reshape(R, row_len)

    payload, bits = pack_codes_plain(None if hi is None else rows(hi),
                                     rows(lo), rows(lens), max_bits)
    p = from_bits(payload)
    st = starts.to(device=p.device, dtype=torch.int64)[:, None]
    s = st & 31
    left = (32 - s).clamp(max=31)
    zero = torch.zeros_like(p[:, :1])
    cur = torch.cat([p, zero], dim=1)   # word j of the row, j <= C
    prev = torch.cat([zero, p], dim=1)  # word j - 1
    shifted = (cur >> s) | torch.where(s > 0, (prev << left) & MASK, 0)
    W = stream.numel()
    idx = (st >> 5) + torch.arange(shifted.shape[1], device=p.device)
    keep = (idx >= 0) & (idx < W)
    acc = torch.zeros(W + 1, dtype=torch.int64, device=p.device)
    acc.scatter_add_(0, torch.where(keep, idx, W).reshape(-1),
                     torch.where(keep, shifted, 0).reshape(-1))
    stream |= to_bits(acc[:W])
    return bits


def pack_residuals_at_plain(stream: torch.Tensor, residuals: torch.Tensor,
                            row_len: int, starts: torch.Tensor, enc_type: int,
                            g_par: int, outlier: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`pack_residuals_at` (same contract)."""
    _check_args(residuals.reshape(1, -1), enc_type, g_par)
    hi, lo, ln = golomb.encode_codewords(residuals.reshape(-1), enc_type,
                                         g_par, outlier)
    return pack_codes_at_plain(stream, hi, lo, ln, row_len, starts,
                               worst_bits(enc_type, g_par))


def _count_rows(wrapper, rows: int) -> None:
    """One launch of ``wrapper`` over ``rows`` rows, in its
    ``launches_by_rows`` (row count -> launches)."""
    wrapper.launches_by_rows[rows] = wrapper.launches_by_rows.get(rows, 0) + 1


_RESIDUAL_AT_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int,
                         ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def pack_residuals_at(stream: torch.Tensor, residuals: torch.Tensor,
                      row_len: int, starts: torch.Tensor, enc_type: int,
                      g_par: int, outlier: int) -> torch.Tensor:
    """Pack one long row of (K,) sign-extended i16 residuals into ``stream``.

    The Golomb codes of the residuals, cut into rows of ``row_len`` codes,
    go into the (W,) int32 word stream ``stream`` (u32 bits of big-endian
    words) in place, row i from bit ``starts[i]`` (from :func:`row_starts`
    over these codes' lengths, so the rows' bit ranges do not overlap).
    The stream must hold zeros where the rows' bits go; its other bits (a
    header) are kept.  Returns the rows' bits (R,) int32.  CUDA tensors go
    through kernel K1 in long-row mode (``csrc/pack.cu``, one cluster of up
    to 8 CTAs a row, one tile a CTA), CPU tensors through
    :func:`pack_residuals_at_plain`.  Each launch counts in ``launches``
    and, by the launch's row count, in ``launches_by_rows``.
    """
    if residuals.device.type == "cpu":
        return pack_residuals_at_plain(stream, residuals, row_len, starts,
                                       enc_type, g_par, outlier)
    if residuals.device.type != "cuda":
        raise ValueError(f"unsupported device {residuals.device}")
    _check_args(residuals.reshape(1, -1), enc_type, g_par)
    K = residuals.numel()
    _check_at(stream, K, row_len, starts)
    if not stream.is_contiguous() or stream.device != residuals.device:
        raise ValueError("stream must be contiguous, on the residuals' device")
    res = residuals.reshape(-1).to(torch.int32).contiguous()
    at = starts.to(device=res.device, dtype=torch.int32).contiguous()
    R = at.numel()
    bits = torch.empty((R,), dtype=torch.int32, device=res.device)
    fn = _build.function("pack", "airs_pack_residuals_at",
                         _RESIDUAL_AT_ARGTYPES)
    with torch.cuda.device(res.device):
        err = fn(_build.ptr(res), R, row_len, K, stream.numel(), enc_type,
                 g_par, outlier & MASK, _build.ptr(at), _build.ptr(stream),
                 _build.ptr(bits), _build.stream_arg(res))
    _build.check("pack", err, "pack_residuals_at launch")
    pack_residuals_at.launches += 1
    _count_rows(pack_residuals_at, R)
    return bits


pack_residuals_at.launches = 0
pack_residuals_at.launches_by_rows = {}


_CODES_AT_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p]


def pack_codes_at(stream: torch.Tensor, hi, lo: torch.Tensor,
                  lens: torch.Tensor, row_len: int, starts: torch.Tensor,
                  max_bits: int) -> torch.Tensor:
    """Pack one long row of (K,) precomputed codes into ``stream``.

    As :func:`pack_residuals_at`, for ``(hi, lo, lens)`` codes with the
    contract of :func:`pack_codes` (``hi`` may be None, lengths in
    ``[0, max_bits]``).  Returns the rows' bits (R,) int32.  CUDA tensors
    go through kernel K2 in long-row mode (``csrc/pack.cu``), CPU tensors
    through :func:`pack_codes_at_plain`; launches are counted as there.
    """
    if lo.shape != lens.shape or (hi is not None and hi.shape != lens.shape):
        raise ValueError("hi, lo and lens must be alike")
    if not 1 <= max_bits <= 64:
        raise ValueError(f"max_bits {max_bits} out of range")
    if lens.device.type == "cpu":
        return pack_codes_at_plain(stream, hi, lo, lens, row_len, starts,
                                   max_bits)
    if lens.device.type != "cuda":
        raise ValueError(f"unsupported device {lens.device}")
    K = lens.numel()
    _check_at(stream, K, row_len, starts)
    if not stream.is_contiguous() or stream.device != lens.device:
        raise ValueError("stream must be contiguous, on the codes' device")
    lo32, hi32 = (None if v is None else (
        v if v.dtype == torch.int32 else to_bits(v.to(torch.int64) & MASK))
        .reshape(-1).contiguous() for v in (lo, hi))
    ln32 = lens.reshape(-1).to(torch.int32).contiguous()
    at = starts.to(device=lens.device, dtype=torch.int32).contiguous()
    R = at.numel()
    bits = torch.empty((R,), dtype=torch.int32, device=lens.device)
    fn = _build.function("pack", "airs_pack_codes_at", _CODES_AT_ARGTYPES)
    with torch.cuda.device(lens.device):
        err = fn(None if hi32 is None else _build.ptr(hi32), _build.ptr(lo32),
                 _build.ptr(ln32), R, row_len, K, stream.numel(),
                 _build.ptr(at), _build.ptr(stream), _build.ptr(bits),
                 _build.stream_arg(ln32))
    _build.check("pack", err, "pack_codes_at launch")
    pack_codes_at.launches += 1
    _count_rows(pack_codes_at, R)
    return bits


pack_codes_at.launches = 0
pack_codes_at.launches_by_rows = {}
