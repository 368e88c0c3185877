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
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import golomb
from .u32 import MASK, to_bits

__all__ = ["worst_bits", "code_words", "payload_words", "pack_residuals",
           "pack_residuals_plain", "pack_codes", "pack_codes_plain"]


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
