"""Kernel K3: Golomb decode of N codes per block.

Counterpart of ``airs_compression_tpu/ops/pallas_decode.py`` (the TPU
kernel ``_make_kernel``, entry ``decode_blocks_pallas``).  The wrapper
:func:`decode_blocks` launches ``csrc/decode.cu`` on a CUDA tensor — one
CTA of 256 threads per block, which cut the block's bits into segments,
decode them speculatively and resynchronise them, then write the (B, N)
values row by row — and runs the plain version
:func:`decode_codes_plain` (the step loop of ops/decode.py, vectorized
over B) on a CPU tensor.  The kernel always takes per-block Golomb
parameters, so one kernel serves lockstep, mixed-method and per-header
batches.  Unzigzag, inverse preprocessing and the model update stay in
PyTorch (ops/decode.py, models/stream.py).
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .decode import (
    BAD_CODE_POISON_BITS,
    _decode_one,
    _golomb_terms,
    _window64,
)
from .u32 import from_bits, to_bits

__all__ = ["decode_blocks", "decode_codes_plain"]


def decode_codes_plain(words: torch.Tensor, hdr_bits: int, n_samples: int,
                       enc_type: int, g: torch.Tensor, outlier: torch.Tensor):
    """Plain PyTorch version of kernel K3: the step loop, vectorized over B.

    ``words`` (B, W) int32 BE word bits; ``g``/``outlier`` (B,) int64.
    Returns (mapped values (B, N) int32 bits, end bit positions (B,)
    int32, poisoned by BAD_CODE_POISON_BITS where a code was malformed).
    """
    B = words.shape[0]
    w = torch.cat([from_bits(words), words.new_zeros((B, 3),
                                                     dtype=torch.int64)], 1)
    terms = _golomb_terms(g.to(torch.int64), outlier.to(torch.int64))
    pos = torch.full((B,), hdr_bits, dtype=torch.int64, device=words.device)
    badf = torch.zeros((B,), dtype=torch.bool, device=words.device)
    vals = torch.empty((B, n_samples), dtype=torch.int64, device=words.device)
    for i in range(n_samples):
        hi, lo = _window64(w, pos)
        val, consumed, bad = _decode_one(enc_type, hi, lo, terms)
        vals[:, i] = val
        pos = pos + consumed
        badf = badf | bad
    end_pos = pos + torch.where(badf, BAD_CODE_POISON_BITS, 0)
    return to_bits(vals), end_pos.to(torch.int32)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p]


def decode_blocks(words: torch.Tensor, hdr_bits: int, n_samples: int,
                  enc_type: int, g: torch.Tensor, outlier: torch.Tensor, *,
                  rounds: "torch.Tensor | None" = None):
    """Decode ``n_samples`` codes per row of ``words``, from bit
    ``hdr_bits`` on.

    ``words`` (B, W) int32 BE word bits; ``g``/``outlier`` (B,) integer
    Golomb parameters (g >= 1 where ``enc_type`` != 0).  Returns (mapped
    values (B, N) int32 bits, end bit positions (B,) int32 with
    ``BAD_CODE_POISON_BITS`` added where a code was malformed).
    ``rounds``, for the kernel only: a (B,) int32 CUDA tensor that
    receives each block's synchronise rounds.
    """
    if words.device.type == "cpu":
        if rounds is not None:
            raise ValueError("rounds are counted by the CUDA kernel only")
        return decode_codes_plain(words, hdr_bits, n_samples, enc_type, g,
                                  outlier)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    if words.dim() != 2 or words.dtype != torch.int32:
        raise ValueError("words must be a (B, W) int32 tensor")
    if enc_type not in (0, 1, 2):
        raise ValueError(f"unknown encoder type {enc_type}")
    B, W = words.shape
    w = words.contiguous()
    g32 = to_bits(g.to(device=w.device, dtype=torch.int64)).contiguous()
    o32 = to_bits(outlier.to(device=w.device, dtype=torch.int64)).contiguous()
    if g32.shape != (B,) or o32.shape != (B,):
        raise ValueError("g and outlier must be (B,)")
    if rounds is not None and (rounds.shape != (B,)
                               or rounds.dtype != torch.int32
                               or rounds.device != w.device
                               or not rounds.is_contiguous()):
        raise ValueError("rounds must be a contiguous (B,) int32 tensor on "
                         "the words' device")
    # bit positions are 32-bit in the kernel: a row's bits plus the longest
    # chain of N codes (at most 97 bits each) must stay below 2**31
    if 32 * W + 97 * n_samples + hdr_bits >= 1 << 31:
        raise ValueError(f"rows of {W} words and {n_samples} codes overflow "
                         "the kernel's 32-bit bit positions")
    vals = torch.empty((B, n_samples), dtype=torch.int32, device=w.device)
    end_pos = torch.empty((B,), dtype=torch.int32, device=w.device)
    if B:
        fn = _build.function("decode", "airs_decode_blocks", _ARGTYPES)
        with torch.cuda.device(w.device):
            err = fn(_build.ptr(w), B, W, n_samples, hdr_bits, enc_type,
                     _build.ptr(g32), _build.ptr(o32), _build.ptr(vals),
                     _build.ptr(end_pos),
                     None if rounds is None else _build.ptr(rounds),
                     _build.stream_arg(w))
        _build.check("decode", err, "decode_blocks launch")
        decode_blocks.launches += 1
    return vals, end_pos


decode_blocks.launches = 0
