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

Window mode, for the sidecar decode of one long block (parallel/sp.py):
:func:`decode_windows` decodes rows that are windows of ONE word stream at
given start bits.  Its kernel (``decode_windows_kernel``) gives each
window one warp and each CTA eight windows (2 or 4 warps a window in a
launch of few windows): the CTA stages the span of the stream its windows
cover once (when it fits), each lane decodes one segment of its window
speculatively and keeps those codes' values, the lanes resynchronise by
warp shuffles, and a code decoded on the speculative walk is not decoded
again.  The plain version
:func:`decode_windows_plain` builds the window matrix with
:func:`stream_windows` and runs :func:`decode_codes_plain` on it.
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

__all__ = ["decode_blocks", "decode_codes_plain", "stream_windows",
           "decode_windows", "decode_windows_plain"]


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
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def decode_blocks(words: torch.Tensor, hdr_bits: int, n_samples: int,
                  enc_type: int, g: torch.Tensor, outlier: torch.Tensor):
    """Decode ``n_samples`` codes per row of ``words``, from bit
    ``hdr_bits`` on.

    ``words`` (B, W) int32 BE word bits; ``g``/``outlier`` (B,) integer
    Golomb parameters (g >= 1 where ``enc_type`` != 0).  Returns (mapped
    values (B, N) int32 bits, end bit positions (B,) int32 with
    ``BAD_CODE_POISON_BITS`` added where a code was malformed).
    """
    if words.device.type == "cpu":
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
                     _build.ptr(end_pos), _build.stream_arg(w))
        _build.check("decode", err, "decode_blocks launch")
        decode_blocks.launches += 1
    return vals, end_pos


decode_blocks.launches = 0


def stream_windows(stream: torch.Tensor, starts: torch.Tensor,
                   width: int) -> torch.Tensor:
    """(B, width) int32 windows of the (W,) int32 word stream: row i holds
    the stream's bits from bit ``starts[i]`` on, word j being stream words
    ``starts[i] // 32 + j`` and ``+ j + 1`` funnel-shifted left by
    ``starts[i] % 32``.  Words past the stream, the next word of the last
    window word, and every word of a window whose start is below 0 read as
    zeros."""
    W = stream.numel()
    st = starts.to(device=stream.device, dtype=torch.int64)[:, None]
    base = torch.where(st >= 0, st >> 5, W)
    r = st & 31
    j = torch.arange(width + 1, device=stream.device)
    idx = base + j
    padded = torch.cat([from_bits(stream.reshape(-1)),
                        stream.new_zeros(1, dtype=torch.int64)])
    w = padded[idx.clamp(max=W)]
    w[:, -1] = 0  # the last window word's next word
    win = ((w[:, :-1] << r) & 0xFFFFFFFF) | (w[:, 1:] >> (32 - r))
    return to_bits(win)


def _check_windows(stream, starts, width, n_samples, hdr_bits):
    if stream.dim() != 1 or stream.dtype != torch.int32:
        raise ValueError("stream must be a (W,) int32 tensor")
    if starts.dim() != 1:
        raise ValueError("starts must be (B,)")
    if width < 1:
        raise ValueError(f"window width {width} must be positive")
    if 32 * width + 97 * n_samples + hdr_bits >= 1 << 31:
        raise ValueError(f"windows of {width} words and {n_samples} codes "
                         "overflow the kernel's 32-bit bit positions")


def decode_windows_plain(stream: torch.Tensor, starts: torch.Tensor,
                         width: int, hdr_bits: int, n_samples: int,
                         enc_type: int, g: torch.Tensor,
                         outlier: torch.Tensor):
    """Plain PyTorch version of :func:`decode_windows` (same contract)."""
    _check_windows(stream, starts, width, n_samples, hdr_bits)
    return decode_codes_plain(stream_windows(stream, starts, width),
                              hdr_bits, n_samples, enc_type, g, outlier)


_WINDOW_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def decode_windows(stream: torch.Tensor, starts: torch.Tensor, width: int,
                   hdr_bits: int, n_samples: int, enc_type: int,
                   g: torch.Tensor, outlier: torch.Tensor):
    """Decode ``n_samples`` codes from each window of one word stream.

    Row i is the ``width``-word window of the (W,) int32 stream ``stream``
    at bit ``starts[i]`` (:func:`stream_windows`), decoded from its bit
    ``hdr_bits`` on with per-row ``g``/``outlier`` (B,).  Returns (mapped
    values (B, N) int32 bits, end bit positions (B,) int32 within each
    window, poisoned as :func:`decode_blocks`).  CUDA tensors go through
    kernel K3's window kernel (``csrc/decode.cu`` ``decode_windows_kernel``:
    one warp a window, eight windows a CTA, or 2 or 4 warps a window when
    the launch has under 16 windows an SM; the CTA's span of the stream
    staged once in shared memory when it fits, else read from device
    memory; up to 32 segments a warp, one a lane, whose speculative codes
    are kept and written without a second decode), CPU tensors
    through :func:`decode_windows_plain`.
    """
    if stream.device.type == "cpu":
        return decode_windows_plain(stream, starts, width, hdr_bits,
                                    n_samples, enc_type, g, outlier)
    if stream.device.type != "cuda":
        raise ValueError(f"unsupported device {stream.device}")
    _check_windows(stream, starts, width, n_samples, hdr_bits)
    if enc_type not in (0, 1, 2):
        raise ValueError(f"unknown encoder type {enc_type}")
    if stream.numel() >= 1 << 31:
        raise ValueError("stream too long for the kernel's word offsets")
    w = stream.contiguous()
    at = starts.to(device=w.device, dtype=torch.int32).contiguous()
    B = at.numel()
    g32 = to_bits(g.to(device=w.device, dtype=torch.int64)).contiguous()
    o32 = to_bits(outlier.to(device=w.device, dtype=torch.int64)).contiguous()
    if g32.shape != (B,) or o32.shape != (B,):
        raise ValueError("g and outlier must be (B,)")
    vals = torch.empty((B, n_samples), dtype=torch.int32, device=w.device)
    end_pos = torch.empty((B,), dtype=torch.int32, device=w.device)
    if B:
        fn = _build.function("decode", "airs_decode_windows", _WINDOW_ARGTYPES)
        with torch.cuda.device(w.device):
            err = fn(_build.ptr(w), w.numel(), _build.ptr(at), B, width,
                     n_samples, hdr_bits, enc_type, _build.ptr(g32),
                     _build.ptr(o32), _build.ptr(vals), _build.ptr(end_pos),
                     _build.stream_arg(w))
        _build.check("decode", err, "decode_windows launch")
        decode_windows.launches += 1
    return vals, end_pos


decode_windows.launches = 0
