"""The AIRSPACE integer wavelet transform, forward, in plain PyTorch.

Upstream's ``iwt_multi_level_decomposition_i16`` (lib/compress/
preprocess.c:140-221) is the integer lifting of the 5/3 wavelet (Solomon,
*Data Compression*, eq. 5.24), applied level after level at a stride that
doubles: level k works on the subsequence ``v = x[::2**k]`` in place, its
odd positions becoming details and its even positions approximations, and
the next level takes the approximations (every ``2**(k+1)``-th sample) on.

On one level, with ``e`` the even and ``o`` the odd elements of ``v``:

* detail       ``d[i] = o[i] - floor((e[i] + e[i+1]) / 2)``
* approximation ``a[i] = e[i] + floor((d[i-1] + d[i]) / 4)``

with the sequence mirrored at both ends (a missing ``e[i+1]`` is ``e[i]``,
a missing ``d[i-1]`` is ``d[0]``, a missing ``d[i]`` is ``d[i-1]``), so
the first approximation adds ``floor(d[0] / 2)``.  Every stored value is
an int16 and wraps as C's ``int16_t`` does; the sums inside the floors do
not wrap.

Written from that description: it imports nothing of the program.
"""

from __future__ import annotations

import torch

__all__ = ["iwt_forward"]


def _wrap16(v: torch.Tensor) -> torch.Tensor:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _level(v: torch.Tensor) -> torch.Tensor:
    """One lifting level over the last axis of ``v`` (at least 2 long)."""
    e, o = v[..., 0::2], v[..., 1::2]
    n_o = o.shape[-1]
    e_next = torch.cat([e[..., 1:], e[..., -1:]], -1)[..., :n_o]
    d = _wrap16(o - ((e[..., :n_o] + e_next) >> 1))
    n_e = e.shape[-1]
    d_prev = torch.cat([d[..., :1], d], -1)[..., :n_e]
    d_this = torch.cat([d, d[..., -1:]], -1)[..., :n_e]
    a = _wrap16(e + ((d_prev + d_this) >> 2))
    out = torch.empty_like(v)
    out[..., 0::2] = a
    out[..., 1::2] = d
    return out


def iwt_forward(x: torch.Tensor) -> torch.Tensor:
    """The multi-level forward IWT over the last axis of ``x``: int16
    values (any integer tensor, read as signed 16-bit) in, int64 int16
    values out."""
    y = _wrap16(x.to(torch.int64))
    n = y.shape[-1]
    stride = 1
    while stride < n:
        y[..., ::stride] = _level(y[..., ::stride])
        stride *= 2
    return y
