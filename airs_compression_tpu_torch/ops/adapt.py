"""Adaptive per-block Golomb parameter selection.

Port of ``airs_compression_tpu/ops/adapt.py``.  Each block picks its own
Golomb parameter from a candidate ladder by the true coded bit count of
the whole block (closed form, no packing); the chosen parameter and its
derived outlier travel in the block's header, so the output is an
ordinary AIRSPACE stream.

Two strategies share the exact per-candidate cost model:

* **fast** (default): the estimate g* = 0.69 * mu, mu the mean of the
  values the Golomb coder sees, centers a window of ``2w + 1`` ladder
  candidates (``AIRS_ADAPTIVE_WINDOW``, default w = 2), plus ``ladder[0]``;
  only those are costed.
* **exact**: the full-ladder argmin (``AIRS_ADAPTIVE_SELECT=exact``), also
  taken when the ladder is no bigger than the window.

Ties go to the first candidate in ladder order, as ``jnp.argmin`` does.

The JAX package divides by the per-block parameter with shifts and a
``//3`` (``_div_by_g``, ``ladder_fast_div``) because the TPU has no
integer divide; exact division gives the same codes, so here it is a
plain ``//``.  u32 values are int64 tensors masked to 32 bits
(ops/u32.py).

The fast strategy's mean is the block's exact integer sum, rounded once to
float32 and divided by N in float32.  The JAX package sums in float32,
which is exact while the partial sums stay below 2**24 (every detector
corpus: mapped residuals are small) and otherwise may differ by an ulp;
the exact sum makes the choice the same on the CPU and on the card.

Under ``torch.profiler`` the choice runs in the span ``adapt.select`` and
the codewords in ``adapt.codewords`` (utils/profiling.span; inside the
batch tier's ``stream.dispatch``).  Two plain host counters, which read
no device value: :data:`selected_blocks` (the blocks whose parameter was
chosen) and :data:`costed_candidates` (the candidate parameters costed,
one a block and column).
"""

from __future__ import annotations

import functools
import os

import torch

from ..utils.bits import golomb_optimal_outlier_zero, golomb_upper_bound
from ..utils.profiling import span
from . import golomb
from .u32 import MASK

__all__ = ["DEFAULT_LADDER", "code_lengths_for", "code_lengths_for_multi",
           "code_lengths_dynamic", "code_lengths_dynamic_multi",
           "select_golomb_zero", "select_golomb_multi",
           "encode_codewords_dynamic", "encode_codewords_dynamic_multi",
           "zero_terms"]

#: blocks whose parameter was chosen, and candidates costed (a block's
#: columns), in this process
selected_blocks = 0
costed_candidates = 0

# Candidate Golomb parameters: powers of two cover the useful dynamic
# range for 16-bit residuals; odd values add fine-grained low-rate steps.
DEFAULT_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                  192, 256, 384, 512, 1024, 2048, 4096)


def _in_span(name: str):
    """Run the decorated function inside the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _lengths(v: torch.Tensor, g, g_log2, cutoff) -> torch.Tensor:
    """Golomb code lengths of values ``v`` (codeword <= 32 bits)."""
    len0 = g_log2 + 1
    in_g0 = v < cutoff
    group = torch.where(in_g0, 0, v - cutoff) // g
    return torch.where(in_g0, len0, len0 + 1 + group)


def _multi_split(mapped: torch.Tensor, outlier):
    """MULTI escape split: (esc, diff, level) of mapped values."""
    esc = mapped >= outlier
    diff = torch.where(esc, mapped - outlier, 0)
    level = torch.where(diff < 4, 0, golomb.ilog2(diff) >> 1)
    return esc, diff, level


def zero_terms(g: torch.Tensor):
    """Per-parameter (g_log2, cutoff, outlier) of GOLOMB_ZERO: the optimal
    zero-escape outlier clamped to the 32-bit codeword bound
    (encoder.c:63-182)."""
    g_log2 = golomb.ilog2(g)
    cutoff = (2 << g_log2) - g
    opt = cutoff + 16 * g - 1
    upper = cutoff + (31 - g_log2) * g
    return g_log2, cutoff, torch.minimum(opt, upper)


def _clamped_outlier_multi(g: torch.Tensor, caller_outlier: int):
    """min(caller outlier, MULTI 32-bit bound) per parameter: closed form
    of utils.bits.golomb_upper_bound(g, True, 16) (encoder.c:63-110)."""
    g_log2 = golomb.ilog2(g)
    cutoff = (2 << g_log2) - g
    return torch.clamp(cutoff + (31 - g_log2) * g - 8, max=caller_outlier)


def code_lengths_for(mapped: torch.Tensor, g_par: int) -> torch.Tensor:
    """Per-block total coded bits under GOLOMB_ZERO with ``g_par``.

    ``mapped`` is (..., N) int64 zigzag values; returns (...,) int64.
    """
    g_log2 = int(g_par).bit_length() - 1
    outlier = min(golomb_optimal_outlier_zero(g_par, 16),
                  golomb_upper_bound(g_par, False, 16))
    esc = mapped >= outlier
    ln = _lengths(torch.where(esc, 0, mapped + 1), g_par, g_log2,
                  (2 << g_log2) - g_par)
    return torch.where(esc, g_log2 + 17, ln).sum(-1)


def code_lengths_dynamic(mapped: torch.Tensor,
                         g_par: torch.Tensor) -> torch.Tensor:
    """Per-block GOLOMB_ZERO coded bits with per-block parameters.

    ``g_par`` is (...,) — one parameter per block of ``mapped`` (..., N);
    the outlier follows :func:`encode_codewords_dynamic`'s closed forms.
    """
    g = g_par.to(torch.int64)[..., None]
    g_log2, cutoff, outlier = zero_terms(g)
    esc = mapped >= outlier
    ln = _lengths(torch.where(esc, 0, mapped + 1), g, g_log2, cutoff)
    return torch.where(esc, g_log2 + 17, ln).sum(-1)


def code_lengths_for_multi(mapped: torch.Tensor, g_par: int,
                           caller_outlier: int) -> torch.Tensor:
    """Per-block total coded bits under GOLOMB_MULTI with ``g_par``: the
    caller's outlier clamped to the 32-bit codeword bound
    (encoder.c:185-224); escapes cost golomb(outlier + level) +
    (level + 1) * 2 raw bits (encoder.c:341-374)."""
    g_log2 = int(g_par).bit_length() - 1
    outlier = min(caller_outlier, golomb_upper_bound(g_par, True, 16))
    esc, _, level = _multi_split(mapped, outlier)
    ln = _lengths(torch.where(esc, outlier + level, mapped), g_par, g_log2,
                  (2 << g_log2) - g_par)
    return (ln + torch.where(esc, (level + 1) * 2, 0)).sum(-1)


def code_lengths_dynamic_multi(mapped: torch.Tensor, g_par: torch.Tensor,
                               caller_outlier: int) -> torch.Tensor:
    """Per-block GOLOMB_MULTI coded bits with per-block parameters (same
    contract as :func:`code_lengths_dynamic`; the caller's outlier is
    clamped per parameter)."""
    g = g_par.to(torch.int64)[..., None]
    g_log2 = golomb.ilog2(g)
    outlier = _clamped_outlier_multi(g, caller_outlier)
    esc, _, level = _multi_split(mapped, outlier)
    ln = _lengths(torch.where(esc, outlier + level, mapped), g, g_log2,
                  (2 << g_log2) - g)
    return (ln + torch.where(esc, (level + 1) * 2, 0)).sum(-1)


def _select_window() -> int:
    """Half-width of the fast-selection candidate window (0 = exact)."""
    if os.environ.get("AIRS_ADAPTIVE_SELECT", "fast") == "exact":
        return 0
    return int(os.environ.get("AIRS_ADAPTIVE_WINDOW", "2"))


def _window_candidates(values: torch.Tensor, ladder, w: int) -> torch.Tensor:
    """(B, 2w + 2) candidate parameters: ``ladder[0]``, then the window
    around the ladder entry nearest to g* = 0.69 * mean(values).

    ``ladder[0]`` is always a candidate: for incompressible blocks the
    cost curve is bimodal and escaping nearly every sample at the
    smallest parameter wins.  Edge indices clip (duplicates are
    harmless); candidates are index-ascending, so the argmin takes the
    lowest ladder index among equal costs.
    """
    n = values.shape[-1]
    mu = values.sum(-1).to(torch.float32) / torch.tensor(
        float(n), dtype=torch.float32)
    g_est = torch.tensor(0.69, dtype=torch.float32) * mu
    idx = torch.zeros(mu.shape, dtype=torch.int64, device=mu.device)
    for a, b in zip(ladder[:-1], ladder[1:]):
        idx += g_est > torch.tensor((a * b) ** 0.5, dtype=torch.float32)
    offs = torch.arange(-w, w + 1, device=mu.device)
    cand_idx = (idx[:, None] + offs).clamp(0, len(ladder) - 1)
    cand_idx = torch.cat([torch.zeros_like(idx)[:, None], cand_idx], dim=1)
    return torch.tensor(ladder, dtype=torch.int64, device=mu.device)[cand_idx]


def _argmin(cand: torch.Tensor, costs: torch.Tensor):
    """The first cheapest candidate of each block and its cost; counts the
    blocks and the candidates costed (host shapes only)."""
    global selected_blocks, costed_candidates
    selected_blocks += costs[..., 0].numel()
    costed_candidates += costs.numel()
    best = torch.argmin(costs, dim=-1, keepdim=True)
    return (torch.gather(cand, -1, best)[..., 0],
            torch.gather(costs, -1, best)[..., 0])


@_in_span("adapt.select")
def select_golomb_zero(residuals: torch.Tensor, ladder=DEFAULT_LADDER):
    """Pick the rate-optimal GOLOMB_ZERO parameter per block.

    ``residuals`` (B, N) sign-extended i16 (post preprocessing).  Returns
    ``(g (B,) int64, total_bits (B,) int64)``.
    """
    mapped = golomb.zigzag(residuals)
    w = _select_window()
    if w > 0 and 2 * w + 2 < len(ladder):
        cand = _window_candidates(mapped, ladder, w)
        # one (B, N) pass per candidate column keeps the temporaries small
        costs = torch.stack([code_lengths_dynamic(mapped, cand[:, k])
                             for k in range(cand.shape[1])], dim=-1)
    else:
        costs = torch.stack([code_lengths_for(mapped, g) for g in ladder],
                            dim=-1)
        cand = torch.tensor(ladder, dtype=torch.int64,
                            device=mapped.device).expand(costs.shape)
    return _argmin(cand, costs)


@_in_span("adapt.select")
def select_golomb_multi(residuals: torch.Tensor, caller_outlier: int,
                        ladder=DEFAULT_LADDER):
    """Pick the rate-optimal GOLOMB_MULTI parameter per block.

    Returns ``(g (B,), outlier (B,) the per-parameter clamped escape
    threshold, total_bits (B,))``, all int64.
    """
    mapped = golomb.zigzag(residuals)
    w = _select_window()
    if w > 0 and 2 * w + 2 < len(ladder):
        # estimate from the values the Golomb coder sees: escapes re-enter
        # as the small outlier + level, so the raw mean would overestimate
        # g for escape-heavy blocks (the window evaluation is exact)
        esc, _, level = _multi_split(mapped, caller_outlier)
        cand = _window_candidates(
            torch.where(esc, caller_outlier + level, mapped), ladder, w)
        costs = torch.stack(
            [code_lengths_dynamic_multi(mapped, cand[:, k], caller_outlier)
             for k in range(cand.shape[1])], dim=-1)
        g, bits = _argmin(cand, costs)
    else:
        costs = torch.stack([code_lengths_for_multi(mapped, g, caller_outlier)
                             for g in ladder], dim=-1)
        cand = torch.tensor(ladder, dtype=torch.int64,
                            device=mapped.device).expand(costs.shape)
        g, bits = _argmin(cand, costs)
    return g, _clamped_outlier_multi(g, caller_outlier), bits


@_in_span("adapt.codewords")
def encode_codewords_dynamic(residuals: torch.Tensor, g_par: torch.Tensor):
    """GOLOMB_ZERO (hi, lo, len) codewords, int64, with per-block (B,)
    ``g_par``; the outlier follows the reference's closed forms
    (encoder.c:63-182) elementwise."""
    g = g_par.to(torch.int64)[..., None]
    g_log2, cutoff, outlier = zero_terms(g)
    m = golomb.zigzag(residuals)
    esc = m >= outlier
    cw, ln = golomb.golomb_codeword(torch.where(esc, 0, m + 1), g, g_log2)
    # escape: Golomb(0) zeros then 16 raw bits, one <= 32-bit code
    lo = torch.where(esc, m, cw)
    return torch.zeros_like(lo), lo, torch.where(esc, g_log2 + 17, ln)


@_in_span("adapt.codewords")
def encode_codewords_dynamic_multi(residuals: torch.Tensor,
                                   g_par: torch.Tensor,
                                   outlier: torch.Tensor):
    """GOLOMB_MULTI (hi, lo, len) codewords, int64, with per-block (B,)
    ``g_par``/``outlier``; escape codes of up to 48 bits span (hi, lo)."""
    g = g_par.to(torch.int64)[..., None]
    out = outlier.to(torch.int64)[..., None]
    g_log2 = golomb.ilog2(g)
    m = golomb.zigzag(residuals)
    esc, diff, level = _multi_split(m, out)
    cw, ln = golomb.golomb_codeword(torch.where(esc, out + level, m), g,
                                    g_log2)
    raw_bits = (level + 1) * 2  # in [2, 16]
    hi = torch.where(esc, cw >> (32 - raw_bits), 0)
    lo = torch.where(esc, ((cw << raw_bits) & MASK) | diff, cw)
    return hi, lo, torch.where(esc, ln + raw_bits, ln)
