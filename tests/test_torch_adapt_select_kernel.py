"""The adaptive choice's kernel (``csrc/adapt.cu``, ``ops/adapt.py``'s
``select_params``) against its plain version, ``select_params_plain``.

On the CPU: the ladder table the kernel reads (its float32 midpoints are
the values ``_window_candidates`` compares against), the ladders it
refuses, the CPU wrapper taking the plain version, the closed-form
outliers the kernel uses in full-ladder mode against ``utils.bits``, and
a numpy model of the kernel's arithmetic (the IEEE float32 estimate, the
midpoint count, the candidate list, the multiply-high divide, the first
cheapest candidate) held to the plain version exactly.

The tests marked ``card`` hold the kernel to the plain version, exactly,
for ``g``, ``outlier`` and ``bits``: GOLOMB_ZERO and GOLOMB_MULTI (caller
outlier 40 and 2**20), the fast window (w = 1, 2, 4) and the full
ladder, three ladders, N of 1000, 1024, 8192 and 20000 (past the shared
memory staging), on widening noise, full-range blocks whose sums pass
2**24, escape-heavy blocks and an all-zero block.  They also hold one
launch a call, no synchronisation (``torch.cuda.set_sync_debug_mode``),
and whole frames through ``BatchCompressor(adaptive=True)`` to the CPU's.
They skip without a card; on the card: ``python -m pytest
tests/test_torch_adapt_select_kernel.py -m card --noconftest -q`` (this
file imports no JAX).
"""

import numpy as np
import pytest
import torch

import airs_compression_tpu_torch as tx
from airs_compression_tpu_torch.ops import adapt
from airs_compression_tpu_torch.utils.bits import (
    golomb_optimal_outlier_zero, golomb_upper_bound)

LADDERS = {"default": adapt.DEFAULT_LADDER,
           "pow2": (1, 2, 4, 8, 16, 32, 64),
           "two": (1, 2)}
# (AIRS_ADAPTIVE_SELECT, AIRS_ADAPTIVE_WINDOW)
MODES = {"fast": ("fast", "2"), "fast_w1": ("fast", "1"),
         "fast_w4": ("fast", "4"), "exact": ("exact", "2")}
# None: GOLOMB_ZERO; else GOLOMB_MULTI's caller outlier
CALLERS = {"zero": None, "multi40": 40, "multi_large": 1 << 20}


def _corpora(n: int) -> np.ndarray:
    """(21, n) int32 residuals: tests/test_torch_adapt.py's corpora
    (widening noise, full-range blocks, escape-heavy blocks) and an
    all-zero block."""
    rng = np.random.default_rng(0)
    blocks = [rng.normal(0, 0.7 * (1 + i), n) for i in range(12)]
    blocks.append(rng.integers(-32768, 32768, n).astype(float))
    blocks.append(rng.integers(-32768, 32768, n).astype(float))
    for seed in range(3):
        r = np.random.default_rng(seed)
        blocks.append(r.normal(0, r.uniform(0.1, 5000), n))
        blocks.append(r.standard_t(2, n) * r.uniform(1, 500))
    blocks.append(np.zeros(n))
    return np.stack([np.clip(b, -32768, 32767) for b in blocks]) \
        .astype(np.int32)


@pytest.fixture
def mode(request, monkeypatch):
    select, window = MODES[request.param]
    monkeypatch.setenv("AIRS_ADAPTIVE_SELECT", select)
    monkeypatch.setenv("AIRS_ADAPTIVE_WINDOW", window)
    return request.param


def _plain(res: np.ndarray, ladder, caller):
    return [t.numpy() for t in adapt.select_params_plain(
        torch.from_numpy(res), ladder, caller)]


# -- the host side -----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(LADDERS))
def test_ladder_table_holds_the_plain_midpoints(name):
    ladder = LADDERS[name]
    lad, mids = adapt._ladder_table(ladder, torch.device("cpu"))
    assert lad.dtype == torch.int32 and lad.tolist() == list(ladder)
    want = [torch.tensor((a * b) ** 0.5, dtype=torch.float32)
            for a, b in zip(ladder[:-1], ladder[1:])]
    assert mids.dtype == torch.float32 and mids.shape == (len(ladder) - 1,)
    assert mids.tolist() == [float(m) for m in want]
    assert adapt._ladder_table(ladder, torch.device("cpu"))[0] is lad


@pytest.mark.parametrize("ladder", [(), (0, 1, 2), (1, 2, 0x10000),
                                    (4, 2, 8), (1, 2.5, 4), (-3,)])
def test_ladder_table_refuses_bad_ladders(ladder):
    with pytest.raises(ValueError, match="ladder"):
        adapt._ladder_table(ladder, torch.device("cpu"))


@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_cpu_tensors_take_the_plain_version(caller, monkeypatch):
    """On the CPU no kernel is built, loaded or counted, and the
    selectors return the plain version's answer."""
    def no_kernel(*args):
        raise AssertionError("the CPU path reached the kernel")

    monkeypatch.setattr(adapt._build, "function", no_kernel)
    res = _corpora(256)
    launches = adapt.select_params.launches
    want = _plain(res, adapt.DEFAULT_LADDER, CALLERS[caller])
    got = adapt.select_params(torch.from_numpy(res),
                              caller_outlier=CALLERS[caller])
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), b)
    if CALLERS[caller] is None:
        g, bits = adapt.select_golomb_zero(torch.from_numpy(res))
        assert np.array_equal(g.numpy(), want[0])
        assert np.array_equal(bits.numpy(), want[2])
    assert adapt.select_params.launches == launches


def test_other_devices_raise():
    with pytest.raises(ValueError, match="unsupported device"):
        adapt.select_params(torch.zeros((2, 8), dtype=torch.int32,
                                        device="meta"))


def test_closed_form_outliers_equal_the_header_bounds():
    """The kernel's per-candidate outliers in full-ladder mode: ZERO's
    optimal zero-escape outlier clamped to the 32-bit bound, and the
    MULTI bound, closed forms equal to utils.bits for every parameter."""
    g = torch.arange(1, 0x10000, dtype=torch.int64)
    _, _, zero = adapt.zero_terms(g)
    multi = adapt._clamped_outlier_multi(g, 1 << 30)
    params = range(1, 0x10000)
    want_zero = [min(golomb_optimal_outlier_zero(p, 16),
                     golomb_upper_bound(p, False, 16)) for p in params]
    want_multi = [golomb_upper_bound(p, True, 16) for p in params]
    assert zero.tolist() == want_zero
    assert multi.tolist() == want_multi


# -- a numpy model of the kernel's arithmetic ---------------------------------

def _terms(g: int, caller):
    """cand_terms: (glog2, cutoff, outlier, magic, sh1, sh2)."""
    glog2 = g.bit_length() - 1
    cutoff = (2 << glog2) - g
    upper = cutoff + (31 - glog2) * g
    outlier = (min(caller, upper - 8) if caller is not None
               else min(cutoff + 16 * g - 1, upper))
    ell = (g - 1).bit_length() if g > 1 else 0
    magic = ((1 << 32) * ((1 << ell) - g)) // g + 1
    return glog2, cutoff, outlier, magic, min(ell, 1), max(ell - 1, 0)


def _level(d):
    return np.where(d < 4, 0, np.floor(np.log2(np.maximum(d, 1))
                                       ).astype(np.int64) >> 1)


def _model_cost(m, g: int, caller) -> int:
    """One block's coded bits under g, with the multiply-high divide."""
    glog2, cutoff, outlier, magic, sh1, sh2 = _terms(g, caller)

    def length(v):
        x = np.maximum(v - cutoff, 0).astype(np.uint64)
        t = (x * np.uint64(magic)) >> np.uint64(32)
        q = ((t + ((x - t) >> np.uint64(sh1))) >> np.uint64(sh2)) \
            .astype(np.int64)
        assert np.array_equal(q, np.maximum(v - cutoff, 0) // g)
        return np.where(v < cutoff, glog2 + 1, glog2 + 2 + q)

    esc = m >= outlier
    if caller is None:
        return int(np.where(esc, glog2 + 17, length(m + 1)).sum())
    level = _level(np.where(esc, m - outlier, 0))
    return int((length(np.where(esc, outlier + level, m))
                + np.where(esc, 2 * (level + 1), 0)).sum())


def _kernel_model(res: np.ndarray, ladder, caller, w: int):
    """csrc/adapt.cu's choice, one block at a time: (g, outlier, bits)."""
    v = res.astype(np.int32)
    m = ((v.astype(np.uint32) << np.uint32(1))
         ^ (v >> 15).astype(np.uint32)) & np.uint32(0xFFFF)
    m = m.astype(np.int64)
    mids = np.array([(a * b) ** 0.5 for a, b in zip(ladder[:-1], ladder[1:])],
                    np.float32)
    window = w > 0 and 2 * w + 2 < len(ladder)
    out = []
    for row in m:
        if window:
            c = min(caller, 0x7FFFFFFF) if caller is not None else None
            vals = row if c is None else np.where(
                row < c, row, c + _level(row - c))
            mu = np.float32(int(vals.sum())) / np.float32(row.size)
            est = np.float32(0.69) * mu
            idx = int((mids < est).sum())
            at = [0] + [min(max(idx - w + k, 0), len(ladder) - 1)
                        for k in range(2 * w + 1)]
        else:
            at = range(len(ladder))
        costs = [_model_cost(row, ladder[a], caller) for a in at]
        best = int(np.argmin(costs))
        g = ladder[at[best]]
        out.append((g, _terms(g, caller)[2], costs[best]))
    return [np.array(col, np.int64) for col in zip(*out)]


@pytest.mark.parametrize("ladder", sorted(LADDERS))
@pytest.mark.parametrize("caller", sorted(CALLERS))
@pytest.mark.parametrize("mode", ["fast", "fast_w4", "exact"],
                         indirect=True)
def test_kernel_model_equals_the_plain_version(mode, caller, ladder):
    res = _corpora(1000)
    w = adapt._select_window()
    got = _kernel_model(res, LADDERS[ladder], CALLERS[caller], w)
    want = _plain(res, LADDERS[ladder], CALLERS[caller])
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("n", [1000, 1024, 8192, 20000])
@pytest.mark.parametrize("ladder", sorted(LADDERS))
@pytest.mark.parametrize("caller", sorted(CALLERS))
@pytest.mark.parametrize("mode", sorted(MODES), indirect=True)
def test_kernel_equals_the_plain_version(card, mode, caller, ladder, n):
    """g, outlier and bits of every block, exactly, in one launch."""
    res = _corpora(n)
    lad = LADDERS[ladder]
    want = _plain(res, lad, CALLERS[caller])
    dev = torch.from_numpy(res).to(card)
    launches = adapt.select_params.launches
    got = adapt.select_params(dev, lad, CALLERS[caller])
    assert adapt.select_params.launches == launches + 1
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == torch.int64 and a.device == dev.device
        assert np.array_equal(a.cpu().numpy(), b)


@pytest.mark.card
@pytest.mark.parametrize("caller", sorted(CALLERS))
def test_kernel_does_not_synchronise(card, caller):
    """After a first call (which uploads the ladder), a call issues no
    synchronising operation."""
    res = torch.from_numpy(_corpora(8192)).to(card)
    adapt.select_params(res, caller_outlier=CALLERS[caller])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        if CALLERS[caller] is None:
            got = adapt.select_golomb_zero(res)
        else:
            got = adapt.select_golomb_multi(res, CALLERS[caller])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    want = _plain(res.cpu().numpy(), adapt.DEFAULT_LADDER, CALLERS[caller])
    assert np.array_equal(got[0].cpu().numpy(), want[0])
    assert np.array_equal(got[-1].cpu().numpy(), want[2])


class _Stamp:
    """Deterministic timestamps, so two compressors draw the same ids."""

    def __init__(self):
        self.counter = 0

    def __call__(self):
        c = self.counter
        self.counter += 1
        return (c >> 16) & 0xFFFFFFFF, c & 0xFFFF


CHAIN = tx.CmpParams(
    primary_preprocessing=tx.Preprocessing.DIFF,
    primary_encoder_type=tx.EncoderType.GOLOMB_ZERO, primary_encoder_param=4,
    secondary_iterations=3, secondary_preprocessing=tx.Preprocessing.MODEL,
    secondary_encoder_type=tx.EncoderType.GOLOMB_MULTI,
    secondary_encoder_param=2, secondary_encoder_outlier=40, model_rate=8,
    checksum_enabled=True)


def _frames(seed, batches, b, n):
    """Row r: 1100 + N(0, 0.7 (1 + r mod 12)), full-range hits at 1e-3."""
    rng = np.random.default_rng(seed)
    sigma = 0.7 * (1 + np.arange(b) % 12)
    x = (1100 + rng.normal(0, 1, (batches, b, n)) * sigma[:, None]
         ).astype(np.int64)
    hit = rng.random(x.shape) < 1e-3
    x[hit] = rng.integers(0, 1 << 16, int(hit.sum()))
    return (x & 0xFFFF).astype(np.uint16)


def _chain(frames, device):
    _, b, n = frames.shape
    tx.set_timestamp_func(_Stamp())
    try:
        bc = tx.BatchCompressor(CHAIN, b, n, adaptive=True, device=device)
        return [tuple(a.copy() for a in
                      bc.compress_frames_packed(f, as_array=True))
                for f in frames]
    finally:
        tx.set_timestamp_func(None)


@pytest.mark.card
def test_adaptive_frames_on_the_card_equal_the_cpu(card):
    """Five batches of the 1 + 3 MODEL chain, the primary pass twice:
    the card's packed streams and sizes equal the CPU's, byte for byte,
    and each batch launches the kernel once."""
    frames = _frames(3, 5, 64, 1024)
    launches = adapt.select_params.launches
    got = _chain(frames, card)
    assert adapt.select_params.launches == launches + len(frames)
    for (gs, gz), (ws, wz) in zip(got, _chain(frames, "cpu")):
        assert np.array_equal(gz, wz)
        assert gs.tobytes() == ws.tobytes()
