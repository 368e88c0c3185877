"""The adaptive tier against the benchmark's plain reference: the port's
``BatchCompressor(adaptive=True)`` (ops/adapt.py, models/stream.py) and
``benchmark/reference/adaptive.py`` give the same packed stream and frame
sizes, byte for byte, on chains of widening read noise with full-range
hits (the cell ``adaptive-chain-encode``'s statistics) at B = 24, N = 512.

Cases: GOLOMB_ZERO alone; GOLOMB_MULTI alone; the DIFF + ZERO primary
then 3 MODEL + MULTI passes with checksums and a stamp, into the next
primary; a block whose cheapest candidates tie (the lowest ladder index
wins, which is not ``ladder[0]``); an incompressible full-range block
(``ladder[0]`` wins, from outside the window); and the chain under
``AIRS_ADAPTIVE_SELECT=exact``, set inside the test and restored.  No JAX.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import airs_compression_tpu_torch as tx
from airs_compression_tpu_torch.ops.adapt import DEFAULT_LADDER

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark.reference import adaptive, airspace  # noqa: E402

P, E = tx.Preprocessing, tx.EncoderType
B, N = 24, 512
ZERO = dict(primary_preprocessing=P.DIFF, primary_encoder_type=E.GOLOMB_ZERO,
            primary_encoder_param=4)
MULTI = dict(primary_preprocessing=P.DIFF,
             primary_encoder_type=E.GOLOMB_MULTI, primary_encoder_param=2,
             primary_encoder_outlier=40)
CHAIN = dict(ZERO, secondary_iterations=3,
             secondary_preprocessing=P.MODEL,
             secondary_encoder_type=E.GOLOMB_MULTI,
             secondary_encoder_param=2, secondary_encoder_outlier=40,
             model_rate=8, checksum_enabled=True)
TIE_ROW, FLAT_ROW = 5, 9
G_AT = slice(17, 19)          # encoder_param in the 22-byte header


def _widening(seed, batches):
    """Row b: 1100 + N(0, 0.7 (1 + b mod 12)), full-range hits at 1e-3."""
    rng = np.random.default_rng(seed)
    sigma = 0.7 * (1 + np.arange(B) % 12)
    x = (1100 + rng.normal(0, 1, (batches, B, N)) * sigma[:, None]
         ).astype(np.int64)
    hit = rng.random(x.shape) < 1e-3
    x[hit] = rng.integers(0, 1 << 16, int(hit.sum()))
    return (x & 0xFFFF).astype(np.uint16)


def _tied(frames):
    """Row TIE_ROW: 4, 0, -4, ... (mod 2**16); its DIFF residuals map to
    8 then 7, which cost 5 bits a sample under the parameters 3, 4, 6, 8,
    12 and 16 alike, 6 or more under the others: the fast window (centre
    4, from g* = 0.69 * 7.0) holds 2, 3, 4, 6, 8, so 3 must win."""
    frames[:, TIE_ROW] = (4 - 4 * np.arange(N)) & 0xFFFF
    return frames


def _flat(frames):
    """Row FLAT_ROW: uniform full-range samples, which escape at 17 bits a
    sample under ``ladder[0]`` and cost more under every other entry."""
    rng = np.random.default_rng(99)
    frames[:, FLAT_ROW] = rng.integers(0, 1 << 16, (frames.shape[0], N))
    return frames


CASES = {
    "zero": (ZERO, 2, None),
    "multi": (MULTI, 2, None),
    "chain": (CHAIN, 5, None),
    "tie": (ZERO, 2, _tied),
    "incompressible": (ZERO, 2, _flat),
    "exact": (CHAIN, 5, None),
}


def _reference_params(params):
    return airspace.Params(**{k: int(v) for k, v in params.items()})


def _frame_params(stream, sizes):
    starts = np.cumsum(sizes) - sizes
    return np.array([int.from_bytes(stream[s:s + 22][G_AT], "big")
                     for s in starts])


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_equals_the_reference(case, monkeypatch):
    params, batches, build = CASES[case]
    select = "exact" if case == "exact" else "fast"
    if case == "exact":
        monkeypatch.setenv("AIRS_ADAPTIVE_SELECT", "exact")
    else:
        monkeypatch.delenv("AIRS_ADAPTIVE_SELECT", raising=False)
    monkeypatch.delenv("AIRS_ADAPTIVE_WINDOW", raising=False)
    frames = _widening(sorted(CASES).index(case) + 2 ** 33, batches)
    if build is not None:
        frames = build(frames)
    stamp0 = 2 ** 40 - 3                  # identifiers cross 2**40
    tx.set_timestamp_func(airspace.Stamp(stamp0))
    try:
        bc = tx.BatchCompressor(tx.CmpParams(**params), B, N, adaptive=True,
                                device="cpu")
        got = [bc.compress_frames_packed(f) for f in frames]
    finally:
        tx.set_timestamp_func(None)
    streams, sizes, _ = adaptive.encode_chain(
        [torch.from_numpy(f.astype(np.int32)) for f in frames],
        _reference_params(params), airspace.Stamp(stamp0), DEFAULT_LADDER,
        select=select)
    chosen = set()
    for (stream, got_sizes), want, want_sizes in zip(got, streams, sizes):
        np.testing.assert_array_equal(got_sizes, want_sizes)
        assert stream == want.tobytes()
        g = _frame_params(want, want_sizes)
        chosen |= set(g.tolist())
        if case == "tie":
            assert g[TIE_ROW] == 3
        elif case == "incompressible":
            assert g[FLAT_ROW] == DEFAULT_LADDER[0]
    # the widening noise makes the blocks choose different parameters
    assert len(chosen) >= 4
