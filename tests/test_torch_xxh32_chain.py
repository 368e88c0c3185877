"""K4's u-form round and its long path's stage boundaries, on the CPU.

* The u-form recurrence as K4 (``csrc/xxh32.cu``) runs it (entry
  ``rotr13(acc * P1^-1)``, rounds ``rotl13(u) * P1 + w * P2``, exit
  ``rotl13(u) * P1``) equals the lanes of the JAX package's ``XXH32State``.
* The port's plain K4 (``checksum_stream_device``, ``StreamHasher``,
  ``xxh32_lanes`` on ``device="cpu"``) equals the JAX package's XXH32 at the
  long path's stage boundaries, in stripes: 0, 1, one stage and one stripe
  either side, the path switch, and a few stages and 7 samples.
"""

import numpy as np
import pytest
import torch

from airs_compression_tpu.utils import xxh32 as j_xxh
from airs_compression_tpu_torch.ops.xxh32_device import (
    LONG_MIN_SAMPLES,
    STAGE_STRIPES,
    StreamHasher,
    checksum_stream_device,
    xxh32_lanes,
)

CPU = torch.device("cpu")
STAGE = 8 * STAGE_STRIPES  # samples a stage
M32 = 0xFFFFFFFF
XXH_P1, XXH_P2 = 2654435761, 2246822519
XXH_P1_INV = pow(XXH_P1, -1, 1 << 32)  # csrc/xxh32.cu kP1Inv


def _rotl32(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & M32


def uform_rounds(acc: int, ts) -> int:
    """One lane's u after the rounds of its t words ``ts`` (``t = w * P2``)
    in K4's u-form: from ``u = rotr13(acc * P1^-1)``, the u whose next round
    gives ``acc + t_0``, each round ``u = rotl13(u) * P1 + t``; the lane in
    acc-form is ``rotl13(u) * P1`` (:func:`uform_exit`)."""
    u = _rotl32(acc * XXH_P1_INV & M32, 19)
    for t in ts:
        u = (_rotl32(u, 13) * XXH_P1 + t) & M32
    return u


def uform_exit(u: int) -> int:
    return _rotl32(u, 13) * XXH_P1 & M32


@pytest.fixture
def jax_lanes(monkeypatch):
    """The JAX package's XXH32State on its pure-Python path, which keeps
    its four lanes in ``_acc`` (the ``xxhash`` module hides them)."""
    monkeypatch.setattr(j_xxh, "_xxhash_mod", None)
    return j_xxh.XXH32State


@pytest.mark.parametrize("stripes", [0, 1, 5, STAGE_STRIPES,
                                     STAGE_STRIPES + 1])
def test_uform_recurrence_equals_jax_state(jax_lanes, stripes):
    """The u-form recurrence over real stripes gives XXH32State's lanes."""
    data = np.random.default_rng(stripes).integers(
        0, 256, 16 * stripes, dtype=np.uint8).tobytes()
    state = jax_lanes(j_xxh.CHECKSUM_SEED)
    start = list(state._acc)
    state.update(data)
    words = np.frombuffer(data, "<u4").reshape(-1, 4).astype(np.int64)
    got = [uform_exit(uform_rounds(
        start[lane], [int(w) * XXH_P2 & M32 for w in words[:, lane]]))
        for lane in range(4)]
    assert got == state._acc


# samples: 0 stripes (7 samples), 1 stripe, one stage and a stripe either
# side, the long path's switch and a stripe below, a few stages + 7 samples
STAGE_N = [7, 8, STAGE - 8, STAGE, STAGE + 8, LONG_MIN_SAMPLES - 8,
           LONG_MIN_SAMPLES, 3 * STAGE + 7]


@pytest.mark.parametrize("n", STAGE_N)
def test_stage_boundaries_one_row(n):
    x = np.random.default_rng(n).integers(0, 1 << 16, n).astype(np.uint16)
    got = int(checksum_stream_device(torch.from_numpy(x.view(np.int16))))
    assert got == j_xxh.cmp_checksum(x) \
        == j_xxh.xxh32(x.astype(">u2").tobytes(), j_xxh.CHECKSUM_SEED)


@pytest.mark.parametrize("n", STAGE_N)
def test_stage_boundaries_stream_hasher(n):
    """Pieces cut at a stage boundary, a stripe either side and 3 samples
    past it, straddling stages."""
    x = np.random.default_rng(n + 1).integers(0, 1 << 16, 2 * n) \
        .astype(np.uint16)
    h = StreamHasher(CPU)
    prev = 0
    for c in sorted({min(c, x.size) for c in
                     (STAGE - 8, STAGE + 3, n, n + STAGE + 8)}) + [x.size]:
        h.update(torch.from_numpy(x[prev:c].view(np.int16)))
        prev = c
    assert h.intdigest() == j_xxh.cmp_checksum(x)


@pytest.mark.parametrize("n", STAGE_N)
def test_stage_boundaries_lanes(jax_lanes, n):
    """Three rows of whole stripes, each row its own lanes, equal three
    XXH32States."""
    n -= n % 8
    x = np.random.default_rng(n + 2).integers(0, 1 << 16, (3, n)) \
        .astype(np.uint16)
    states = [jax_lanes(j_xxh.CHECKSUM_SEED + r) for r in range(3)]
    lanes = torch.tensor([s._acc for s in states], dtype=torch.int64)
    lanes = torch.where(lanes >= 1 << 31, lanes - (1 << 32), lanes).int()
    xxh32_lanes(lanes, torch.from_numpy(x.view(np.int16)))
    for row, s in enumerate(states):
        s.update(x[row].astype(">u2").tobytes())
        assert lanes[row].numpy().view(np.uint32).tolist() == s._acc
