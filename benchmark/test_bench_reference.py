"""The plain reference (benchmark/reference/) against the port's CPU
path, byte for byte, at small sizes; and its independence."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import config
from benchmark.conftest import ROOT
from benchmark.reference import airspace
from benchmark.reference.xxh32 import xxh32_u16_rows

CONFIGS = ["headline_u16", "flagship_chain_cs"]


def _frames(rng, b, n, hits):
    f = ((1100 + rng.normal(0, 6, (b, n))).astype(np.int64)
         & 0xFFFF).astype(np.uint16)
    mask = rng.random((b, n)) < hits
    f[mask] = rng.integers(0, 1 << 16, int(mask.sum()))
    return f


def _config(name):
    import json
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_equals_port(name, seed):
    import airs_compression_tpu_torch as tx
    cfg = _config(name)
    rng = np.random.default_rng(seed)
    B, N, K = 5, 96, 18                    # past one 16-batch chain cycle
    frames = [_frames(rng, B, N, 0.01) for _ in range(K)]
    tx.set_timestamp_func(airspace.Stamp(77 + seed))
    try:
        bc = tx.BatchCompressor(config.program_params(cfg, tx), B, N,
                                device="cpu")
        port = [bc.compress_frames_packed(f) for f in frames]
    finally:
        tx.set_timestamp_func(None)
    streams, sizes, _ = airspace.encode_chain(
        [torch.from_numpy(f.astype(np.int32)) for f in frames],
        config.reference_params(cfg), airspace.Stamp(77 + seed))
    for (s, z), rs, rz in zip(port, streams, sizes):
        assert np.array_equal(z, rz)
        assert s == rs.tobytes()


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 64, 257])
def test_xxh32_equals_port_host(n):
    from airs_compression_tpu_torch.utils.xxh32 import cmp_checksum
    x = np.random.default_rng(n).integers(0, 1 << 16, (3, n)).astype(
        np.uint16)
    got = xxh32_u16_rows(torch.from_numpy(x.astype(np.int64)))
    assert got.tolist() == [cmp_checksum(r) for r in x]


@pytest.mark.parametrize("enc,g,out", [(1, 1, 0), (1, 4, 0), (1, 300, 0),
                                       (2, 2, 40), (2, 2, 1000),
                                       (2, 0xFFFF, 9)])
def test_outlier_equals_port(enc, g, out):
    from airs_compression_tpu_torch.utils.bits import derive_encoder_outlier
    assert airspace.derive_outlier(enc, g, out) == \
        derive_encoder_outlier(enc, g, out)


def test_stamp_draws_are_its_calls():
    a, b = airspace.Stamp(70000), airspace.Stamp(70000)
    calls = [((c << 16) | f) for c, f in (a() for _ in range(5))]
    assert calls == b.draw(5).tolist()


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.airspace, benchmark.config; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('airs_compression_tpu_torch', 'airs_compression_tpu', 'jax')]; "
            "print(bad); sys.exit(1 if bad else 0)" % str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
