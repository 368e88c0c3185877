"""The long-stream chain of the benchmark's cell ``long-chain-encode``:
the port's ``LongStreamCompressor`` (parallel/sp.py) against the plain
reference of ``benchmark/reference/``, and the tier's spans and transfer
counters.

The reference's IWT is held to upstream's golden vectors
(test_preprocessing.c:74-92) and its long-row XXH32 to the reference's
row XXH32; the port's chain (IWT primary, two MODEL passes, checksums)
equals the reference's frame for frame over a cycle and the next primary
under one stamp.  One compress opens ``sp.encode.upload``,
``sp.encode.preprocess``, ``sp.encode.codes``, ``sp.encode.pack``,
``sp.encode.checksum``, ``sp.encode.fetch`` and then ``sp.chain.update``,
each once, none overlapping; every copy of an encode goes through the
tier's ``_upload`` and ``_fetch``, which count pageable bytes only where a
CUDA device is one side of the copy.  The chain's model stays on the
device: it equals the reference's after every block, a MODEL block copies
only its samples up, the update makes a new tensor (a model read before a
block and assigned back restores that state), a numpy model assigned
mid-chain continues the JAX package's chain (the one test that imports
it, inside itself), and ``model_blocks`` / ``model_resident_blocks``
count MODEL blocks and those whose model was already on the device.

The tests marked ``card`` hold the counters to the copies' sizes on the
card and skip without one: ``python -m pytest
tests/test_torch_long_chain.py -m card --noconftest -q`` (this file
imports no JAX at module level).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

import airs_compression_tpu_torch as tx
from airs_compression_tpu_torch.ops import preprocess
from airs_compression_tpu_torch.parallel import sp

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark.reference import airspace  # noqa: E402
from benchmark.reference.iwt import iwt_forward  # noqa: E402
from benchmark.reference.long_chain import LongContext  # noqa: E402
from benchmark.reference.xxh32 import xxh32_u16_rows  # noqa: E402
from benchmark.reference.xxh32_long import xxh32_u16_long  # noqa: E402

P, E = tx.Preprocessing, tx.EncoderType
LONG_CHAIN = dict(primary_preprocessing=P.IWT,
                  primary_encoder_type=E.GOLOMB_ZERO,
                  primary_encoder_param=4, secondary_iterations=2,
                  secondary_preprocessing=P.MODEL,
                  secondary_encoder_type=E.GOLOMB_ZERO,
                  secondary_encoder_param=2, model_rate=8,
                  checksum_enabled=True)
STEPS = ["sp.encode.upload", "sp.encode.preprocess", "sp.encode.codes",
         "sp.encode.pack", "sp.encode.checksum", "sp.encode.fetch"]


def _reference_params():
    return airspace.Params(**{k: int(v) for k, v in LONG_CHAIN.items()})


def _blocks(seed, k, n):
    """k blocks of the cell's statistics: 1100 + N(0, 6), full-range hits
    at 1e-3 a sample."""
    rng = np.random.default_rng(seed)
    x = (1100 + rng.normal(0, 6, (k, n))).astype(np.int64)
    hit = rng.random((k, n)) < 1e-3
    x[hit] = rng.integers(0, 1 << 16, int(hit.sum()))
    return (x & 0xFFFF).astype(np.uint16)


@pytest.mark.parametrize("inp,exp", [
    ([42], [42]),
    ([-23809, 23901], [-32722, -17826]),
    ([-1, 2, -3, 4, -5], [0, 4, 0, 8, -2]),
    ([0, 0, 2, 0, 0, 0, 0], [-1, -1, 2, -1, -1, 0, 1]),
    ([-3, 2, -1, 3, -2, 5, 0, 7], [0, 4, 2, 5, 1, 6, 3, 7]),
])
def test_reference_iwt_goldens(inp, exp):
    """Upstream test_preprocessing.c:74-92, inputs as u16 wraparound."""
    x = torch.tensor(inp) & 0xFFFF
    assert iwt_forward(x).tolist() == exp


@pytest.mark.parametrize("n", [1, 2, 3, 6, 7, 33, 1000, 1 << 12])
def test_reference_iwt_equals_the_ports(n):
    x = torch.from_numpy(_blocks(n, 3, n).astype(np.int64))
    want = preprocess.iwt_forward(preprocess.wrap16(x.to(torch.int32)))
    assert torch.equal(iwt_forward(x), want.to(torch.int64))


@pytest.mark.parametrize("n", [*range(10), 31, 1023, 4096])
def test_long_row_xxh32_equals_the_row_xxh32(n):
    x = _blocks(100 + n, 3, n)
    got = xxh32_u16_long(x)
    assert got.dtype == np.uint32
    want = xxh32_u16_rows(torch.from_numpy(x.astype(np.int64)))
    assert got.astype(np.int64).tolist() == want.tolist()


@pytest.mark.parametrize("n", [1 << 10, 1 << 14])
def test_compressor_equals_the_reference_chain(n):
    """Four blocks, a whole cycle and the next primary, under one stamp:
    the compressor draws one identifier when it is made and one a primary
    pass, as the reference context does."""
    x = _blocks(n, 4, n)
    tx.set_timestamp_func(airspace.Stamp(2 ** 40 - 2))
    try:
        lc = sp.LongStreamCompressor(tx.CmpParams(**LONG_CHAIN),
                                     device="cpu")
        got = [lc.compress(b) for b in x]
    finally:
        tx.set_timestamp_func(None)
    want = LongContext(_reference_params(),
                       airspace.Stamp(2 ** 40 - 2)).encode_all(x)
    assert [len(f) for f in got] == [w.size for w in want]
    for f, w in zip(got, want):
        assert f == w.tobytes()
    # identifiers 2^40 - 1, then 2^40 after the primary reset
    assert [int.from_bytes(f[8:14], "big") for f in got] == \
        [2 ** 40 - 1] * 3 + [2 ** 40]


def _reference_model(ctx):
    """The reference context's model as the port keeps it: sign-extended
    i16 values."""
    return ((ctx.model + 0x8000) & 0xFFFF) - 0x8000


@pytest.mark.parametrize("n", [1 << 10, 1 << 14])
def test_model_equals_the_references_after_every_block(n):
    """IWT, MODEL, MODEL, IWT: after every block the compressor's model
    is an int32 tensor on its device, equal to the reference's, and
    reading it twice gives the one tensor."""
    x = _blocks(n + 1, 4, n)
    lc = sp.LongStreamCompressor(tx.CmpParams(**LONG_CHAIN), device="cpu")
    ref = LongContext(_reference_params(), airspace.Stamp(0))
    for b in x:
        lc.compress(b)
        ref.encode(b)
        assert lc.model.dtype == torch.int32
        assert lc.model.device.type == "cpu"
        assert lc.model is lc.model
        assert torch.equal(lc.model.to(torch.int64), _reference_model(ref))


@pytest.mark.parametrize("n", [1 << 10, 1 << 14])
def test_model_assigned_back_restores_the_earlier_state(n):
    """The model read before a MODEL block and assigned back after it:
    the next frame is the reference's from that earlier state, so the
    update made a new tensor and left the one read alone."""
    x = _blocks(n + 2, 3, n)
    tx.set_timestamp_func(airspace.Stamp(77))
    try:
        lc = sp.LongStreamCompressor(tx.CmpParams(**LONG_CHAIN),
                                     device="cpu")
        lc.compress(x[0])
        before = lc.model
        kept = before.clone()
        lc.compress(x[1])
        assert torch.equal(before, kept)
        assert not torch.equal(lc.model, kept)
        lc.model = before
        assert lc.model is before
        got = lc.compress(x[2])
    finally:
        tx.set_timestamp_func(None)
    ref = LongContext(_reference_params(), airspace.Stamp(77))
    ref.encode(x[0])
    earlier = ref.model
    ref.encode(x[1])
    chained = LongContext(_reference_params(), airspace.Stamp(77))
    chained.encode_all(x[:2])
    ref.model = earlier
    want = ref.encode(x[2])
    assert got == want.tobytes()
    # without the restore the frame differs: the check can see a model
    # the update wrote into
    assert got != chained.encode(x[2]).tobytes()
    assert torch.equal(lc.model.to(torch.int64), _reference_model(ref))


def _jax_params():
    import airs_compression_tpu as act

    return act.CmpParams(**{
        k: getattr(act, type(v).__name__)[v.name] if hasattr(v, "name")
        else v for k, v in LONG_CHAIN.items()})


@pytest.mark.parametrize("dtype", [np.int16, np.uint16])
def test_host_model_assigned_mid_chain_continues_the_jax_chain(dtype):
    """A numpy model (i16, or its u16 bits) read off the JAX package's
    context after its primary block and assigned to a compressor whose
    primary block was another: the compressor continues the context's
    chain byte-exact.  The JAX package is imported here alone: the rest
    of this file runs without it."""
    import airs_compression_tpu as act

    n = 1 << 10
    x = _blocks(21, 4, n)
    act.set_timestamp_func(airspace.Stamp(3))
    tx.set_timestamp_func(airspace.Stamp(3))
    try:
        ctx = act.CmpContext(_jax_params())
        lc = sp.LongStreamCompressor(tx.CmpParams(**LONG_CHAIN),
                                     device="cpu")
        ctx.compress_u16(x[0])
        lc.compress(_blocks(22, 1, n)[0])
        lc.model = np.asarray(ctx.model).astype(dtype)
        assert lc.model.dtype == torch.int32
        assert torch.equal(lc.model,
                           torch.from_numpy(ctx.model.astype(np.int32)))
        want = [ctx.compress_u16(b) for b in x[1:]]
        got = [lc.compress(b) for b in x[1:]]
    finally:
        act.set_timestamp_func(None)
        tx.set_timestamp_func(None)
    assert got == want
    np.testing.assert_array_equal(lc.model.cpu().numpy(), ctx.model)


def _spans(prof):
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith("sp.")),
                  key=lambda r: r[1])


@pytest.mark.parametrize("block", [0, 1])
def test_compress_spans(block):
    """A primary (IWT) and a secondary (MODEL) block: the encode's six
    spans, then the chain's update, each once and flat."""
    x = _blocks(3, 2, 1 << 10)
    lc = sp.LongStreamCompressor(tx.CmpParams(**LONG_CHAIN), device="cpu")
    if block:
        lc.compress(x[0])
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        lc.compress(x[block])
    spans = _spans(prof)
    assert [s[0] for s in spans] == [*STEPS, "sp.chain.update"]
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start


def _calls(monkeypatch):
    """Wrap the tier's copy helpers: (helper, bytes) of each copy, in
    order."""
    calls = []

    def wrap(helper, arg):
        def call(*args):
            calls.append((helper.__name__, arg(*args).nbytes))
            return helper(*args)
        return call

    monkeypatch.setattr(sp, "_upload", wrap(sp._upload, lambda a, d: a))
    monkeypatch.setattr(sp, "_fetch", wrap(sp._fetch, lambda t: t))
    return calls


def _total(calls):
    seen = {"_upload": 0, "_fetch": 0}
    for name, nbytes in calls:
        seen[name] += nbytes
    return seen


def _want(frames, n):
    """What a chain of IWT and MODEL blocks copies: each block's samples
    up (int16) and its frame and its two int64 scalars (the payload's
    bits, the checksum) down; the model stays on the device."""
    return {"_upload": 2 * n * len(frames),
            "_fetch": sum(len(f) + 16 for f in frames)}


def test_counters_count_an_encodes_copies_and_stay_zero_on_the_cpu(
        monkeypatch):
    n = 1 << 10
    x = _blocks(7, 4, n)
    before = (sp._upload.pageable_bytes, sp._fetch.pageable_bytes)
    blocks0 = sp.encoded_blocks
    calls = _calls(monkeypatch)
    lc = sp.LongStreamCompressor(tx.CmpParams(**LONG_CHAIN), device="cpu")
    frames = [lc.compress(b) for b in x]
    assert _total(calls) == _want(frames, n)
    assert sp.encoded_blocks - blocks0 == 4
    monkeypatch.undo()
    assert (sp._upload.pageable_bytes, sp._fetch.pageable_bytes) == before


def test_model_block_copies_only_its_samples_up(monkeypatch):
    """A MODEL block uploads its samples alone and fetches what a primary
    block fetches: the two scalars and its frame, nothing model-sized;
    reading the model between blocks copies nothing."""
    n = 1 << 10
    x = _blocks(8, 3, n)
    calls = _calls(monkeypatch)
    lc = sp.LongStreamCompressor(tx.CmpParams(**LONG_CHAIN), device="cpu")
    per_block = []
    for b in x:
        calls.clear()
        frame = lc.compress(b)
        per_block.append((list(calls), len(frame)))
        lc.model
        assert len(calls) == len(per_block[-1][0])
    for got, size in per_block:
        assert got == [("_upload", 2 * n), ("_fetch", 16), ("_fetch", size)]


def test_model_counters_count_resident_and_uploaded_models(monkeypatch):
    """IWT, MODEL, MODEL, then a numpy model assigned (uploaded once, at
    the assignment) and one more MODEL block (secondary iterations 3):
    3 MODEL blocks counted, 2 of them resident."""
    before = (sp.model_blocks, sp.model_resident_blocks)
    x = _blocks(10, 4, 1 << 10)
    lc = sp.LongStreamCompressor(
        tx.CmpParams(**dict(LONG_CHAIN, secondary_iterations=3)),
        device="cpu")
    for b in x[:3]:
        lc.compress(b)
    host = lc.model.numpy().astype(np.int16)
    calls = _calls(monkeypatch)
    lc.model = host
    assert calls == [("_upload", host.nbytes)]
    lc.compress(x[3])
    assert (sp.model_blocks - before[0],
            sp.model_resident_blocks - before[1]) == (3, 2)


@pytest.mark.card
def test_counters_on_the_card_count_every_copy():
    """On the card the counters read the copies' sizes, and the frames
    equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    n = 1 << 16
    x = _blocks(9, 4, n)
    frames = {}
    for dev in ("cpu", "cuda"):
        tx.set_timestamp_func(airspace.Stamp(5))
        try:
            lc = sp.LongStreamCompressor(tx.CmpParams(**LONG_CHAIN),
                                         device=dev)
            before = (sp._upload.pageable_bytes, sp._fetch.pageable_bytes)
            frames[dev] = [lc.compress(b) for b in x]
            torch.cuda.synchronize()
            after = (sp._upload.pageable_bytes, sp._fetch.pageable_bytes)
        finally:
            tx.set_timestamp_func(None)
    assert frames["cuda"] == frames["cpu"]
    want = _want(frames["cuda"], n)
    assert after[0] - before[0] == want["_upload"]
    assert after[1] - before[1] == want["_fetch"]


@pytest.mark.card
def test_card_chain_copies_samples_and_frames_alone():
    """Three blocks at 2^14 on the card: the pageable bytes are three
    times the samples (2n) and the two stacked scalars, plus the frames'
    bytes; the model is an int32 tensor on the card, read without a
    copy, equal to the CPU chain's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    n = 1 << 14
    x = _blocks(11, 3, n)
    cpu = sp.LongStreamCompressor(tx.CmpParams(**LONG_CHAIN), device="cpu")
    for b in x:
        cpu.compress(b)
    lc = sp.LongStreamCompressor(tx.CmpParams(**LONG_CHAIN), device="cuda")
    before = sp._upload.pageable_bytes + sp._fetch.pageable_bytes
    frames = [lc.compress(b) for b in x]
    torch.cuda.synchronize()
    after = sp._upload.pageable_bytes + sp._fetch.pageable_bytes
    assert after - before == 3 * (2 * n + 16) + sum(len(f) for f in frames)
    model = lc.model
    assert sp._upload.pageable_bytes + sp._fetch.pageable_bytes == after
    assert model.device.type == "cuda" and model.dtype == torch.int32
    assert torch.equal(model.cpu(), cpu.model)
