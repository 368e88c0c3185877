"""Checkpoints cross-load between the port and the JAX package.

``engine/checkpoint.py`` of both packages writes the same ``.npz`` keys
under the same magic, so a chain stopped in one package continues in the
other: a host context's (identifier, sequence number, model) and a batch
compressor's or decompressor's (model, sequence numbers, identifiers).
After a save in one package and a load in the other, both continue with
the same frame bytes (or decoded samples) as a chain that never stopped.
``chip_smoke.py`` phase K's resume sequence also runs here, at
``device="cpu"``.
"""

import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import airs_compression_tpu as act
import airs_compression_tpu_torch as tx
from airs_compression_tpu.engine import checkpoint as j_ckpt
from airs_compression_tpu.models.stream import BatchCompressor as JBatch
from airs_compression_tpu.models.stream import BatchDecompressor as JDec
from airs_compression_tpu_torch.engine import checkpoint as t_ckpt

P, E = act.Preprocessing, act.EncoderType

CHAIN = act.CmpParams(primary_preprocessing=P.DIFF,
                      primary_encoder_type=E.GOLOMB_ZERO,
                      primary_encoder_param=4, secondary_iterations=5,
                      secondary_preprocessing=P.MODEL,
                      secondary_encoder_type=E.GOLOMB_MULTI,
                      secondary_encoder_param=2,
                      secondary_encoder_outlier=40, model_rate=8,
                      checksum_enabled=True)
B, N = 2, 256


class _Stamp:
    def __init__(self, start=0):
        self.counter = start

    def __call__(self):
        c = self.counter
        self.counter += 1
        return (c >> 16) & 0xFFFFFFFF, c & 0xFFFF


@pytest.fixture()
def stamps():
    act.set_timestamp_func(_Stamp())
    tx.set_timestamp_func(_Stamp(1000))
    yield
    act.set_timestamp_func(None)
    tx.set_timestamp_func(None)


def _tparams(params):
    return tx.params_from_reference(dataclasses.asdict(params))


def _frames(seed, shape):
    rng = np.random.default_rng(seed)
    base = 1100 + rng.normal(0, 6, shape[-1])
    return [((base + rng.normal(0, 2, shape)).astype(np.int64) & 0xFFFF)
            .astype(np.uint16) for _ in range(4)]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_context_cross_load(tmp_path, stamps, direction):
    """A host context chain saved after two frames continues in the other
    package with the bytes of the unbroken chain."""
    frames = _frames(1, (N,))
    ref = act.CmpContext(CHAIN)
    want = [ref.compress_u16(f) for f in frames]
    path = str(tmp_path / "ctx.npz")
    # the source context draws the identifiers the reference drew
    if direction == "jax_to_torch":
        act.set_timestamp_func(_Stamp())
        src = act.CmpContext(CHAIN)
        got = [src.compress_u16(f) for f in frames[:2]]
        j_ckpt.save_context(src, path)
        dst = tx.CmpContext(_tparams(CHAIN))
        t_ckpt.load_context(dst, path)
    else:
        tx.set_timestamp_func(_Stamp())
        src = tx.CmpContext(_tparams(CHAIN))
        got = [src.compress_u16(f) for f in frames[:2]]
        t_ckpt.save_context(src, path)
        dst = act.CmpContext(CHAIN)
        j_ckpt.load_context(dst, path)
    got += [dst.compress_u16(f) for f in frames[2:]]
    assert got == want
    assert dst.sequence_number == 4


@pytest.fixture(scope="module")
def batch_chain():
    """The JAX batch chain's four frames of B blocks, and the model,
    sequence numbers and identifiers after its second frame."""
    frames = _frames(2, (B, N))
    act.set_timestamp_func(_Stamp())
    try:
        bc = JBatch(CHAIN, B, N)
        out = []
        for i, f in enumerate(frames):
            out.append(bc.compress_frames(f))
            if i == 1:
                state = (np.asarray(bc.model).copy(), bc.seq.copy(),
                         bc.identifiers.copy())
    finally:
        act.set_timestamp_func(None)
    return frames, out, state


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_batch_state_cross_load(tmp_path, batch_chain, direction):
    """A batch chain checkpointed after two frames continues in the other
    package with the frames of the unbroken JAX chain."""
    frames, want, (model, seq, ids) = batch_chain
    path = str(tmp_path / "batch.npz")
    if direction == "jax_to_torch":
        src = JBatch(CHAIN, B, N)
        src.model, src.seq, src.identifiers = model, seq, ids
        j_ckpt.save_batch_state(src, path)
        dst = tx.BatchCompressor(_tparams(CHAIN), B, N, device="cpu")
        t_ckpt.load_batch_state(dst, path)
        assert dst.model.dtype == torch.int32
        assert dst.model.device.type == "cpu"
    else:
        src = tx.BatchCompressor(_tparams(CHAIN), B, N, device="cpu")
        src.model = torch.from_numpy(model.astype(np.int32))
        src.seq, src.identifiers = seq.copy(), ids.copy()
        t_ckpt.save_batch_state(src, path)
        dst = JBatch(CHAIN, B, N)
        j_ckpt.load_batch_state(dst, path)
    got = [dst.compress_frames(f) for f in frames[2:]]
    assert got == want[2:]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_decompressor_state_cross_load(tmp_path, batch_chain, direction):
    """A decoder's model checkpointed after two frames decodes the rest of
    the chain in the other package."""
    frames, comp, _ = batch_chain
    ref = tx.BatchDecompressor(_tparams(CHAIN), B, N, device="cpu")
    for c in comp[:2]:
        ref.decompress_frames(c)
    path = str(tmp_path / "dec.npz")
    if direction == "jax_to_torch":
        src = JDec(CHAIN, B, N)
        src.model = np.asarray(ref.model)
        j_ckpt.save_batch_state(src, path)
        dst = tx.BatchDecompressor(_tparams(CHAIN), B, N, device="cpu")
        t_ckpt.load_batch_state(dst, path)
    else:
        t_ckpt.save_batch_state(ref, path)
        dst = JDec(CHAIN, B, N)
        j_ckpt.load_batch_state(dst, path)
    for f, c in zip(frames[2:], comp[2:]):
        np.testing.assert_array_equal(np.asarray(dst.decompress_frames(c)), f)


def test_wrong_checkpoints_refused(tmp_path):
    ctx_path = str(tmp_path / "ctx.npz")
    t_ckpt.save_context(tx.CmpContext(_tparams(CHAIN)), ctx_path)
    bc = tx.BatchCompressor(_tparams(CHAIN), B, N, device="cpu")
    with pytest.raises(ValueError, match="batch checkpoint"):
        t_ckpt.load_batch_state(bc, ctx_path)
    batch_path = str(tmp_path / "batch.npz")
    t_ckpt.save_batch_state(bc, batch_path)
    with pytest.raises(ValueError, match="context checkpoint"):
        t_ckpt.load_context(tx.CmpContext(_tparams(CHAIN)), batch_path)
    other = tx.BatchCompressor(_tparams(CHAIN), B + 1, N, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        t_ckpt.load_batch_state(other, batch_path)


def test_phase_k_resume_sequence_on_cpu(tmp_path):
    """``chip_smoke.py`` phase K's checkpoint resume at a small B x N: the
    flagship chain saved after frame 2 and loaded into a fresh
    ``BatchCompressor`` and ``BatchDecompressor`` gives frames 3-5 byte
    for byte as the unbroken chain and decodes them exactly; a
    ``CmpContext`` chain resumes the same way (the sequence raises on any
    difference)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke",
        pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rep = smoke.checkpoint_resume(tmp_path, "cpu", b=3, n=512, ctx_n=1000)
    assert (rep["frames"], rep["resumed_at"]) == (6, 3)
    assert not any(rep["launches"].values())  # plain versions on the CPU
    assert {p.name for p in tmp_path.iterdir()} == {"bc.npz", "bd.npz",
                                                    "ctx.npz"}
