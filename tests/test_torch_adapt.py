"""Port parity, adaptive tier: ops/adapt.py and encode_blocks_adaptive vs JAX.

The same numpy residuals (seeded) go through the JAX package's adaptive
selection, pinned to the CPU by conftest, and through the PyTorch port on
CPU tensors.  Both selection strategies run (``AIRS_ADAPTIVE_SELECT``
monkeypatched, as tests/test_adaptive.py does).  Tolerance: exact — every
parameter, outlier, cost, codeword and frame word is an integer.

The corpora cover what moves the fast selector's window: widening Gaussian
noise (the ladder really varies), full-range random samples (block sums
past 2**24, where the float32 mean rounds) and escape-heavy heavy-tailed
blocks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import airs_compression_tpu as jx
from airs_compression_tpu.ops import adapt as j_adapt
from airs_compression_tpu.ops import encode as j_encode
from airs_compression_tpu.ops import golomb as j_golomb
from airs_compression_tpu.utils.bits import golomb_upper_bound

import airs_compression_tpu_torch as tx
from airs_compression_tpu_torch.ops import adapt as t_adapt
from airs_compression_tpu_torch.ops import encode as t_encode
from airs_compression_tpu_torch.ops import golomb as t_golomb


def _corpora(n: int = 1024) -> np.ndarray:
    """(20, n) int32 residuals of every kind the selector must handle."""
    rng = np.random.default_rng(0)
    blocks = [rng.normal(0, 0.7 * (1 + i), n) for i in range(12)]
    blocks.append(rng.integers(-32768, 32768, n).astype(float))
    blocks.append(rng.integers(-32768, 32768, n).astype(float))
    for seed in range(3):
        r = np.random.default_rng(seed)
        blocks.append(r.normal(0, r.uniform(0.1, 5000), n))
        blocks.append(r.standard_t(2, n) * r.uniform(1, 500))
    return np.stack([np.clip(b, -32768, 32767) for b in blocks]) \
        .astype(np.int32)


RES = _corpora()


def _same(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


@pytest.fixture(params=["fast", "exact"])
def select_mode(request, monkeypatch):
    monkeypatch.setenv("AIRS_ADAPTIVE_SELECT", request.param)
    return request.param


def test_select_golomb_zero_matches(select_mode):
    tg, tb = t_adapt.select_golomb_zero(torch.from_numpy(RES))
    jg, jb = j_adapt.select_golomb_zero(jnp.asarray(RES))
    _same(tg, jg)
    _same(tb, jb)
    assert len(set(tg.tolist())) > 5  # the ladder really varies


@pytest.mark.parametrize("outlier", [30, 60, 1000])
def test_select_golomb_multi_matches(select_mode, outlier):
    tg, to, tb = t_adapt.select_golomb_multi(torch.from_numpy(RES), outlier)
    jg, jo, jb = j_adapt.select_golomb_multi(jnp.asarray(RES), outlier)
    _same(tg, jg)
    _same(to, jo)
    _same(tb, jb)


def test_small_window_and_small_ladder_match(monkeypatch):
    """A window of 1 and a ladder no bigger than the window (which takes
    the exact path) choose as in JAX."""
    monkeypatch.setenv("AIRS_ADAPTIVE_WINDOW", "1")
    for ladder in ((1, 2, 4, 8, 16, 32, 64), (1, 2)):
        _same(t_adapt.select_golomb_zero(torch.from_numpy(RES), ladder)[0],
              j_adapt.select_golomb_zero(jnp.asarray(RES), ladder)[0])
        _same(t_adapt.select_golomb_multi(torch.from_numpy(RES), 40,
                                          ladder)[0],
              j_adapt.select_golomb_multi(jnp.asarray(RES), 40, ladder)[0])


@pytest.mark.parametrize("caller", [None, 40, 1000])
def test_select_kernel_model_matches(select_mode, caller):
    """The arithmetic of the choice's CUDA kernel (csrc/adapt.cu, modelled
    in numpy by tests/test_torch_adapt_select_kernel.py, whose card tests
    hold the kernel to that model's plain version) chooses as the JAX
    package does.  Only the blocks whose mapped sums stay below 2**24:
    there JAX's float32 sum is exact, as the kernel's 64-bit one is."""
    from test_torch_adapt_select_kernel import _kernel_model

    res = RES[t_golomb.zigzag(torch.from_numpy(RES)).sum(-1).numpy()
              < 1 << 24]
    assert 0 < len(res) < len(RES)
    g, outlier, bits = _kernel_model(res, t_adapt.DEFAULT_LADDER, caller,
                                     t_adapt._select_window())
    if caller is None:
        jg, jb = j_adapt.select_golomb_zero(jnp.asarray(res))
    else:
        jg, jo, jb = j_adapt.select_golomb_multi(jnp.asarray(res), caller)
        _same(outlier, jo)
    _same(g, jg)
    _same(bits, jb)


def test_code_lengths_match():
    """Static and per-block cost models, both encoders, every ladder
    parameter (u32 wraps of the MULTI escape split included)."""
    t_m = t_golomb.zigzag(torch.from_numpy(RES))
    j_m = j_golomb.zigzag(jnp.asarray(RES))
    _same(t_m, j_m)
    for g in (1, 3, 4, 96, 4096, 0xFFFF):
        gv = torch.full((RES.shape[0],), g)
        _same(t_adapt.code_lengths_for(t_m, g),
              j_adapt.code_lengths_for(j_m, g))
        _same(t_adapt.code_lengths_dynamic(t_m, gv),
              j_adapt.code_lengths_dynamic(j_m, jnp.asarray(gv.numpy())))
        for o in (30, 1000):
            _same(t_adapt.code_lengths_for_multi(t_m, g, o),
                  j_adapt.code_lengths_for_multi(j_m, g, o))
            _same(t_adapt.code_lengths_dynamic_multi(t_m, gv, o),
                  j_adapt.code_lengths_dynamic_multi(
                      j_m, jnp.asarray(gv.numpy()), o))


def test_encode_codewords_dynamic_matches():
    """Per-block codewords at every ladder parameter, including g >= 2**10
    (group >= 32 unary wraps) and the 48-bit MULTI escapes."""
    rng = np.random.default_rng(1)
    ladder = np.asarray(j_adapt.DEFAULT_LADDER + (0xFFFF,))
    g = ladder[rng.integers(0, ladder.size, RES.shape[0])]
    g[:3] = (1, 4096, 0xFFFF)
    t_out = t_adapt.encode_codewords_dynamic(torch.from_numpy(RES),
                                             torch.from_numpy(g))
    j_out = j_adapt.encode_codewords_dynamic(jnp.asarray(RES),
                                             jnp.asarray(g.astype(np.int32)))
    for a, b in zip(t_out, j_out):
        _same(a, np.asarray(b).astype(np.int64))
    o = np.array([min(40, golomb_upper_bound(int(x), True, 16)) for x in g])
    t_out = t_adapt.encode_codewords_dynamic_multi(
        torch.from_numpy(RES), torch.from_numpy(g), torch.from_numpy(o))
    j_out = j_adapt.encode_codewords_dynamic_multi(
        jnp.asarray(RES), jnp.asarray(g.astype(np.int32)),
        jnp.asarray(o.astype(np.int32)))
    for a, b in zip(t_out, j_out):
        _same(a, np.asarray(b).astype(np.int64))
    assert int(t_out[2].max()) > 32  # 48-bit escape codes were made


# -- the adaptive engine pass -------------------------------------------------

B, N = 6, 24  # N not a power of two: the JAX packer pads K, the port does not

ADAPTIVE_CONFIGS = {
    "zero": (jx.CmpParams(primary_preprocessing=jx.Preprocessing.DIFF,
                          primary_encoder_type=jx.EncoderType.GOLOMB_ZERO,
                          primary_encoder_param=4, checksum_enabled=True),
             False, None),
    "multi_model": (jx.CmpParams(
        primary_preprocessing=jx.Preprocessing.DIFF,
        primary_encoder_type=jx.EncoderType.GOLOMB_ZERO,
        primary_encoder_param=4, secondary_iterations=15,
        secondary_preprocessing=jx.Preprocessing.MODEL,
        secondary_encoder_type=jx.EncoderType.GOLOMB_MULTI,
        secondary_encoder_param=2, secondary_encoder_outlier=40,
        model_rate=8, checksum_enabled=True), True, None),
    # tiny ladder: the full-range noise blocks must fall back
    "fallback": (jx.CmpParams(primary_preprocessing=jx.Preprocessing.DIFF,
                              primary_encoder_type=jx.EncoderType.GOLOMB_ZERO,
                              primary_encoder_param=1,
                              uncompressed_fallback_enabled=True),
                 False, (1, 2)),
}


def _port_params(params):
    return tx.params_from_reference(dataclasses.asdict(params))


@pytest.mark.parametrize("name", list(ADAPTIVE_CONFIGS))
def test_encode_blocks_adaptive_matches(name):
    """words, sizes, fell_back and g of one adaptive pass."""
    params, secondary, ladder = ADAPTIVE_CONFIGS[name]
    ladder = ladder or j_adapt.DEFAULT_LADDER
    rng = np.random.default_rng(2)
    sig = np.stack([1100 + rng.normal(0, 0.7 * (1 + i % 12), N)
                    for i in range(B)])
    sig[1] = rng.integers(0, 1 << 16, N)
    sig[4] = 1100 + rng.standard_t(2, N) * 300
    x = (sig.astype(np.int64) & 0xFFFF).astype(np.uint16) \
        .view(np.int16).astype(np.int32)
    model = np.roll(x, 1, axis=1)
    seq = np.full(B, 3 if secondary else 0, np.int32)
    ids = rng.integers(0, 1 << 48, B)
    id_hi, id_lo = (ids >> 24) & 0xFFFFFF, ids & 0xFFFFFF
    csum = rng.integers(0, 1 << 32, B, dtype=np.int64)
    jcfg = j_encode.make_pass_config(params, secondary, True)
    tcfg = t_encode.make_pass_config(_port_params(params), secondary)
    assert tcfg.raw_outlier == jcfg.raw_outlier
    jfb = tfb = None
    if params.uncompressed_fallback_enabled:
        fbp = dataclasses.replace(
            params, primary_preprocessing=jx.Preprocessing.NONE,
            primary_encoder_type=jx.EncoderType.UNCOMPRESSED)
        jfb = j_encode.make_pass_config(fbp, False, True)
        tfb = t_encode.make_pass_config(_port_params(fbp), False)
    n_words = t_encode.adaptive_worst_case_words(tcfg, N, ladder)
    assert n_words == j_encode.adaptive_worst_case_words(jcfg, N, ladder)
    jw, js, jf, jg, jok = j_encode.encode_blocks_adaptive(
        jcfg, jfb, jnp.asarray(x), jnp.asarray(model), jnp.asarray(seq),
        jnp.asarray(id_hi.astype(np.uint32)),
        jnp.asarray(id_lo.astype(np.uint32)),
        jnp.asarray(csum.astype(np.uint32)), n_words, tuple(ladder))
    tw, ts, tf, tg = t_encode.encode_blocks_adaptive(
        tcfg, tfb, torch.from_numpy(x), torch.from_numpy(model),
        torch.from_numpy(seq), torch.from_numpy(id_hi),
        torch.from_numpy(id_lo), torch.from_numpy(csum), n_words,
        tuple(ladder))
    assert bool(np.asarray(jok).all())
    _same(tw, np.asarray(jw).astype(np.int64))
    _same(ts, js)
    _same(tf, jf)
    _same(tg, jg)
    if name == "fallback":
        assert tf.numpy()[1] and not tf.numpy()[0]
    else:
        assert len(set(tg.tolist())) > 2


def test_adaptive_needs_golomb():
    cfg = t_encode.PassConfig(1, 0, 0, 0, False, 8)
    x = torch.zeros((1, 4), dtype=torch.int32)
    z = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="Golomb"):
        t_encode.encode_blocks_adaptive(cfg, None, x, x, z, z, z, z, 16,
                                        t_adapt.DEFAULT_LADDER)
