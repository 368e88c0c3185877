"""Batch block encoder: preprocess -> codewords + bit pack -> frame.

Port of ``airs_compression_tpu/ops/encode.py``.  One call encodes a whole
batch of blocks (B, N) into complete AIRSPACE frames (header + payload
[+ checksum]) as big-endian 32-bit word rows, on the tensors' device:

* the per-sample loop of the reference engine (lib/compress/cmp.c:213-338)
  becomes the batched preprocess (ops/preprocess.py) and the fused packer
  (ops/pack.py, kernel K1 on the card); the adaptive tier
  (:func:`encode_blocks_adaptive`) picks each block's Golomb parameter
  (ops/adapt.py) and packs its precomputed codes with kernel K2;
* the header is known before packing (bit lengths come out of the packer),
  so it is assembled in closed form and the payload shifted in behind it —
  no rewind to patch ``compressed_size`` as in cmp.c:321-334;
* the uncompressed-fallback probe (cmp.c:342-393) reduces to a size
  comparison, and the fallback frames are encoded only when some block
  needs them.

u32 words are int64 tensors masked to 32 bits (ops/u32.py).  The JAX
package's entropy clamp (``cap_bits``, ``ok``, ``narrow``) exists only for
the TPU packer and is not ported: frames are sized by
:func:`worst_case_words`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..format.header import CMP_VERSION_NUMBER
from ..format.params import CmpParams, EncoderType, Preprocessing
from ..utils.bits import derive_encoder_outlier
from . import pack, preprocess
from .u32 import MASK, from_bits

__all__ = ["PassConfig", "make_pass_config", "encode_blocks_device",
           "encode_blocks_adaptive", "worst_case_words",
           "adaptive_worst_bits", "adaptive_worst_case_words",
           "model_update_step"]

_HDR_BASIC_BITS = 128   # 16-byte header
_HDR_EXT_BITS = 176     # 22-byte header with extension


@dataclasses.dataclass(frozen=True)
class PassConfig:
    """Configuration of one encode pass."""

    prep: int
    enc_type: int
    g_par: int
    outlier: int
    checksum: bool
    model_rate: int
    # the caller's outlier before the per-parameter upper-bound clamp (the
    # adaptive tier re-clamps it per candidate parameter)
    raw_outlier: "int | None" = None

    def __post_init__(self):
        if self.raw_outlier is None:
            object.__setattr__(self, "raw_outlier", self.outlier)

    @property
    def has_ext(self) -> bool:
        return self.prep != 0 or self.enc_type != 0

    @property
    def hdr_bits(self) -> int:
        return _HDR_EXT_BITS if self.has_ext else _HDR_BASIC_BITS

    @property
    def worst_bits_per_sample(self) -> int:
        return pack.worst_bits(self.enc_type, self.g_par)


def make_pass_config(params: CmpParams, secondary: bool) -> PassConfig:
    """Derive the pass config (mirrors cmp.c:228-248 selection)."""
    prep, enc_t, enc_p, out_p = params.pass_params(secondary)
    outlier = derive_encoder_outlier(int(enc_t), enc_p, out_p)
    return PassConfig(int(prep), int(enc_t), enc_p, outlier,
                      bool(params.checksum_enabled), params.model_rate,
                      raw_outlier=out_p)


def worst_case_words(cfg: PassConfig, n: int) -> int:
    """Output capacity (32-bit words) for n samples under cfg."""
    bits = cfg.hdr_bits + cfg.worst_bits_per_sample * n + 7 + 32
    return (bits + 31) // 32 + 1


def _header_words(cfg: PassConfig, compressed_size, original_size: int,
                  id_hi, id_lo, seq, enc_param_dyn=None, outlier_dyn=None):
    """Per-block header directly as big-endian u32 words.

    The header layout is fixed (cmp_header.h:26-51), so each of the 4 (or
    5.5 with the extension) words is a closed-form expression.  Returns a
    list of (B,) int64 u32 tensors.  The adaptive encoder passes per-block
    ``enc_param_dyn`` / ``outlier_dyn`` (B,) tensors.
    """
    csize = compressed_size.to(torch.int64)
    version = (1 << 15) | CMP_VERSION_NUMBER
    method = (((cfg.prep & 0xF) << 4) | ((1 if cfg.checksum else 0) << 3)
              | (cfg.enc_type & 0x7))
    w0 = ((version << 16) | (csize >> 8)) & MASK
    w1 = (((csize & 0xFF) << 24) | original_size) & MASK
    w2 = ((id_hi << 8) | (id_lo >> 16)) & MASK
    w3 = ((id_lo & 0xFFFF) << 16) | ((seq.to(torch.int64) & 0xFF) << 8) \
        | method
    words = [w0, w1, w2, w3]
    if cfg.has_ext:
        model_rate = cfg.model_rate if cfg.prep == int(Preprocessing.MODEL) \
            else 0
        if not cfg.enc_type:
            enc_param, enc_outlier = 0, 0
        else:
            enc_param = (cfg.g_par if enc_param_dyn is None
                         else enc_param_dyn.to(torch.int64))
            enc_outlier = (cfg.outlier if outlier_dyn is None
                           else outlier_dyn.to(torch.int64))
        w4 = ((model_rate << 24) | (enc_param << 8) | (enc_outlier >> 16)) \
            & MASK
        w5 = ((enc_outlier & 0xFFFF) << 16) & MASK
        zeros = torch.zeros_like(w0)
        words += [zeros + w4, zeros + w5]
    return words


def _assemble_frames(cfg: PassConfig, payload, payload_bits, N: int, seq,
                     id_hi, id_lo, checksum, n_words: int,
                     enc_param_dyn=None, outlier_dyn=None):
    """Closed-form frame assembly from a packed payload word stream.

    ``payload`` (B, C) int64 u32 words, ``payload_bits`` (B,) ints.
    Returns (words (B, n_words) int64 u32, size_bytes (B,) int32).
    """
    B = payload.shape[0]
    bits = cfg.hdr_bits + payload_bits.to(torch.int64)
    if cfg.checksum:
        pad = (-bits) & 7
        total_bits = bits + pad + 32
    else:
        total_bits = bits
    size_bytes = ((total_bits + 7) >> 3).to(torch.int32)

    hdr = _header_words(cfg, size_bytes, 2 * N, id_hi, id_lo, seq,
                        enc_param_dyn, outlier_dyn)
    hdr_full_words = cfg.hdr_bits // 32      # 4 (basic) or 5 (ext)
    hdr_rem = cfg.hdr_bits % 32              # 0 or 16
    if hdr_rem == 0:
        # header is word-aligned: simple concatenation
        body = [w[:, None] for w in hdr] + [payload]
    else:
        # payload shifted right by hdr_rem bits, first part ORed into the
        # header's half-filled last word
        p_prev = torch.cat([torch.zeros_like(payload[:, :1]),
                            payload[:, :-1]], dim=1)
        p_sh = (payload >> hdr_rem) | ((p_prev << (32 - hdr_rem)) & MASK)
        tail = (payload[:, -1:] << (32 - hdr_rem)) & MASK
        body = ([w[:, None] for w in hdr[:hdr_full_words]]
                + [(hdr[hdr_full_words] | p_sh[:, 0])[:, None],
                   p_sh[:, 1:], tail])
    out = torch.cat(body, dim=1)
    if out.shape[1] < n_words:
        out = torch.cat([out, out.new_zeros((B, n_words - out.shape[1]))],
                        dim=1)
    else:
        out = out[:, :n_words]

    if cfg.checksum:
        # place the 32-bit checksum at the byte-aligned end (one-hot mask)
        cs_bit = bits + pad                      # absolute bit offset
        aw = (cs_bit >> 5)[:, None]              # (B, 1)
        off = (cs_bit & 31)[:, None]
        iota = torch.arange(n_words, device=out.device)[None, :]
        cs = checksum.to(torch.int64)[:, None]
        c0 = cs >> off
        c1 = torch.where(off == 0, 0, (cs << (32 - off).clamp(max=31)) & MASK)
        out = (out | torch.where(iota == aw, c0, 0)
               | torch.where(iota == aw + 1, c1, 0))
    return out, size_bytes


def _finish_frames(cfg: PassConfig, hi, lo, lens, N: int, seq, id_hi, id_lo,
                   checksum, n_words: int, max_bits: int,
                   enc_param_dyn=None, outlier_dyn=None):
    """Pack precomputed codes (kernel K2 on the card) and assemble the
    frames, with per-block header parameters where given.  Returns (words
    (B, n_words) int64 u32, size_bytes (B,) int32)."""
    payload, payload_bits = pack.pack_codes(hi, lo, lens, max_bits)
    return _assemble_frames(cfg, from_bits(payload), payload_bits, N, seq,
                            id_hi, id_lo, checksum, n_words, enc_param_dyn,
                            outlier_dyn)


def _encode_one_pass(cfg: PassConfig, x, model, seq, id_hi, id_lo, checksum,
                     n_words: int):
    """Encode (B, N) int32 samples under one pass config.

    Returns (words (B, n_words) int64 u32, size_bytes (B,) int32).
    """
    B, N = x.shape
    residuals = preprocess.preprocess_forward(
        cfg.prep, x, model if cfg.prep == int(Preprocessing.MODEL) else None)
    if cfg.enc_type == int(EncoderType.UNCOMPRESSED):
        # fixed 16-bit codes need no packer: word j = (code 2j << 16) | code
        # 2j+1, exactly the packed layout the packer would produce
        r = residuals.to(torch.int64) & 0xFFFF
        if N % 2:
            r = torch.cat([r, r.new_zeros((B, 1))], dim=1)
        payload = (r[:, 0::2] << 16) | r[:, 1::2]
        payload_bits = torch.full((B,), 16 * N, dtype=torch.int64,
                                  device=x.device)
    else:
        payload, payload_bits = pack.pack_residuals(
            residuals, cfg.enc_type, cfg.g_par, cfg.outlier)
        payload = from_bits(payload)
    return _assemble_frames(cfg, payload, payload_bits, N, seq, id_hi, id_lo,
                            checksum, n_words)


def encode_blocks_device(cfg: PassConfig, fallback_cfg, x: torch.Tensor,
                         model: torch.Tensor, seq: torch.Tensor,
                         id_hi: torch.Tensor, id_lo: torch.Tensor,
                         checksum: torch.Tensor, n_words: int):
    """Full engine pass over a batch of blocks.

    Args:
      cfg: PassConfig of the selected pass.
      fallback_cfg: PassConfig for the uncompressed fallback, or None when
        the fallback is disabled.
      x: (B, N) int32 sign-extended i16 samples.
      model: (B, N) int32 model state (ignored unless cfg uses MODEL).
      seq: (B,) int32 per-block sequence numbers (written to headers).
      id_hi, id_lo: (B,) int64 identifier halves (bits 47..24 / 23..0).
      checksum: (B,) int64 u32 XXH32 values (zeros when disabled).
      n_words: output word capacity.

    Returns:
      words (B, n_words) int64 u32 big-endian frame words, sizes (B,)
      int32, fell_back (B,) bool.
    """
    words, sizes = _encode_one_pass(cfg, x, model, seq, id_hi, id_lo,
                                    checksum, n_words)
    return _with_fallback(cfg, fallback_cfg, words, sizes, x, model, seq,
                          id_hi, id_lo, checksum, n_words)


def _with_fallback(cfg: PassConfig, fallback_cfg, words, sizes, x, model,
                   seq, id_hi, id_lo, checksum, n_words: int):
    """Swap in the uncompressed-fallback frame where a block's frame is
    larger than it (reference cmp.c:342-393).  Returns (words, sizes,
    fell_back (B,) bool)."""
    B, N = x.shape
    if fallback_cfg is None:
        return words, sizes, torch.zeros((B,), dtype=torch.bool,
                                         device=x.device)
    # Probe criterion (cmp.c:362-372): the clamped-capacity run fails
    # exactly when the frame exceeds the uncompressed frame size.
    unc_size = 16 + 2 * N + (4 if cfg.checksum else 0)
    fell_back = sizes > unc_size
    if bool(fell_back.any()):
        # fallback frames run at sequence number 0 (the chain was reset)
        fb_words, fb_sizes = _encode_one_pass(
            fallback_cfg, x, model, torch.zeros_like(seq), id_hi, id_lo,
            checksum, n_words)
        words = torch.where(fell_back[:, None], fb_words, words)
        sizes = torch.where(fell_back, fb_sizes, sizes)
    return words, sizes, fell_back


def encode_blocks_adaptive(cfg: PassConfig, fallback_cfg, x: torch.Tensor,
                           model: torch.Tensor, seq: torch.Tensor,
                           id_hi: torch.Tensor, id_lo: torch.Tensor,
                           checksum: torch.Tensor, n_words: int, ladder):
    """Adaptive-rate engine pass: per-block Golomb parameter selection.

    Like :func:`encode_blocks_device`, but the GOLOMB_ZERO or GOLOMB_MULTI
    parameter is chosen per block from the post-preprocessing residuals
    (ops/adapt.py, over the candidate ``ladder``); the chosen parameter and
    its derived outlier travel in each block's header.  The codes are
    packed by kernel K2.  The uncompressed fallback composes as in the
    fixed-rate engine.

    Returns words (B, n_words) int64 u32, sizes (B,) int32, fell_back (B,)
    bool, g_selected (B,) int64.
    """
    from . import adapt

    if cfg.enc_type not in (int(EncoderType.GOLOMB_ZERO),
                            int(EncoderType.GOLOMB_MULTI)):
        raise ValueError("adaptive selection requires a Golomb encoder")
    B, N = x.shape
    residuals = preprocess.preprocess_forward(
        cfg.prep, x, model if cfg.prep == int(Preprocessing.MODEL) else None)
    multi = cfg.enc_type == int(EncoderType.GOLOMB_MULTI)
    # the outlier goes into each header
    g_sel, outlier_dyn, _ = adapt.select_params(
        residuals, ladder, cfg.raw_outlier if multi else None)
    if multi:
        hi, lo, lens = adapt.encode_codewords_dynamic_multi(
            residuals, g_sel, outlier_dyn)
    else:
        _, lo, lens = adapt.encode_codewords_dynamic(residuals, g_sel)
        hi = None  # ZERO codes are at most 32 bits
    words, sizes = _finish_frames(
        cfg, hi, lo, lens, N, seq, id_hi, id_lo, checksum, n_words,
        adaptive_worst_bits(cfg, ladder), g_sel, outlier_dyn)
    words, sizes, fell_back = _with_fallback(
        cfg, fallback_cfg, words, sizes, x, model, seq, id_hi, id_lo,
        checksum, n_words)
    return words, sizes, fell_back, g_sel


def adaptive_worst_bits(cfg: PassConfig, ladder) -> int:
    """Per-sample worst-case bits across the candidate ladder."""
    if cfg.enc_type == int(EncoderType.GOLOMB_MULTI):
        return 48  # 32-bit escape codeword + 16 raw bits
    return int(max(ladder)).bit_length() - 1 + 17


def adaptive_worst_case_words(cfg: PassConfig, n: int, ladder) -> int:
    """Output capacity (32-bit words) for n samples under the adaptive
    tier."""
    bits = cfg.hdr_bits + adaptive_worst_bits(cfg, ladder) * n + 7 + 32
    return (bits + 31) // 32 + 1


def model_update_step(x: torch.Tensor, model: torch.Tensor, seq: torch.Tensor,
                      fell_back: torch.Tensor, model_rate: int,
                      unsigned_model: bool) -> torch.Tensor:
    """Post-pass model transition (reference cmp.c:296-312 + fallback reseed).

    seq==0 (primary pass) seeds the model with the frame; later passes EMA-
    update it; a fallback resets the chain and reseeds.  Per-block.
    """
    updated = preprocess.model_update(x, model, model_rate, unsigned_model)
    seeded = torch.where((seq == 0)[:, None], x, updated)
    return torch.where(fell_back[:, None], x, seeded)
