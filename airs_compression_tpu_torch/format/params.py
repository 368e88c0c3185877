"""Compression parameters: typed config object + validation.

Mirrors the reference's ``struct cmp_params`` (lib/cmp.h:94-116) and the
validation performed by ``cmp_initialise`` (lib/compress/cmp.c:152-209),
``cmp_encoder_init`` (encoder.c:185-224), ``cmp_cal_work_buf_size``
(cmp.c:77-103) and ``cmp_compress_bound`` (cmp.c:59-74).

A copy of ``airs_compression_tpu/format/params.py``, plus
:func:`params_from_reference`, which carries a JAX-side parameter set over
as plain data.
"""

from __future__ import annotations

import dataclasses
import enum

from .errors import CmpError, CmpErrorCode
from .header import (
    CMP_CHECKSUM_SIZE,
    CMP_HDR_MAX_COMPRESSED_SIZE,
    CMP_HDR_MAX_ORIGINAL_SIZE,
    CMP_HDR_MAX_SIZE,
    CMP_HDR_SIZE,
)
from ..utils.bits import (
    derive_encoder_outlier,
    div_round_up,
    max_compressed_payload_size,
)

__all__ = [
    "Preprocessing",
    "EncoderType",
    "CmpParams",
    "CMP_MAX_MODEL_RATE",
    "cal_work_buf_size",
    "compress_bound",
    "uncompressed_bound",
    "div_round_up_bytes_to_samples",
    "params_from_reference",
]

CMP_MAX_MODEL_RATE = 16  # reference cmp.c:107
_MAX_SECONDARY_ITERATIONS = (1 << 8) - 1  # 8-bit sequence-number field


class Preprocessing(enum.IntEnum):
    """Preprocessing methods (reference lib/cmp.h:64-71)."""

    NONE = 0
    DIFF = 1
    IWT = 2
    MODEL = 3  # only allowed as a secondary preprocessing step


class EncoderType(enum.IntEnum):
    """Entropy encoders (reference lib/cmp.h:78-82)."""

    UNCOMPRESSED = 0
    GOLOMB_ZERO = 1
    GOLOMB_MULTI = 2


@dataclasses.dataclass(frozen=True)
class CmpParams:
    """Compression parameters (field-for-field with reference cmp_params)."""

    primary_preprocessing: Preprocessing = Preprocessing.NONE
    primary_encoder_type: EncoderType = EncoderType.UNCOMPRESSED
    primary_encoder_param: int = 0
    primary_encoder_outlier: int = 0

    secondary_iterations: int = 0
    secondary_preprocessing: Preprocessing = Preprocessing.NONE
    secondary_encoder_type: EncoderType = EncoderType.UNCOMPRESSED
    secondary_encoder_param: int = 0
    secondary_encoder_outlier: int = 0
    model_rate: int = 0

    checksum_enabled: bool = False
    uncompressed_fallback_enabled: bool = False

    # -- validation ------------------------------------------------------
    def model_is_needed(self) -> bool:
        """Reference model_is_needed (cmp.c:145-149)."""
        return (
            self.secondary_preprocessing == Preprocessing.MODEL
            and self.secondary_iterations != 0
        )

    def validate(self) -> None:
        """Raise CmpError exactly where cmp_initialise would fail."""
        if self.secondary_iterations > _MAX_SECONDARY_ITERATIONS:
            raise CmpError(
                CmpErrorCode.PARAMS_INVALID,
                "secondary_iterations exceeds the 8-bit sequence number field",
            )
        # Encoder parameter checks (raises CmpError(PARAMS_INVALID) if bad)
        derive_encoder_outlier(
            int(self.primary_encoder_type),
            self.primary_encoder_param,
            self.primary_encoder_outlier,
        )
        if self.secondary_iterations:
            derive_encoder_outlier(
                int(self.secondary_encoder_type),
                self.secondary_encoder_param,
                self.secondary_encoder_outlier,
            )
        if self.model_is_needed() and self.model_rate > CMP_MAX_MODEL_RATE:
            raise CmpError(CmpErrorCode.PARAMS_INVALID, "model_rate > 16")
        # Work-buffer math also validates preprocessing selections
        cal_work_buf_size(self, 2)

    def pass_params(self, secondary: bool) -> "tuple[Preprocessing, EncoderType, int, int]":
        """(preprocessing, encoder_type, encoder_param, outlier) of a pass."""
        if secondary:
            return (
                self.secondary_preprocessing,
                self.secondary_encoder_type,
                self.secondary_encoder_param,
                self.secondary_encoder_outlier,
            )
        return (
            self.primary_preprocessing,
            self.primary_encoder_type,
            self.primary_encoder_param,
            self.primary_encoder_outlier,
        )


_ENUM_FIELDS = {
    "primary_preprocessing": Preprocessing,
    "secondary_preprocessing": Preprocessing,
    "primary_encoder_type": EncoderType,
    "secondary_encoder_type": EncoderType,
}


def params_from_reference(d: dict) -> CmpParams:
    """:class:`CmpParams` from ``dataclasses.asdict`` of the JAX package's
    ``CmpParams`` (or any dict with the same field names).

    Enum members of the other package become this package's enums by
    value, booleans stay booleans and the rest become ints, so a chain can
    be stopped in one package and continued in the other.
    """
    fields = {f.name: f for f in dataclasses.fields(CmpParams)}
    unknown = set(d) - set(fields)
    if unknown:
        raise CmpError(CmpErrorCode.PARAMS_INVALID,
                       f"unknown parameter fields {sorted(unknown)}")
    out = {}
    for name, value in d.items():
        if name in _ENUM_FIELDS:
            out[name] = _ENUM_FIELDS[name](int(value))
        elif isinstance(fields[name].default, bool):
            out[name] = bool(value)
        else:
            out[name] = int(value)
    return CmpParams(**out)


def _preprocess_work_buf_size(method: Preprocessing, src_size: int) -> int:
    """Per-method work buffer size (reference preprocess.c:233-367)."""
    if method in (Preprocessing.NONE, Preprocessing.DIFF):
        return 0
    if method in (Preprocessing.IWT, Preprocessing.MODEL):
        return (src_size + 1) & ~1  # ROUND_UP_TO_NEXT_2
    raise CmpError(CmpErrorCode.PARAMS_INVALID, f"unknown preprocessing {method}")


def cal_work_buf_size(params: CmpParams, src_size: int) -> int:
    """Reference cmp_cal_work_buf_size (cmp.c:77-103)."""
    if params is None:
        raise CmpError(CmpErrorCode.GENERIC)
    if params.primary_preprocessing == Preprocessing.MODEL:
        raise CmpError(
            CmpErrorCode.PARAMS_INVALID,
            "MODEL preprocessing is only allowed as a secondary step",
        )
    primary = _preprocess_work_buf_size(params.primary_preprocessing, src_size)
    secondary = 0
    if params.secondary_iterations:
        secondary = _preprocess_work_buf_size(params.secondary_preprocessing, src_size)
    return max(primary, secondary)


def compress_bound(packed_size: int) -> int:
    """Worst-case compressed size (reference cmp_compress_bound, cmp.c:59-74)."""
    if packed_size > CMP_HDR_MAX_ORIGINAL_SIZE:
        raise CmpError(CmpErrorCode.HDR_ORIGINAL_TOO_LARGE)
    bound = CMP_HDR_MAX_SIZE + CMP_CHECKSUM_SIZE + max_compressed_payload_size(packed_size)
    if bound > CMP_HDR_MAX_COMPRESSED_SIZE:
        raise CmpError(CmpErrorCode.HDR_CMP_SIZE_TOO_LARGE)
    return bound


def uncompressed_bound(packed_size: int) -> int:
    """Reference CMP_UNCOMPRESSED_BOUND macro (lib/cmp.h:212-215)."""
    limit = CMP_HDR_MAX_COMPRESSED_SIZE - CMP_HDR_SIZE - CMP_CHECKSUM_SIZE
    if packed_size <= limit:
        return CMP_HDR_SIZE + packed_size + CMP_CHECKSUM_SIZE
    return (1 << 64) - 1  # SIZE_MAX sentinel


def div_round_up_bytes_to_samples(src_size: int, stride: int) -> int:
    return div_round_up(src_size, stride)
