"""Error taxonomy of the AIRSPACE format, as native Python exceptions.

The reference C library encodes every fallible result as a ``uint32_t`` that
is either a payload or a negated ``enum cmp_error`` member (reference:
lib/cmp_errors.h:28-60, lib/common/err_private.h:24-47).  This module mirrors
the exact code taxonomy so that CLI output, tests, and any binary-level
tooling agree with the reference, while exposing it the Python way: an
:class:`IntEnum` of codes plus a :class:`CmpError` exception carrying one.

A copy of ``airs_compression_tpu/format/errors.py`` (the port imports nothing
of the JAX package).
"""

from __future__ import annotations

import enum

__all__ = [
    "CmpErrorCode",
    "CmpError",
    "error_to_u32",
    "u32_is_error",
    "u32_to_error_code",
    "error_message",
]

_U32 = 0xFFFFFFFF


class CmpErrorCode(enum.IntEnum):
    """Error codes; numeric values match reference lib/cmp_errors.h:28-60."""

    NO_ERROR = 0

    GENERIC = 1
    PARAMS_INVALID = 10

    DST_TOO_SMALL = 30
    DST_NULL = 31
    DST_UNALIGNED = 32

    SRC_SIZE_WRONG = 40
    SRC_NULL = 41
    SRC_SIZE_MISMATCH = 42

    WORK_BUF_TOO_SMALL = 50
    WORK_BUF_NULL = 51
    WORK_BUF_UNALIGNED = 52

    HDR_CMP_SIZE_TOO_LARGE = 60
    HDR_ORIGINAL_TOO_LARGE = 61

    CONTEXT_INVALID = 70

    INT_HDR = 100
    INT_ENCODER = 101
    INT_BITSTREAM = 102

    MAX_CODE = 128


_MESSAGES = {
    CmpErrorCode.NO_ERROR: "No error detected",
    CmpErrorCode.GENERIC: "Error (generic)",
    CmpErrorCode.PARAMS_INVALID: "Invalid compression parameters",
    CmpErrorCode.DST_TOO_SMALL: "Destination buffer is too small to hold the whole compressed data",
    CmpErrorCode.DST_NULL: "Destination buffer is NULL",
    CmpErrorCode.DST_UNALIGNED: "Destination buffer is not correctly aligned",
    CmpErrorCode.SRC_SIZE_WRONG: "Source size is not a multiple of the sample size",
    CmpErrorCode.SRC_NULL: "Source buffer is NULL",
    CmpErrorCode.SRC_SIZE_MISMATCH: "Source size changed while using model preprocessing",
    CmpErrorCode.WORK_BUF_TOO_SMALL: "Work buffer is too small",
    CmpErrorCode.WORK_BUF_NULL: "Work buffer is NULL but required",
    CmpErrorCode.WORK_BUF_UNALIGNED: "Work buffer is not correctly aligned",
    CmpErrorCode.HDR_CMP_SIZE_TOO_LARGE: "Compressed size exceeds the header field limit",
    CmpErrorCode.HDR_ORIGINAL_TOO_LARGE: "Original size exceeds the header field limit",
    CmpErrorCode.CONTEXT_INVALID: "Compression context is invalid",
    CmpErrorCode.INT_HDR: "Internal header processing error",
    CmpErrorCode.INT_ENCODER: "Internal encoder error",
    CmpErrorCode.INT_BITSTREAM: "Internal bitstream error",
}


def error_to_u32(code: CmpErrorCode) -> int:
    """Encode an error code as the reference's negated-uint32 convention."""
    return (-int(code)) & _U32


def u32_is_error(value: int) -> bool:
    """Reference semantics: ``code > (uint32_t)-CMP_ERR_MAX_CODE``."""
    return (value & _U32) > error_to_u32(CmpErrorCode.MAX_CODE)


def u32_to_error_code(value: int) -> CmpErrorCode:
    """Map a negated-uint32 result back to its error code (or NO_ERROR)."""
    if not u32_is_error(value):
        return CmpErrorCode.NO_ERROR
    raw = (-value) & _U32
    try:
        return CmpErrorCode(raw)
    except ValueError:
        return CmpErrorCode.GENERIC


def error_message(code: CmpErrorCode) -> str:
    return _MESSAGES.get(code, "Unknown error code")


class CmpError(Exception):
    """Exception carrying an AIRSPACE error code.

    Raised by the Python API where the reference returns a negated error
    uint32.  ``CmpError(code).u32`` reproduces the exact C return value.
    """

    def __init__(self, code: CmpErrorCode, detail: str | None = None):
        self.code = CmpErrorCode(code)
        msg = error_message(self.code)
        if detail:
            msg = f"{msg}: {detail}"
        super().__init__(msg)

    @property
    def u32(self) -> int:
        return error_to_u32(self.code)
