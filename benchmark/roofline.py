"""The yardstick of the kernels: peaks, the port's kernel families and the
bytes each launch must move.

Bytes follow one rule: each input byte read once, each output byte written
once, and sizes that depend on the data counted as these inputs need (the
frames' real lengths, not the worst-case capacity).  The count is what
the least time of the kernel rests on, so a share of it can not pass 100 %
unless the time misses part of the work.  The formulas are chip_smoke.py's
(``k5_bytes``, the K3 coalesced bound), with K1's output cut to the words
its codes fill.
"""

from __future__ import annotations

import numpy as np

__all__ = ["HBM_BYTES_PER_S", "FAMILIES", "family_of", "k1_bytes",
           "k3_bytes", "k4_bytes", "k5_bytes", "share"]

#: device memory bandwidth by ``torch.cuda.get_device_name()``: NVIDIA's
#: data sheets, at the full power limit
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

#: the port's kernel families: the wrappers that count their launches
#: (``<module>.<function>`` under ``airs_compression_tpu_torch.ops``) and
#: the substrings of their kernels' names in a device trace
FAMILIES = {
    "k1": (("pack.pack_residuals", "pack.pack_residuals_at"),
           ("ResidualCodes",)),
    "k2": (("pack.pack_codes", "pack.pack_codes_at"), ("LoadedCodes",)),
    "k3": (("decode_kernel.decode_blocks", "decode_kernel.decode_windows"),
           ("decode_blocks_kernel", "decode_windows_kernel")),
    "k4": (("xxh32_device.checksum_blocks_device",
            "xxh32_device.checksum_stream_device", "xxh32_device.xxh32_lanes"),
           ("xxh32_blocks_kernel", "xxh32_long_kernel")),
    "k5": (("assemble.assemble_stream",), ("assemble_kernel",)),
}


def family_of(kernel_name: str) -> "str | None":
    """The family whose kernel ``kernel_name`` is, or None (a kernel of
    plain torch)."""
    for fam, (_, marks) in FAMILIES.items():
        if any(m in kernel_name for m in marks):
            return fam
    return None


def _sum_words(sizes) -> int:
    return int(((np.asarray(sizes, np.int64) + 3) // 4).sum())


def k1_bytes(sizes, n: int, hdr: int, trailer: int) -> int:
    """K1 on one batch whose frames came out ``sizes`` bytes long: the
    int32 residuals read, the u32 words the payload fills written, and
    the bit count of each row."""
    sizes = np.asarray(sizes, np.int64)
    rows = sizes.size
    return 4 * rows * n + 4 * _sum_words(sizes - hdr - trailer) + 4 * rows


def k3_bytes(lens, n: int) -> int:
    """K3 over rows whose frames are ``lens`` bytes: the frames read, the
    Golomb parameter and outlier of each row, the int32 values and the
    end bit written."""
    rows = np.asarray(lens).size
    return int(np.asarray(lens, np.int64).sum()) + 8 * rows \
        + 4 * n * rows + 4 * rows


def k4_bytes(rows: int, n: int) -> int:
    """K4 on ``rows`` rows of ``n`` int32 samples: read once, a u32 out."""
    return 4 * rows * n + 4 * rows


def k5_bytes(sizes) -> int:
    """K5 on one batch: the words each frame's bytes lie in (int64 words,
    as the encoder hands them), the sizes, the stream written once."""
    sizes = np.asarray(sizes, np.int64)
    return 8 * _sum_words(sizes) + 4 * sizes.size + int(sizes.sum())


def share(view, family: str) -> "float | None":
    """A family's share of its byte bound in the traced requests, in %:
    100 * (bytes / bandwidth) / device time; None where the trace holds
    none of its kernels, or the bandwidth or the bytes are unknown."""
    if view is None or not view.hbm_bytes_per_s:
        return None
    seconds = view.trace.device_s("kernel", family=family)
    nbytes = view.kernel_bytes.get(family)
    if seconds <= 0 or not nbytes:
        return None
    return 100.0 * nbytes / view.hbm_bytes_per_s / seconds
