"""The general traffic generator's data: detector frames from the seed.

A configuration's ``data`` entry gives the frames' statistics: a ``level``,
Gaussian read noise of ``sigma`` (bench.py:155-158, chip_smoke.py
``make_frames``) and full-range particle hits at ``hit_rate`` a sample
(chip_smoke.py ``make_widening_frames(spikes=True)``).  Every seed gives
the same sizes; only the values differ.  The frames are drawn on the
device with a ``torch.Generator`` in a few large calls.
"""

from __future__ import annotations

import torch

__all__ = ["frames", "stamp_start"]


def frames(data: dict, shape, seed: int, device) -> torch.Tensor:
    """int32 tensor of u16 samples of ``shape`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    noise = torch.randn(shape, generator=gen, device=device)
    x = (float(data["level"]) + float(data["sigma"]) * noise).to(
        torch.int64) & 0xFFFF                      # truncated, as numpy's cast
    del noise
    rate = float(data.get("hit_rate", 0.0))
    if rate:
        hit = torch.rand(shape, generator=gen, device=device) < rate
        value = torch.randint(0, 1 << 16, shape, generator=gen, device=device)
        x = torch.where(hit, value, x)
    return x.to(torch.int32)


def stamp_start(seed: int) -> int:
    """First identifier of a run's deterministic timestamp source."""
    return seed % (1 << 40)
