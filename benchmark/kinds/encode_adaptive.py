"""Request kind ``encode_adaptive``: one client writes compressed files,
each block of each frame under its own Golomb parameter.

As ``encode_file`` (whose set-up, requests, probes and check it keeps),
with three differences:

* the pool is rows of widening read noise, drawn on the device from the
  seed with a ``torch.Generator``: row b of every batch is ``level`` +
  N(0, 1) * ``sigma_step`` * (1 + b mod ``sigma_period``), truncated, plus
  full-range particle hits at ``hit_rate`` a sample (the configuration's
  ``data``);
* one ``BatchCompressor(adaptive=True)`` over the configuration's
  ``adaptive`` ladder serves every request, and the plain reference is
  ``reference/adaptive.py`` under the same ladder, ``select`` and
  ``window``;
* the run is refused where ``AIRS_ADAPTIVE_SELECT`` or
  ``AIRS_ADAPTIVE_WINDOW`` makes the program choose otherwise than the
  configuration says, so that the program and the reference cannot drift
  apart.

Programs: ``encode_file``'s (``port``, ``control``, ``fault.answer_altered``,
``fault.half_batch``, ``fault.state_unchanged``) and ``fault.fixed_param``,
the port with ``adaptive=False``: every block under the configured
parameter, the choice left out.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from benchmark import config, roofline, roofline_k2
from benchmark.kinds import encode_file
from benchmark.reference import adaptive, airspace

PROGRAMS = encode_file.PROGRAMS + ("fault.fixed_param",)
#: the program's environment switches of its choice, with their defaults
SWITCHES = {"AIRS_ADAPTIVE_SELECT": ("select", "fast"),
            "AIRS_ADAPTIVE_WINDOW": ("window", "2")}


def check_environment(choice: dict, environ=None) -> None:
    """Raise ValueError where a switch of the environment (or its default)
    gives the program another choice than ``choice`` (the configuration's
    ``select`` and ``window``)."""
    environ = os.environ if environ is None else environ
    for var, (key, default) in SWITCHES.items():
        if key == "window" and choice["select"] == "exact":
            continue                # the exact choice has no window
        value = environ.get(var, default)
        want = str(choice[key])
        try:
            same = (int(value) == int(want) if key == "window"
                    else value == want)
        except ValueError:
            same = False
        if not same:
            raise ValueError(
                f"{var}={value!r} makes the program choose otherwise than "
                f"the configuration ({key} {want!r}), and the reference "
                f"follows the configuration: unset {var} or set it to "
                f"{want!r}")


def widening_frames(data: dict, shape, seed: int, device) -> torch.Tensor:
    """int32 tensor of u16 samples of ``shape`` (..., B, N) on ``device``:
    row b's noise widens with b mod ``sigma_period``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    rows = torch.arange(shape[-2], device=device)
    sigma = float(data["sigma_step"]) * (
        1 + rows % int(data["sigma_period"])).to(torch.float32)
    noise = torch.randn(shape, generator=gen, device=device)
    x = (float(data["level"]) + noise * sigma[:, None]).to(
        torch.int64) & 0xFFFF                      # truncated, as numpy's cast
    del noise
    rate = float(data.get("hit_rate", 0.0))
    if rate:
        hit = torch.rand(shape, generator=gen, device=device) < rate
        value = torch.randint(0, 1 << 16, shape, generator=gen, device=device)
        x = torch.where(hit, value, x)
    return x.to(torch.int32)


class Work(encode_file.Work):
    def __init__(self, run):
        if run.program not in PROGRAMS:
            raise ValueError(f"unknown program {run.program!r}")
        # encode_file's set-up knows its own programs; fault.fixed_param
        # is the port otherwise
        super().__init__(dataclasses.replace(run, program="port"))
        self.run = run
        self.choice = run.cell.config["adaptive"]
        check_environment(self.choice)

    def prepare(self) -> None:
        run = self.run
        x = widening_frames(run.cell.config["data"],
                            (self.pool_size, self.B, self.N), run.seed,
                            run.device)
        self.pool = x.cpu().numpy().astype(np.uint16)
        del x

    def _reference(self, pool: np.ndarray):
        """The reference's streams and sizes of one pass of ``pool``."""
        streams, sizes = [], []
        stamp = airspace.Stamp(self.stamp0)
        p = config.reference_params(self.run.cell.config)
        state = None
        for batch in pool:      # one batch a call: the chain keeps its state
            x = torch.from_numpy(batch.astype(np.int32)).to(self.run.device)
            s, z, state = adaptive.encode_chain(
                [x], p, stamp, self.choice["ladder"], state,
                self.choice["select"], int(self.choice["window"]))
            streams += s
            sizes += z
        return streams, sizes

    def start(self) -> None:
        if self.run.program == "control":
            super().start()
            return
        import airs_compression_tpu_torch as program
        self.program = program
        program.set_timestamp_func(airspace.Stamp(self.stamp0))
        self.bc = program.BatchCompressor(
            config.program_params(self.run.cell.config, program), self.B,
            self.N, adaptive=self.run.program != "fault.fixed_param",
            ladder=self.choice["ladder"], device=self.run.device)

    def kernel_bytes(self, i: int, out) -> dict:
        cfg = self.run.cell.config
        p = cfg["params"]
        checksum = bool(p.get("checksum_enabled"))
        trailer = 4 if checksum else 0
        total = {"k2": 0, "k5": 0}
        if checksum:
            total["k4"] = 0
        for k, (_, sizes) in enumerate(out):
            secondary = (i * self.per_file + k) % self.cycle != 0
            side = "secondary" if secondary else "primary"
            multi = p[f"{side}_encoder_type"] == "GOLOMB_MULTI"
            total["k2"] += roofline_k2.k2_bytes(
                sizes, self.N, config.header_bytes(cfg, secondary), trailer,
                multi)
            total["k5"] += roofline.k5_bytes(sizes)
            if checksum:
                total["k4"] += roofline.k4_bytes(self.B, self.N)
        return total
