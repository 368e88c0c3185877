"""Request kind ``encode_long``: one client compresses long blocks, one
block a file, with one context across the files.

Set-up draws a pool of ``files`` blocks of ``samples`` u16 samples (the
configuration's ``batch`` must be 1) from the seed and holds it in host
memory; the pool is whole chain cycles (``1 + secondary_iterations``
blocks).  One request compresses global block t, which is pool block
``t % pool``, with ONE ``parallel.sp.LongStreamCompressor.compress``
call, until the frame's bytes are on the host.  One compressor serves
every request, so the model chains on across files, as upstream's
``airspace`` CLI keeps one context across a list of files.  Identifiers
come from a deterministic stamp that starts at the seed: the compressor
draws one when it is made and one at each primary pass, so block t's
identifier is ``stamp0 + 1 + t // cycle``.

The check has the plain reference (``reference/long_chain.py``) encode
one pass of the pool with the same stamp: block t's frame is pool block
``t % pool``'s with t's identifier.  Every frame's size is compared;
every byte of every kept frame, and of every other frame its 22 header
bytes, its 4 trailer bytes and ``PROBES`` bytes at positions drawn from
the seed (a fault of the checksum changes only the trailer, which random
positions would miss).

Programs: ``port``; ``control``, the reference's frames of the pool with
each sample's lowest bit dropped (a 15-bit codec in the program's place);
and the faults ``fault.answer_altered`` (one payload byte of each frame
flipped), ``fault.trailer_wrong`` (the trailer's last byte flipped),
``fault.state_unchanged`` (the compressor's model restored after each
call that had one).
"""

from __future__ import annotations

import importlib
import time

import numpy as np

from benchmark import config, generate, roofline, roofline_long
from benchmark.reference import airspace, long_chain

PROGRAMS = ("port", "control", "fault.answer_altered", "fault.trailer_wrong",
            "fault.state_unchanged")
ID_MASK = (1 << 48) - 1
ID_AT = 8           # the identifier's 6 bytes in the header
HDR = 22
TRAILER = 4
PROBES = 4096       # bytes a frame not kept is compared at (seeded positions)


class Work:
    def __init__(self, run):
        if run.program not in PROGRAMS:
            raise ValueError(f"unknown program {run.program!r}")
        self.run = run
        cfg, mix = run.cell.config, run.cell.traffic
        if int(cfg["batch"]) != 1:
            raise ValueError("encode_long takes one block a frame (batch 1)")
        self.n = int(cfg["samples"])
        self.pool_size = int(mix["files"])
        self.cycle = config.chain_cycle(cfg)
        if self.pool_size % self.cycle:
            raise ValueError(f"a pool of {self.pool_size} blocks is not "
                             f"whole chain cycles of {self.cycle}")
        self.checksum = bool(cfg["params"].get("checksum_enabled"))
        self.stamp0 = generate.stamp_start(run.seed)
        self.lc = None
        self.program = None
        rng = np.random.default_rng([run.seed % (1 << 64), 0x6C6F6E67])
        # positions as fractions of 2**31 of a frame's length
        self.at = rng.integers(0, 1 << 31, PROBES, dtype=np.int64)

    def prepare(self) -> None:
        run = self.run
        x = generate.frames(run.cell.config["data"], (self.pool_size, self.n),
                            run.seed, run.device)
        self.pool = x.cpu().numpy().astype(np.uint16)
        del x

    def _reference(self, pool: np.ndarray) -> "list[np.ndarray]":
        """The reference's frames of one pass of ``pool``, under the
        stamp the compressor draws from."""
        ctx = long_chain.LongContext(
            config.reference_params(self.run.cell.config),
            airspace.Stamp(self.stamp0))
        return ctx.encode_all(pool, self.run.device)

    def start(self) -> None:
        if self.run.program == "control":
            t = time.perf_counter()
            self.control = self._reference(self.pool & np.uint16(0xFFFE))
            self.reference_s = time.perf_counter() - t
            return
        import airs_compression_tpu_torch as program
        self.program = program
        sp = importlib.import_module(f"{program.__name__}.parallel.sp")
        program.set_timestamp_func(airspace.Stamp(self.stamp0))
        self.lc = sp.LongStreamCompressor(
            config.program_params(self.run.cell.config, program),
            device=self.run.device)

    def _id_bytes(self, t: int) -> np.ndarray:
        ident = (self.stamp0 + 1 + t // self.cycle) & ID_MASK
        return np.frombuffer(ident.to_bytes(6, "big"), np.uint8)

    def _with_id(self, t: int, frame: np.ndarray) -> np.ndarray:
        """Pool block ``t % pool``'s frame under block t's identifier."""
        out = frame.copy()
        out[ID_AT:ID_AT + 6] = self._id_bytes(t)
        return out

    def _positions(self, size: int) -> np.ndarray:
        return (self.at * size) >> 31

    def request(self, i: int):
        t = i
        if self.run.program == "control":
            return self._with_id(t, self.control[t % self.pool_size]).tobytes()
        fault = self.run.program
        model = self.lc.model
        frame = self.lc.compress(self.pool[t % self.pool_size])
        if fault == "fault.state_unchanged" and model is not None:
            self.lc.model = model
        elif fault == "fault.answer_altered":
            s = bytearray(frame)
            s[HDR + (len(s) - HDR - TRAILER) // 2] ^= 0x01
            frame = bytes(s)
        elif fault == "fault.trailer_wrong":
            s = bytearray(frame)
            s[-1] ^= 0x01
            frame = bytes(s)
        return frame

    def probe(self, i: int, out) -> tuple:
        """Answer ``out``'s size, header, trailer and the bytes at the
        probed positions."""
        got = np.frombuffer(out, np.uint8)
        return (got.size, got[:HDR].copy(), got[-TRAILER:].copy(),
                got[self._positions(got.size)])

    def raw_bytes(self, i: int) -> int:
        return 2 * self.n

    def batches(self, i: int) -> int:
        return 1

    def kernel_bytes(self, i: int, out) -> dict:
        trailer = TRAILER if self.checksum else 0
        total = {"k1": roofline_long.k1_long_bytes(len(out), self.n, HDR,
                                                   trailer)}
        if self.checksum:
            total["k4"] = roofline.k4_bytes(1, self.n)
        return total

    def stop(self) -> None:
        self.lc = None
        if self.program is not None:
            self.program.set_timestamp_func(None)

    def check(self, kept: dict, probes: dict) -> "tuple[dict, dict]":
        """(numbers compared: name -> (value, limit), notes) over the kept
        answers and the other answers' probes, each by request index.  A
        frame of the wrong length counts all its bytes (or all its probed
        ones) wrong."""
        frames = self._reference(self.pool)
        P = self.pool_size
        bytes_wrong = sizes_wrong = stored = 0
        for t, out in kept.items():
            want = self._with_id(t, frames[t % P])
            got = np.frombuffer(out, np.uint8)
            if got.size != want.size:
                sizes_wrong += 1
                bytes_wrong += max(got.size, want.size)
            else:
                bytes_wrong += int(np.count_nonzero(got != want))
            stored += want.size
        for t, (size, hdr, tail, got) in probes.items():
            want = frames[t % P]
            if size != want.size:
                sizes_wrong += 1
                bytes_wrong += HDR + TRAILER + got.size
                continue
            pos = self._positions(size)
            want_at = want[pos]
            ids = (pos >= ID_AT) & (pos < ID_AT + 6)
            want_at[ids] = self._id_bytes(t)[pos[ids] - ID_AT]
            bytes_wrong += int(
                np.count_nonzero(hdr != self._with_id(t, want[:HDR]))
                + np.count_nonzero(tail != want[-TRAILER:])
                + np.count_nonzero(got != want_at))
        raw = 2 * self.n * len(kept)
        return ({"bytes_wrong": (bytes_wrong, 0),
                 "sizes_wrong": (sizes_wrong, 0)},
                {"frames_compared": len(kept), "frames_probed": len(probes),
                 "ratio": stored / raw if raw else None})
