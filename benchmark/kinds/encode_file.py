"""Request kind ``encode_file``: one client writes compressed files.

Set-up draws a pool of ``files * batches_per_file`` (B, N) batches from
the seed and holds it in host memory; the pool is whole chain cycles
(``1 + secondary_iterations`` batches).  One request compresses one file
of ``batches_per_file`` batches, one ``BatchCompressor.
compress_frames_packed`` call a batch, until the file's frame bytes are
on the host.  One compressor serves every request, so the model chains
run on across files; global batch t takes pool batch ``t % pool``, and
identifiers come from a deterministic stamp that starts at the seed.

The check has the plain reference encode one pass of the pool with the
same stamp: batch t's stream is pool batch ``t % pool``'s with the
identifiers of t's chain cycle.  Every frame size of every file is
compared; every byte of every kept file, and of every other file the
``PROBES`` bytes a batch at positions drawn from the seed.

Programs: ``port``; ``control``, the reference's streams of the pool with
each sample's lowest bit dropped (a 15-bit codec in the program's place);
and the faults ``fault.answer_altered`` (one byte of a file flipped),
``fault.half_batch`` (the frames of the second half of the chains left
out), ``fault.state_unchanged`` (the compressor's model restored after
each call).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import config, generate, roofline
from benchmark.reference import airspace

PROGRAMS = ("port", "control", "fault.answer_altered", "fault.half_batch",
            "fault.state_unchanged")
ID_MASK = (1 << 48) - 1
PROBES = 4096   # bytes of a batch's stream compared where it is not kept


class Work:
    def __init__(self, run):
        if run.program not in PROGRAMS:
            raise ValueError(f"unknown program {run.program!r}")
        self.run = run
        cfg, mix = run.cell.config, run.cell.traffic
        self.B, self.N = int(cfg["batch"]), int(cfg["samples"])
        self.per_file = int(mix["batches_per_file"])
        self.pool_size = int(mix["files"]) * self.per_file
        self.cycle = config.chain_cycle(cfg)
        if self.pool_size % self.cycle:
            raise ValueError(f"a pool of {self.pool_size} batches is not "
                             f"whole chain cycles of {self.cycle}")
        self.stamp0 = generate.stamp_start(run.seed)
        self.bc = None
        self.program = None
        rng = np.random.default_rng([run.seed % (1 << 64), 0x70726F62])
        # positions as fractions of 2**31 of a stream's length, ascending
        self.at = np.sort(rng.integers(0, 1 << 31, PROBES, dtype=np.int64))

    def prepare(self) -> None:
        run = self.run
        x = generate.frames(run.cell.config["data"],
                            (self.pool_size, self.B, self.N), run.seed,
                            run.device)
        self.pool = x.cpu().numpy().astype(np.uint16)
        del x

    def _reference(self, pool: np.ndarray):
        """The reference's streams and sizes of one pass of ``pool``."""
        streams, sizes = [], []
        stamp = airspace.Stamp(self.stamp0)
        state = None
        for batch in pool:      # one batch a call: the chain keeps its state
            x = torch.from_numpy(batch.astype(np.int32)).to(self.run.device)
            s, z, state = airspace.encode_chain(
                [x], config.reference_params(self.run.cell.config), stamp,
                state)
            streams += s
            sizes += z
        return streams, sizes

    def start(self) -> None:
        if self.run.program == "control":
            t = time.perf_counter()
            self.control = self._reference(self.pool & np.uint16(0xFFFE))
            self.reference_s = time.perf_counter() - t
            return
        import airs_compression_tpu_torch as program
        self.program = program
        program.set_timestamp_func(airspace.Stamp(self.stamp0))
        self.bc = program.BatchCompressor(
            config.program_params(self.run.cell.config, program), self.B,
            self.N, device=self.run.device)

    def _ids(self, t: int, sizes) -> "tuple[np.ndarray, np.ndarray]":
        """Where batch t's identifier bytes lie in its stream (ascending)
        and their values."""
        ids = (self.stamp0 + self.B * (t // self.cycle)
               + np.arange(self.B, dtype=np.int64)) & ID_MASK
        starts = np.cumsum(sizes) - sizes
        at = (starts + 8)[:, None] + np.arange(6)
        return (at.reshape(-1),
                ((ids[:, None] >> (8 * (5 - np.arange(6)))) & 0xFF
                 ).reshape(-1))

    def _with_ids(self, t: int, stream: np.ndarray, sizes) -> np.ndarray:
        """Pool batch ``t % pool``'s stream under batch t's identifiers."""
        base = t % self.pool_size
        if t // self.cycle == base // self.cycle:
            return stream
        out = stream.copy()
        at, value = self._ids(t, sizes)
        out[at] = value
        return out

    def _positions(self, n: int) -> np.ndarray:
        return (self.at * n) >> 31

    def _probed_want(self, t: int, stream: np.ndarray, sizes) -> np.ndarray:
        """Batch t's reference bytes at the probed positions."""
        pos = self._positions(stream.size)
        want = stream[pos]
        at, value = self._ids(t, sizes)
        j = np.minimum(np.searchsorted(at, pos), at.size - 1)
        hit = at[j] == pos
        want[hit] = value[j[hit]]
        return want

    def request(self, i: int):
        ts = range(i * self.per_file, (i + 1) * self.per_file)
        if self.run.program == "control":
            streams, sizes = self.control
            return [(self._with_ids(t, streams[t % self.pool_size],
                                    sizes[t % self.pool_size]).tobytes(),
                     sizes[t % self.pool_size]) for t in ts]
        fault = self.run.program
        out = []
        for t in ts:
            model = self.bc.model
            stream, sizes = self.bc.compress_frames_packed(
                self.pool[t % self.pool_size])
            if fault == "fault.state_unchanged":
                self.bc.model = model
            elif fault == "fault.half_batch":
                stream = stream[:int(sizes[:self.B // 2].sum())]
                sizes = sizes[:self.B // 2]
            out.append((stream, sizes))
        if fault == "fault.answer_altered":
            s = bytearray(out[-1][0])
            s[len(s) // 2] ^= 0x01
            out[-1] = (bytes(s), out[-1][1])
        return out

    def probe(self, i: int, out) -> list:
        """Each batch's frame sizes, stream length and the bytes at the
        probed positions of answer ``out``."""
        probe = []
        for stream, sizes in out:
            got = np.frombuffer(stream, np.uint8)
            probe.append((np.array(sizes, np.int64), got.size,
                          got[self._positions(got.size)]))
        return probe

    def raw_bytes(self, i: int) -> int:
        return 2 * self.per_file * self.B * self.N

    def batches(self, i: int) -> int:
        return self.per_file

    def kernel_bytes(self, i: int, out) -> dict:
        cfg = self.run.cell.config
        checksum = bool(cfg["params"].get("checksum_enabled"))
        total = {"k1": 0, "k5": 0}
        if checksum:
            total["k4"] = 0
        for k, (_, sizes) in enumerate(out):
            secondary = (i * self.per_file + k) % self.cycle != 0
            hdr = config.header_bytes(cfg, secondary)
            total["k1"] += roofline.k1_bytes(sizes, self.N, hdr,
                                             4 if checksum else 0)
            total["k5"] += roofline.k5_bytes(sizes)
            if checksum:
                total["k4"] += roofline.k4_bytes(self.B, self.N)
        return total

    def stop(self) -> None:
        self.bc = None
        if self.program is not None:
            self.program.set_timestamp_func(None)

    def check(self, kept: dict, probes: dict) -> "tuple[dict, dict]":
        """(numbers compared: name -> (value, limit), notes) over the kept
        answers and the other answers' probes, each by request index.  A
        batch missing or extra counts its B sizes wrong; a stream of the
        wrong length counts all its bytes (or its probed ones) wrong."""
        streams, sizes = self._reference(self.pool)
        P = self.pool_size
        bytes_wrong = sizes_wrong = compared = probed = 0
        stored = raw = 0

        def sizes_off(got_sizes, want_sizes):
            got_sizes = np.asarray(got_sizes, np.int64)
            if got_sizes.shape != want_sizes.shape:
                return self.B
            return int(np.count_nonzero(got_sizes != want_sizes))

        for i, out in kept.items():
            sizes_wrong += abs(len(out) - self.per_file) * self.B
            for k, (stream, got_sizes) in enumerate(out):
                t = i * self.per_file + k
                want_sizes = sizes[t % P]
                want = self._with_ids(t, streams[t % P], want_sizes)
                got = np.frombuffer(stream, np.uint8)
                sizes_wrong += sizes_off(got_sizes, want_sizes)
                if got.size != want.size:
                    bytes_wrong += max(got.size, want.size)
                else:
                    bytes_wrong += int(np.count_nonzero(got != want))
                compared += 1
                stored += want.size
                raw += 2 * self.B * self.N
        for i, out in probes.items():
            sizes_wrong += abs(len(out) - self.per_file) * self.B
            for k, (got_sizes, n, got) in enumerate(out):
                t = i * self.per_file + k
                want_sizes = sizes[t % P]
                sizes_wrong += sizes_off(got_sizes, want_sizes)
                if n != streams[t % P].size:
                    bytes_wrong += got.size
                else:
                    bytes_wrong += int(np.count_nonzero(
                        got != self._probed_want(t, streams[t % P],
                                                 want_sizes)))
                probed += 1
        return ({"bytes_wrong": (bytes_wrong, 0),
                 "sizes_wrong": (sizes_wrong, 0)},
                {"batches_compared": compared, "batches_probed": probed,
                 "ratio": stored / raw if raw else None})
