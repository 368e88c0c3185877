"""Request kind ``decode_file``: one client decodes archived files.

Set-up draws ``files * batches_per_file`` (B, N) batches from the seed and
has the plain reference encode them into the archive: ``files`` files,
each its batches' packed streams one after another, with its frame sizes
as the manifest.  The reference's seconds are ``reference_s``, which
``setup_s`` leaves out.  One request decodes one file with
``BatchDecompressor.decompress_file_stream`` (the program's defaults)
until its last window of u16 samples is on the host; request i takes file
``i % files``.

The check compares with the samples the benchmark drew every u16 sample
of every kept window, and of every other window the ``PROBES`` samples
at positions drawn from the seed; a window missing or misshapen counts
all its samples (or all its probed ones) wrong.

Programs: ``port``; ``control``, the drawn samples with their lowest bit
dropped (a 15-bit codec in the program's place); and the faults
``fault.answer_altered`` (one sample of a file flipped),
``fault.half_batch`` (the second half of each window's rows left out)
and ``fault.state_unchanged`` (each request answers with the previous
request's windows).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import config, generate, roofline
from benchmark.reference import airspace

PROGRAMS = ("port", "control", "fault.answer_altered", "fault.half_batch",
            "fault.state_unchanged")
PROBES = 4096   # samples of a window that are compared where it is not kept


class Work:
    def __init__(self, run):
        if run.program not in PROGRAMS:
            raise ValueError(f"unknown program {run.program!r}")
        self.run = run
        cfg, mix = run.cell.config, run.cell.traffic
        self.B, self.N = int(cfg["batch"]), int(cfg["samples"])
        self.per_file = int(mix["batches_per_file"])
        self.files = int(mix["files"])
        self.bd = None
        self._last = None
        rng = np.random.default_rng([run.seed % (1 << 64), 0x70726F62])
        self.at = np.sort(rng.choice(self.B * self.N,
                                     min(PROBES, self.B * self.N),
                                     replace=False))

    def prepare(self) -> None:
        run = self.run
        cfg = run.cell.config
        x = generate.frames(cfg["data"],
                            (self.files * self.per_file, self.B, self.N),
                            run.seed, run.device)
        self.expected = x.cpu().numpy().astype(np.uint16)
        t = time.perf_counter()
        streams, sizes, _ = airspace.encode_chain(
            x, config.reference_params(cfg),
            airspace.Stamp(generate.stamp_start(run.seed)))
        self.reference_s = time.perf_counter() - t
        del x
        k = self.per_file
        self.file_bytes, self.offsets, self.lens = [], [], []
        for f in range(self.files):
            lens = np.concatenate(sizes[f * k:(f + 1) * k])
            self.file_bytes.append(
                np.concatenate(streams[f * k:(f + 1) * k]).tobytes())
            self.lens.append(lens)
            self.offsets.append(np.cumsum(lens) - lens)
        self.ratio = sum(map(len, self.file_bytes)) / self.expected.nbytes

    def start(self) -> None:
        if self.run.program == "control":
            return
        import airs_compression_tpu_torch as program
        self.bd = program.BatchDecompressor(
            config.program_params(self.run.cell.config, program), self.B,
            self.N, device=self.run.device)

    def request(self, i: int):
        f = i % self.files
        k = self.per_file
        if self.run.program == "control":
            return [w & np.uint16(0xFFFE)
                    for w in self.expected[f * k:(f + 1) * k]]
        out = list(self.bd.decompress_file_stream(
            self.file_bytes[f], self.offsets[f], self.lens[f]))
        fault = self.run.program
        if fault == "fault.answer_altered":
            out[-1] = out[-1].copy()
            out[-1][0, 0] ^= 1
        elif fault == "fault.half_batch":
            out = [w.copy() for w in out]
            for w in out:
                w[self.B // 2:] = 0
        elif fault == "fault.state_unchanged":
            out, self._last = (self._last if self._last is not None
                               else [np.zeros_like(w) for w in out]), out
        return out

    def probe(self, i: int, out) -> list:
        """The samples at the probed positions of each window of answer
        ``out`` (None for a misshapen window)."""
        return [w.reshape(-1)[self.at] if w.shape == (self.B, self.N)
                else None for w in out]

    def raw_bytes(self, i: int) -> int:
        return 2 * self.per_file * self.B * self.N

    def batches(self, i: int) -> int:
        return self.per_file

    def kernel_bytes(self, i: int, out) -> dict:
        return {"k3": roofline.k3_bytes(self.lens[i % self.files], self.N)}

    def stop(self) -> None:
        self.bd = None
        self._last = None

    def check(self, kept: dict, probes: dict) -> "tuple[dict, dict]":
        """(numbers compared: name -> (value, limit), notes) over the kept
        answers and the other answers' probes, each by request index.  A
        window missing, extra or misshapen counts all its samples wrong:
        B x N kept, ``len(self.at)`` probed."""
        k = self.per_file
        window = self.B * self.N
        wrong = compared = probed = 0
        for i, out in kept.items():
            f = i % self.files
            expected = self.expected[f * k:(f + 1) * k]
            wrong += abs(len(out) - k) * window
            for got, want in zip(out, expected):
                if got.shape != want.shape or got.dtype != want.dtype:
                    wrong += window
                    continue
                wrong += int(np.count_nonzero(got != want))
                compared += 1
        for i, out in probes.items():
            f = i % self.files
            expected = self.expected[f * k:(f + 1) * k].reshape(k, -1)
            wrong += abs(len(out) - k) * self.at.size
            for got, want in zip(out, expected):
                if got is None or got.dtype != want.dtype:
                    wrong += self.at.size
                    continue
                wrong += int(np.count_nonzero(got != want[self.at]))
                probed += 1
        return ({"samples_wrong": (wrong, 0)},
                {"windows_compared": compared, "windows_probed": probed,
                 "ratio": self.ratio})
