"""The traced part of a run: ``torch.profiler`` over a few requests, read
from its Chrome trace.

The benchmark's own spans (``bench.request``, one a request) mark the
traced window; device records (kernels, copies, fills) and host records
(operators, runtime calls, the spans) come from the profiler.  Times are
in seconds.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch

from . import roofline

__all__ = ["REQUEST_SPAN", "Trace", "profile"]

REQUEST_SPAN = "bench.request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Trace:
    """Device and host records of one profile, clipped to the requests."""

    def __init__(self, events: "list[dict]"):
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == REQUEST_SPAN]
        self.requests = len(spans)
        if spans:
            self.t0 = min(float(e["ts"]) for e in spans) / 1e6
            self.t1 = max(float(e["ts"]) + float(e["dur"])
                          for e in spans) / 1e6
        else:
            self.t0 = self.t1 = 0.0

        def rec(e):
            return (e["cat"], str(e.get("name", "")), float(e["ts"]) / 1e6,
                    float(e.get("dur", 0.0)) / 1e6)

        self.device = sorted((rec(e) for e in events
                              if e.get("cat") in DEVICE_CATS
                              and e.get("ph") == "X"), key=lambda r: r[2])
        self.host = [rec(e) for e in events if e.get("cat") in HOST_CATS
                     and e.get("ph") == "X" and e.get("name") != REQUEST_SPAN]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def _busy_intervals(self):
        """Merged intervals in which the device ran something, inside the
        window."""
        out = []
        for _, _, ts, dur in self.device:
            a, b = max(ts, self.t0), min(ts + dur, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy_intervals())

    def device_s(self, cat: str, family=None, others: bool = False) -> float:
        """Device seconds of records of ``cat``; for kernels, of one
        family, or with ``others`` of the kernels of no family."""
        return sum(dur for c, name, _, dur in self.device
                   if c == cat and self._pick(name, family, others))

    def count(self, cat: str, family=None, others: bool = False) -> int:
        return sum(1 for c, name, _, _ in self.device
                   if c == cat and self._pick(name, family, others))

    @staticmethod
    def _pick(name, family, others) -> bool:
        if family is None and not others:
            return True
        fam = roofline.family_of(name)
        return fam is None if others else fam == family

    def device_ops(self, top: int = 10):
        """The device operations that took most time, by name."""
        tot: "dict[str, float]" = {}
        for _, name, _, dur in self.device:
            tot[name[:160]] = tot.get(name[:160], 0.0) + dur
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """Idle device time inside the window by what the host did: each
        gap goes to the host record that overlaps it most (the innermost
        of equals)."""
        edges = [self.t0]
        for a, b in self._busy_intervals():
            edges += [a, b]
        edges.append(self.t1)
        tot: "dict[str, float]" = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            best, best_key = "host: no traced operation", (0.0, 0.0)
            for _, name, ts, dur in self.host:
                over = min(b, ts + dur) - max(a, ts)
                if over <= 0:
                    continue
                key = (round(over / (b - a), 2), -dur)
                if key > best_key:
                    best, best_key = name, key
            tot[best] = tot.get(best, 0.0) + (b - a)
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:top]


@contextlib.contextmanager
def profile(device: torch.device):
    """Profile the body; yields a list that holds the :class:`Trace` once
    the body has ended (the Chrome trace goes through a file under
    ``TMPDIR``, deleted after it is read)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    box: "list[Trace]" = []
    with torch.profiler.profile(activities=acts) as prof:
        yield box
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    box.append(Trace(events))
