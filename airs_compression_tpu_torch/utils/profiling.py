"""Spans, stage timers and traces on the card.

Port of ``airs_compression_tpu/utils/profiling.py``:

* :func:`span` — a named ``torch.profiler`` range (a ``record_function``)
  while a profiler runs, and one shared null context, which costs under a
  microsecond, while none does.  The batch tier (models/stream.py, spans
  ``stream.*``) and the long stream (parallel/sp.py, spans ``sp.*``) open
  them.
* :class:`StageTimer` — accumulating per-stage timers.  A stage given a
  CUDA device (or a tensor on one) records a CUDA event on entry and on
  exit and waits for the exit event, so its wall time (host clock) covers
  the device work it enqueued; the device time between the two events is
  kept beside it.  Without one a stage is timed on the host clock alone.
* :func:`trace` — a ``torch.profiler`` trace of CPU and CUDA activity,
  written as a Chrome trace: open it in Perfetto (ui.perfetto.dev) or
  chrome://tracing to see the spans on the host beside the device work
  they launched.
* :func:`range_times` — the host and device time of named spans in a
  finished profile.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["span", "StageTimer", "trace", "range_times"]

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler`` range named ``name`` where a profiler runs
    (:func:`range_times` reads it; in a Chrome trace it is a
    ``user_annotation`` record), else a shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _cuda_device(sync) -> "torch.device | None":
    """The CUDA device a stage synchronizes on, or None."""
    if sync is None:
        return None
    dev = sync.device if isinstance(sync, torch.Tensor) else torch.device(sync)
    return dev if dev.type == "cuda" else None


class StageTimer:
    """Accumulating per-stage timers (wall time, and device time between
    CUDA events where the stage names a CUDA device)."""

    def __init__(self) -> None:
        self.totals: "dict[str, float]" = {}
        self.device_totals: "dict[str, float]" = {}
        self.counts: "dict[str, int]" = {}
        self.bytes: "dict[str, int]" = {}

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0, sync=None):
        """Time the body as stage ``name``; ``nbytes`` adds to its byte
        count (for GB/s); ``sync`` a CUDA device or tensor to wait for."""
        dev = _cuda_device(sync)
        events = None
        if dev is not None:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if events is not None:
                events[1].record(torch.cuda.current_stream(dev))
                events[1].synchronize()
                self.device_totals[name] = (
                    self.device_totals.get(name, 0.0)
                    + events[0].elapsed_time(events[1]) / 1e3)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self.bytes[name] = self.bytes.get(name, 0) + nbytes

    def as_dict(self) -> dict:
        """Per stage: wall seconds, device seconds between the events (None
        for a host stage), calls, bytes and GB/s over the wall time."""
        out = {}
        for name, total in self.totals.items():
            b = self.bytes[name]
            out[name] = {"s": total, "device_s": self.device_totals.get(name),
                         "calls": self.counts[name], "bytes": b,
                         "GBps": b / total / 1e9 if b and total else None}
        return out

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items()):
            n = self.counts[name]
            b = self.bytes[name]
            rate = f", {b / total / 1e9:.2f} GB/s" if b and total else ""
            lines.append(f"{name}: {total * 1e3:.2f} ms / {n} calls"
                         f" ({total / n * 1e3:.3f} ms avg{rate})")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(path: str):
    """Profile the body (CPU, and CUDA where available) with
    ``torch.profiler`` and write a Chrome trace to ``path``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)


def range_times(prof, prefix: str) -> dict:
    """Per ``record_function`` range of a finished ``torch.profiler``
    profile whose name starts with ``prefix``: ``s`` its host seconds,
    ``device_s`` the device seconds of the work launched inside it, and
    ``calls``.

    A device record (kernel, copy, fill) counts for a range when the
    runtime call that launched it (``cudaLaunchKernel``, ``cuLaunchKernel``,
    ``cudaMemcpyAsync``...) lies inside the range on the host: the two share
    CUPTI's correlation id.  That holds for kernels launched through
    ``ctypes``, which the profiler does not tie to the enclosing range
    itself.  Without CUDA activity ``device_s`` is 0."""
    cpu = torch.autograd.DeviceType.CPU
    events = list(prof.events())
    device_us: "dict[int, float]" = {}
    for e in events:
        if e.device_type != cpu:
            device_us[e.id] = (device_us.get(e.id, 0.0)
                               + e.time_range.elapsed_us())
    launches = [(e.time_range.start, device_us[e.id]) for e in events
                if e.device_type == cpu and e.name.startswith("cu")
                and e.id in device_us]
    out: "dict[str, dict]" = {}
    for e in events:
        if e.device_type != cpu or not e.name.startswith(prefix):
            continue
        r = out.setdefault(e.name, {"s": 0.0, "device_s": 0.0, "calls": 0})
        lo, hi = e.time_range.start, e.time_range.end
        r["s"] += e.cpu_time_total / 1e6
        r["device_s"] += sum(us for t, us in launches if lo <= t <= hi) / 1e6
        r["calls"] += 1
    return out
