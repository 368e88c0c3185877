"""The benchmark's harness: finds a cell's parts by name and runs it once.

Everything that belongs to one cell is found by the names in
``BENCHMARK.json``:

* a configuration: the file its entry names (``configs/<name>.json``);
* a traffic mix: ``traffic/<traffic>.json``, whose ``kind`` names the
  request kind ``kinds/<kind>.py`` that sets the cell up, serves one
  request and checks the answers against the plain reference;
* a per-layer metric: ``metrics/<name>.py``, or ``metrics/<stem>.py``
  for a name ``<stem>.<suffix>``, whose ``read(view)`` takes the metric
  from the traced run (a :class:`TraceView`) or returns None.

End-to-end metrics follow from their names: ``setup_s``,
``<op>_GBps`` (raw sample bytes of the completed requests over the
window's wall time) and ``<op>_p<q>_ms`` (the q-th percentile of all the
window's request times).

A run: set-up (the kind's data and reference work, then the program and
``WARM_REQUESTS`` requests), one closed-loop client for ``seconds``, then
the check.  ``setup_s`` leaves out the seconds the kind's set-up spent in
the plain reference (its ``reference_s``).  Every answer of the window is
checked after the window: a seeded share (``keep_share``, and the first)
whole, each other one at the seeded positions of the kind's ``probe``.
With ``trace``, ``TRACE_REQUESTS`` requests from the middle of the window
run under ``torch.profiler``.  The import rule is checked last, after the
metric readers and the check have run.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import pathlib
import re
import sys
import time
import traceback

import numpy as np

from . import roofline, tracing

__all__ = ["HERE", "FORBIDDEN", "forbidden_modules", "process_age_s",
           "Cell", "Run", "TraceView", "load_spec", "resolve", "run_cell",
           "RunRefused"]

HERE = pathlib.Path(__file__).resolve().parent
PROGRAM = "airs_compression_tpu_torch"
#: top-level modules no run may load: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "airs_compression_tpu"})
#: requests run at set-up, before the window: each file a mix cycles over
#: once, at the cells' 4 files
WARM_REQUESTS = 4
#: requests traced from the middle of a ``--trace 1`` window
TRACE_REQUESTS = 4


class RunRefused(RuntimeError):
    """A run that must print no result (exit code non-zero)."""


def forbidden_modules(names=None) -> "list[str]":
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole: ``airs_compression_tpu_torch`` is not
    ``airs_compression_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


def process_age_s() -> "float | None":
    """Seconds since this process started (Linux ``/proc``), or None."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        return None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench_dir: pathlib.Path


@dataclasses.dataclass
class Run:
    cell: Cell
    seed: int
    device: object            # torch.device
    program: str = "port"     # or "control", or a kind's "fault.<name>"


@dataclasses.dataclass
class TraceView:
    """What a per-layer metric reads: the trace of the traced requests,
    their batches, the bytes their kernels had to move by family, the
    launches the program's counters saw, and the device's bandwidth."""

    trace: tracing.Trace
    batches: int
    kernel_bytes: dict
    launches: dict
    hbm_bytes_per_s: "float | None"


def load_spec(root: "pathlib.Path | None" = None) -> dict:
    root = HERE.parent if root is None else pathlib.Path(root)
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(items, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"BENCHMARK.json has no {what} {name!r}")


def resolve(spec: dict, workload: str,
            root: "pathlib.Path | None" = None) -> Cell:
    """The cell ``workload`` with its configuration, traffic and metrics."""
    root = HERE.parent if root is None else pathlib.Path(root)
    bench_dir = root / HERE.name
    w = _named(spec["workloads"], workload, "workload")
    c = _named(spec["configs"], w["config"], "config")
    config = json.loads((root / c["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (workload in m["workloads"] if "workloads" in m
               else m["moves"] in moved)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per,
                bench_dir)


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(cell: Cell):
    kind = cell.traffic["kind"]
    return _load(cell.bench_dir / "kinds" / f"{kind}.py",
                 f"benchmark.kinds.{kind}")


def metric_reader(cell: Cell, name: str):
    for stem in (name, name.split(".", 1)[0]):
        path = cell.bench_dir / "metrics" / f"{stem}.py"
        if path.exists():
            return _load(path, f"benchmark.metrics.{stem}").read
    raise FileNotFoundError(f"no reader metrics/{name}.py for {name}")


def launch_counts() -> dict:
    """Launches the program's kernel wrappers have counted, by family."""
    out = {}
    for fam, (wrappers, _) in roofline.FAMILIES.items():
        n = 0
        for qual in wrappers:
            mod, fn = qual.split(".")
            n += getattr(importlib.import_module(f"{PROGRAM}.ops.{mod}"),
                         fn).launches
        out[fam] = n
    return out


def window_metric(name: str, setup_s: float, window_s: float,
                  done_bytes: int, latencies) -> float:
    """An end-to-end metric by its name (see the module docstring)."""
    if name == "setup_s":
        return setup_s
    if name.endswith("_GBps"):
        return done_bytes / window_s / 1e9
    m = re.fullmatch(r".+_p(\d+)_ms", name)
    if m:
        return float(np.percentile(np.asarray(latencies) * 1e3,
                                   int(m.group(1))))
    raise KeyError(f"no rule for the end-to-end metric {name!r}")


class _Keep:
    """Which requests' answers are kept for the check: the window's first,
    and each later one with probability ``share``, drawn from the seed."""

    def __init__(self, seed: int, share: float):
        self.rng = np.random.default_rng([seed % (1 << 64), 0x6B656570])
        self.share = share
        self.first = None

    def __call__(self, i: int) -> bool:
        draw = self.rng.random() < self.share
        if self.first is None:
            self.first = i
            return True
        return draw


def _sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def run_cell(run: Run, seconds: float, trace: bool,
             started: "float | None" = None, stages: "dict | None" = None,
             log=sys.stderr) -> dict:
    """Run the cell once; returns the result line's object.

    ``started``: the ``time.perf_counter()`` reading the set-up time runs
    from (default: the call); ``stages``: set-up steps the caller timed
    from it, for the notes.  Raises :class:`RunRefused` where no result
    may be printed."""
    import torch

    started = time.perf_counter() if started is None else started
    cell, dev = run.cell, run.device
    stages = {**(stages or {}), "harness_s": time.perf_counter() - started}
    work = kind_module(cell).Work(run)
    work.prepare()
    _sync(dev)
    stages["data_and_reference_s"] = time.perf_counter() - started
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    work.start()
    stages["program_s"] = time.perf_counter() - started
    i = 0
    for _ in range(WARM_REQUESTS):
        work.request(i)
        i += 1
    _sync(dev)

    lat, kept, probes = [], {}, {}
    failed = done_bytes = 0
    keep = _Keep(run.seed, float(cell.traffic.get("keep_share", 1.0)))
    view = None
    n_trace = TRACE_REQUESTS if trace else 0

    def one(i):
        """Request i, timed: (its answer or None, the time it ended)."""
        nonlocal failed
        a = time.perf_counter()
        try:
            out = work.request(i)
        except Exception:               # the loop goes on; the run fails
            if not failed:
                traceback.print_exc(file=log)
            failed += 1
            out = None
        b = time.perf_counter()
        lat.append(b - a)
        return out, b

    def record(i, out):
        """Count request i's bytes and keep its answer, or its probe."""
        nonlocal done_bytes
        if out is None:
            return
        done_bytes += work.raw_bytes(i)
        if keep(i):
            kept[i] = out
        else:
            probes[i] = work.probe(i, out)

    reference_s = float(getattr(work, "reference_s", 0.0))
    stages["reference_s"] = reference_s
    stages["warm_s"] = time.perf_counter() - started
    setup_s = stages["warm_s"] - reference_s
    t0 = t_end = time.perf_counter()
    while True:
        now = time.perf_counter()
        if n_trace and view is None and now - t0 >= seconds / 2:
            view = _traced(run, work, one, record, i, n_trace)
            i += n_trace
            t_end = time.perf_counter()
            continue
        if now - t0 >= seconds:
            break
        out, t_end = one(i)
        record(i, out)
        i += 1
    window_s = t_end - t0
    # mean request ms in each quarter of the window's requests
    quarters = [float(q.mean()) * 1e3 if len(q) else None
                for q in np.array_split(np.asarray(lat), 4)]
    peak = (int(torch.cuda.max_memory_allocated(dev))
            if dev.type == "cuda" else 0)
    work.stop()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, info = work.check(kept, probes)

    attempted = len(lat)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(cell, m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {
                "value": window_metric(m["name"], setup_s, window_s,
                                       done_bytes, lat),
                "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else dev.type),
              "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(
        failed == 0 and attempted > 0 and kept
        and all(v <= lim for v, lim in checks.values())),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": device}
    if trace:
        device["busy_s"] = view.trace.busy_s()
        device["window_s"] = view.trace.window_s
        result["breakdown"] = {"device_ops": view.trace.device_ops(),
                               "idle_gaps": view.trace.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    notes = {"workload": cell.name, "seed": run.seed,
             "program": run.program, "requests_kept": len(kept),
             "requests_probed": len(probes), "window_s": window_s,
             "setup_s": setup_s, "setup_by_step_s": stages,
             "ms_by_quarter": quarters, **info}
    bad = forbidden_modules()           # last: after the readers and check
    if bad:
        raise RunRefused(f"forbidden modules loaded: {', '.join(bad)}")
    print(json.dumps({"notes": notes}), file=log)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=log)
    return result


def _traced(run: Run, work, one, record, i0: int, n: int) -> TraceView:
    """``n`` requests from ``i0`` under the profiler; a kernel family
    whose launches the program counted must show each of them in the
    trace.  Only the requests themselves lie inside the request span."""
    import torch

    dev = run.device
    counts0 = launch_counts()
    kbytes: "dict[str, int]" = {}
    batches = 0
    with tracing.profile(dev) as box:
        for i in range(i0, i0 + n):
            with torch.profiler.record_function(tracing.REQUEST_SPAN):
                out, _ = one(i)
            record(i, out)
            if out is not None:
                for fam, b in work.kernel_bytes(i, out).items():
                    kbytes[fam] = kbytes.get(fam, 0) + b
            batches += work.batches(i)
    trace = box[0]
    counts1 = launch_counts()
    launches = {f: counts1[f] - counts0[f] for f in counts0}
    for fam, n_launch in launches.items():
        seen = trace.count("kernel", family=fam)
        if n_launch and seen != n_launch:
            raise RunRefused(
                f"trace incomplete: {fam} launched {n_launch} times, the "
                f"profile holds {seen} of its kernels")
    hbm = (roofline.HBM_BYTES_PER_S.get(torch.cuda.get_device_name(dev))
           if dev.type == "cuda" else None)
    return TraceView(trace, batches, kbytes, launches, hbm)
