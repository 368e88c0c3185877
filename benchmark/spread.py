"""Run one cell several times, one process a run, and report the spread of
each metric: what a bound is set from.

    python3 benchmark/spread.py --workload <cell> --seconds <s> \\
        --seeds 1 2 3 4 5 6 [--sets 2] [--trace 0] [--warm 1] [--out DIR]

Each set runs ``benchmark/run.py`` once for each seed, in order; every set
uses the same seeds.  ``--warm`` runs first with seed 0 and are not
counted (the first run in a checkout builds the kernels).  The spread of
a metric in a set is the distance between its first and third quartile
(``statistics.quantiles(values, n=4)``) over its median.  Prints one JSON
line a run and one a set; with ``--out``, each run's standard output and
error go to files there.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

RUN = pathlib.Path(__file__).resolve().parent / "run.py"


def one(args, seed: int, out: "pathlib.Path | None", tag: str) -> dict:
    cmd = [sys.executable, str(RUN), "--workload", args.workload, "--seed",
           str(seed), "--seconds", str(args.seconds), "--trace",
           str(args.trace)]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=args.timeout)
    wall = time.perf_counter() - t
    if out is not None:
        (out / f"{tag}.out").write_text(proc.stdout)
        (out / f"{tag}.err").write_text(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"tag": tag, "seed": seed, "rc": proc.returncode, "wall_s": wall,
            "result": result,
            "stderr_tail": proc.stderr[-600:] if proc.returncode or
            not (result or {}).get("correct") else None}


def spread(values) -> "tuple[float, float]":
    """(median, (q3 - q1) / median)."""
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, ((q3 - q1) / med if med else float("nan"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--warm", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    out = None
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
    for w in range(args.warm):
        print(json.dumps(one(args, 0, out, f"warm{w}")), flush=True)
    ok = True
    for s in range(args.sets):
        runs = [one(args, seed, out, f"set{s}_seed{seed}")
                for seed in args.seeds]
        for r in runs:
            print(json.dumps(r), flush=True)
        good = [r["result"] for r in runs if r["result"]]
        ok &= all(r["rc"] == 0 and r["result"] and r["result"]["correct"]
                  for r in runs)
        summary = {}
        for name in (good[0]["metrics"] if good else {}):
            vals = [g["metrics"][name]["value"] for g in good
                    if name in g["metrics"]]
            if len(vals) >= 2:
                med, spr = spread(vals)
                summary[name] = {"median": med, "spread": spr,
                                 "min": min(vals), "max": max(vals),
                                 "n": len(vals)}
        print(json.dumps({"set": s, "workload": args.workload,
                          "all_correct": ok, "metrics": summary}),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
