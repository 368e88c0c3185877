"""Readings that the limits of ``correct`` are set from, in one process.

    python3 benchmark/control.py --workload <cell> --seconds <s> \\
        --seeds 1 2 3 --programs port control fault.answer_altered

For each program and seed, a run of the cell at its own size and load
(``--seconds`` long, no trace) with that program in the timed path:
``port`` the program, ``control`` the plain reference at the precision
below the configuration's (each sample's lowest bit dropped), and the
request kind's ``fault.*`` programs (see ``kinds/``).  Prints one JSON
line a run: the numbers compared and ``correct``.  The benchmark's own
runs (``run.py``) never run anything but ``port``.
"""

from __future__ import annotations

import argparse
import io
import json
import pathlib
import sys

sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--programs", nargs="+", default=["port", "control"])
    ap.add_argument("--keep-share", type=float,
                    help="share of requests compared (default: the mix's)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    for program in args.programs:
        for seed in args.seeds:
            cell = harness.resolve(spec, args.workload)
            if args.keep_share is not None:
                cell.traffic["keep_share"] = args.keep_share
            log = io.StringIO()
            res = harness.run_cell(harness.Run(cell, seed, dev, program),
                                   args.seconds, False, log=log)
            notes = [json.loads(line)["notes"]
                     for line in log.getvalue().splitlines()
                     if line.startswith('{"notes"')]
            print(json.dumps({
                "workload": cell.name, "program": program, "seed": seed,
                "correct": res["correct"], "attempted": res["attempted"],
                "failed": res["failed"], "checks": res["checks"],
                "notes": notes[0] if notes else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
