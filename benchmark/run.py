"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the port
(``airs_compression_tpu_torch``).  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit (also the last lines of standard
error).  Exits 2 without a result where CUDA is absent or has fewer
cards than the cell asks for, and 3 where a module of JAX or of the JAX
package was loaded or the trace lost kernel records.
"""

from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

# one client process with few threads: no host thread pools beyond one
# (set before numpy and torch load; a value given by the caller stands)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

# the checkout's root, for the program and this package (instead of the
# script's own directory)
sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    age = harness.process_age_s()
    started = _STARTED - age if age is not None else _STARTED

    stages = {"imported_s": time.perf_counter() - started}
    cell = harness.resolve(harness.load_spec(), args.workload)
    import torch
    available = torch.cuda.is_available()
    stages["cuda_init_s"] = time.perf_counter() - started
    if not available:
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    run = harness.Run(cell, args.seed, torch.device("cuda", 0))
    try:
        result = harness.run_cell(run, args.seconds, bool(args.trace),
                                  started=started, stages=stages)
    except harness.RunRefused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
