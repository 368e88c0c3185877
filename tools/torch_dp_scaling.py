"""Measured data-parallel scaling of the PyTorch port over ranks.

Weak scaling, as ``tools/dp_scaling.py`` measures it for the JAX package:
each rank encodes a fixed batch of B0 blocks of N samples a step
(``parallel/dp.encode_blocks_sharded``, kernels K4 and K1), so the global
batch grows with the ranks; ideal scaling keeps the step time flat, and
the efficiency is T(1) / T(d).  Every rank checks the frames of its
first, untimed step against the one-process encode of the whole batch
(``ops/encode.encode_blocks_device`` on its device).  A second curve keeps the TOTAL
work fixed (B0 times the largest mesh, split over the ranks), and each
point also counts the collectives one sharded step makes (block-DP must
make none, so sharding can add only per-step overhead) and measures that
overhead as the step's floor at near-zero work (one block of 128 samples
a rank).

The port runs one process a rank on ``torch.distributed``: this tool
starts each mesh size's ranks as processes of their own (gloo, a
``FileStore`` in a temporary directory; ``--backend nccl`` with one card a
rank, refused with exit code 2 where a mesh has more ranks than there are
cards, since NCCL cannot put two ranks on one card).  Rank r uses card
``r % count``, so under gloo on one card the ranks share it and the
curves measure the sharing, not a speedup.  Each rank also reports the
time of its reference encode and comparison (``ref_ms``) and, on a card,
its peak device memory (``peak_mib``).

    python tools/torch_dp_scaling.py [--sizes 1 2 4] [--blocks 256]
        [--samples 8192] [--steps 10] [--device cuda] [--backend gloo]

Prints one row per mesh size and curve and a final JSON line.
"""

import argparse
import contextlib
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(_REPO))

# the torch.distributed calls a step could make, counted by collective_count
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "broadcast", "gather", "scatter",
               "reduce", "reduce_scatter", "reduce_scatter_tensor",
               "all_to_all", "all_to_all_single", "send", "recv", "isend",
               "irecv", "batch_isend_irecv")


def frames(rows: int, n: int) -> np.ndarray:
    """The global batch: detector-like u16 frames, the same for every mesh
    that splits ``rows`` rows."""
    rng = np.random.default_rng(rows)
    return ((1100 + rng.normal(0, 6, (rows, n))).astype(np.int64)
            & 0xFFFF).astype(np.uint16)


def _sharded_step(mesh, cfg, x: np.ndarray):
    """One sharded encode step (K4 checksums, then K1) over the global
    batch ``x``, its operands placed on the rank once."""
    from airs_compression_tpu_torch.ops.encode import worst_case_words
    from airs_compression_tpu_torch.ops.xxh32_device import (
        checksum_blocks_device,
    )
    from airs_compression_tpu_torch.parallel import dp

    nw = worst_case_words(cfg, x.shape[1])
    zeros = np.zeros(x.shape[0], np.int64)
    ops = dp.place_encode_operands(mesh, x, x, zeros.astype(np.int32),
                                   zeros, zeros, zeros)

    def step():
        cs = checksum_blocks_device(ops[0])
        return dp.encode_blocks_sharded(mesh, cfg, None, ops[0], ops[1],
                                        ops[2], ops[3], ops[4], cs, nw)
    return step


def _timed(mesh, step, reps: int) -> "list[float]":
    """Milliseconds of each of ``reps`` steps, the ranks in step: a
    barrier, then the step until its sizes are on the host."""
    import torch

    times = []
    for _ in range(reps):
        mesh.barrier()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t = time.perf_counter()
        step()[1].cpu()  # the sizes' fetch waits for the step
        times.append(1e3 * (time.perf_counter() - t))
    return times


def measure(mesh, cfg, x: np.ndarray, reps: int):
    """Step times (ms) of the sharded encode over ``mesh`` with operands
    placed once (the steady-state pattern), after one untimed step whose
    (words, sizes) are returned for the correctness check."""
    step = _sharded_step(mesh, cfg, x)
    words, sizes, _ = step()
    return _timed(mesh, step, reps), words, sizes


def collective_count(mesh, cfg, x: np.ndarray) -> "dict[str, int]":
    """The ``torch.distributed`` calls one sharded step makes, by name
    (only those made).  Block-DP is embarrassingly parallel: the step
    must make none, so sharding can add only per-step overhead, never
    communication."""
    import torch.distributed as dist

    step = _sharded_step(mesh, cfg, x)
    step()  # warm
    mesh.barrier()  # an all_gather of the tool's own, not the step's
    made: "dict[str, int]" = {}

    def counting(name, fn):
        def call(*args, **kwargs):
            made[name] = made.get(name, 0) + 1
            return fn(*args, **kwargs)
        return call
    with contextlib.ExitStack() as undo:
        for name in COLLECTIVES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            setattr(dist, name, counting(name, fn))
            undo.callback(setattr, dist, name, fn)
        step()[1].cpu()
    return made


def dispatch_floor(mesh, cfg, reps: int = 15) -> float:
    """Median ms of a sharded step at near-zero work (one block of 128
    samples a rank): the per-step overhead of the sharded path apart from
    its compute."""
    step = _sharded_step(mesh, cfg, np.zeros((mesh.size, 128), np.int16))
    step()
    return statistics.median(_timed(mesh, step, reps))


def rank_main(args) -> int:
    import torch
    import torch.distributed as dist

    import airs_compression_tpu_torch as tx
    from airs_compression_tpu_torch.ops.encode import (
        encode_blocks_device,
        make_pass_config,
        worst_case_words,
    )
    from airs_compression_tpu_torch.ops.xxh32_device import (
        checksum_blocks_device,
    )
    from airs_compression_tpu_torch.parallel.mesh import (
        make_mesh,
        multihost_initialize,
    )

    world, rank = args.world, args.rank
    multihost_initialize(backend=args.backend, timeout=300.0,
                         store=dist.FileStore(args.store, world),
                         world_size=world, rank=rank)
    mesh = make_mesh(world, "dp",
                     device=None if args.device == "cuda" else args.device)
    params = tx.CmpParams(primary_preprocessing=tx.Preprocessing.DIFF,
                          primary_encoder_type=tx.EncoderType.GOLOMB_ZERO,
                          primary_encoder_param=4, checksum_enabled=True)
    cfg = make_pass_config(params, False)
    n = args.samples
    x = frames(world * args.blocks, n).view(np.int16)
    times, words, sizes = measure(mesh, cfg, x, args.steps)

    # correctness: the rank's rows equal the one-process encode
    t = time.perf_counter()
    xa = torch.from_numpy(x).to(mesh.device).to(torch.int32)
    ids = torch.zeros(x.shape[0], dtype=torch.int64, device=mesh.device)
    ref_w, ref_s, _ = encode_blocks_device(
        cfg, None, xa, xa, ids.to(torch.int32), ids, ids,
        checksum_blocks_device(xa), worst_case_words(cfg, n))
    rows = slice(rank * args.blocks, (rank + 1) * args.blocks)
    ok = bool(torch.equal(sizes.cpu(), ref_s[rows].cpu())
              and torch.equal(words.cpu(), ref_w[rows].cpu()))
    ref_ms = 1e3 * (time.perf_counter() - t)
    peak = (torch.cuda.max_memory_allocated(mesh.device) / 2**20
            if mesh.device.type == "cuda" else None)
    pathlib.Path(args.out).write_text(json.dumps(
        {"rank": rank, "ok": ok, "ms": times,
         "collectives": collective_count(mesh, cfg, x),
         "dispatch_floor_ms": dispatch_floor(mesh, cfg),
         "ref_ms": ref_ms, "peak_mib": peak}))
    mesh.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


def run_size(args, world: int, blocks: int, tmp: pathlib.Path) -> dict:
    """Start ``world`` ranks, each encoding ``blocks`` blocks a step, with
    their store and reports in the fresh directory ``tmp``; the row of the
    curve from their reports."""
    store = tmp / "store"
    outs = [tmp / f"rank{r}.json" for r in range(world)]
    cmd = [sys.executable, __file__, "--device", args.device, "--backend",
           args.backend, "--blocks", str(blocks), "--samples",
           str(args.samples), "--steps", str(args.steps)]
    procs = [subprocess.Popen(cmd + ["--world", str(world), "--rank",
                                     str(r), "--store", str(store), "--out",
                                     str(outs[r])]) for r in range(world)]
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise SystemExit(f"mesh of {world}: rank exit codes {rcs}")
    ranks = [json.loads(o.read_text()) for o in outs]
    # a step ends when its slowest rank ends
    step_ms = [max(r["ms"][i] for r in ranks)
               for i in range(len(ranks[0]["ms"]))]
    collectives: "dict[str, int]" = {}
    for r in ranks:
        for k, v in r["collectives"].items():
            collectives[k] = collectives.get(k, 0) + v
    return {"ranks": world, "blocks": world * blocks,
            "step_ms_median": statistics.median(step_ms),
            "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
            "collectives": collectives,
            "dispatch_floor_ms": max(r["dispatch_floor_ms"] for r in ranks),
            "ref_ms": [r["ref_ms"] for r in ranks],
            "peak_mib": [r["peak_mib"] for r in ranks],
            "correct": all(r["ok"] for r in ranks)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--blocks", type=int, default=256)
    ap.add_argument("--samples", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo")
    for hidden in ("--world", "--rank"):
        ap.add_argument(hidden, type=int, help=argparse.SUPPRESS)
    for hidden in ("--store", "--out"):
        ap.add_argument(hidden, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    if args.backend == "nccl":
        import torch

        cards = torch.cuda.device_count()
        if max(args.sizes) > cards:
            print(f"--backend nccl runs one rank a card: a mesh of "
                  f"{max(args.sizes)} ranks needs {max(args.sizes)} cards, "
                  f"{cards} visible", file=sys.stderr)
            return 2
    total = args.blocks * max(args.sizes)
    curves = {"weak": [], "fixed_total": []}
    with tempfile.TemporaryDirectory() as tmp:
        for curve, per_rank in (("weak", lambda w: args.blocks),
                                ("fixed_total", lambda w: total // w)):
            for world in args.sizes:
                # a directory a mesh: a FileStore left by an earlier mesh
                # of the same shape would join the new ranks to stale keys
                run_dir = pathlib.Path(tmp) / f"{curve}-{world}"
                run_dir.mkdir()
                row = run_size(args, world, per_rank(world), run_dir)
                curves[curve].append(row)
                print(f"{curve} ranks={world:2d} blocks={row['blocks']:6d} "
                      f"step {row['step_ms_median']:.4f} ms (min "
                      f"{row['step_ms_min']:.4f}, max "
                      f"{row['step_ms_max']:.4f}) collectives="
                      f"{row['collectives'] or 0} floor "
                      f"{row['dispatch_floor_ms']:.4f} ms "
                      f"correct={row['correct']}", flush=True)
    base = curves["weak"][0]["step_ms_median"]
    for row in curves["weak"]:
        row["efficiency"] = base / row["step_ms_median"]
    base = curves["fixed_total"][0]["step_ms_median"]
    for row in curves["fixed_total"]:
        row["overhead_pct"] = 100.0 * (row["step_ms_median"] - base) / base
    rows = curves["weak"] + curves["fixed_total"]
    print(json.dumps({"metric": "torch_dp_scaling", "device": args.device,
                      "backend": args.backend, "rows": curves["weak"],
                      "fixed_total_rows": curves["fixed_total"],
                      "collective_free": not any(r["collectives"]
                                                 for r in rows)}))
    return 0 if all(r["correct"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
