"""One rank of the port's multi-rank tier, run by tests/test_torch_parallel.py.

Usage: torch_parallel_worker.py <rank> <world_size> <store_file> <out_dir>

Each rank joins a gloo process group (a ``FileStore``), makes its mesh
with ``device="cpu"`` (the kernels' plain versions) and runs every
scenario of the test on its own rows or its own part of the stream:

* dp — the headline pass, then the flagship chain over four passes through
  ``ShardedBatchState`` with one block that falls back (encode and decode);
* gather — ``allgather_sizes``, ``StreamManifest``, a shard file per rank
  from ``gather.assemble_stream``, spliced on rank 0;
* sp — ``compress_long_stream`` for DIFF + ZERO with checksums, IWT and a
  MODEL secondary pass, the chunked encoder over several configurations,
  ``LongStreamCompressor`` chains, and the refused inputs.

It writes what it got to ``<out_dir>/rank<r>.pkl`` for the test to hold
against the JAX package.  It imports only torch, numpy and the port, and
defines the scenarios' data (from numpy seeds) for the test to share.
"""

from __future__ import annotations

import pathlib
import pickle
import sys

import numpy as np

B, N = 16, 256           # the dp batch: 4 rows a rank
FALLBACK_BLOCK = 6       # a block of noise: it falls back (rank 1's rows)
SP_N = 4096              # one stream: 1024 samples a rank
SP_CHUNK = 1024
CHAIN_N = 1024
WORLD = 4

HEADLINE = dict(primary_preprocessing=1, primary_encoder_type=1,
                primary_encoder_param=4)
HEADLINE_CS = dict(HEADLINE, checksum_enabled=True)
FLAGSHIP = dict(HEADLINE_CS, secondary_iterations=15,
                secondary_preprocessing=3, secondary_encoder_type=2,
                secondary_encoder_param=2, secondary_encoder_outlier=40,
                model_rate=8, uncompressed_fallback_enabled=True)
FALLBACK = dict(primary_preprocessing=0, primary_encoder_type=0,
                checksum_enabled=True)

# one-shot cases: params, identifier, sequence number, secondary, model
SP_CASES = {
    "diff_cs": (HEADLINE_CS, 77, 3, False),
    "iwt": (dict(primary_preprocessing=2, primary_encoder_type=1,
                 primary_encoder_param=2, checksum_enabled=True), 78, 0,
            False),
    "model_secondary": (FLAGSHIP, 79, 1, True),
}
# chunked-encoder cases: params, secondary, device chunks
CHUNKED_CASES = {
    "diff_cs": (HEADLINE_CS, False, False),
    "diff_g1": (dict(HEADLINE, primary_encoder_param=1), False, True),
    "none_multi": (dict(primary_preprocessing=0, primary_encoder_type=2,
                        primary_encoder_param=3,
                        primary_encoder_outlier=40, checksum_enabled=True),
                   False, False),
    "model_secondary": (FLAGSHIP, True, False),
}
CHAINS = {
    "model": FLAGSHIP,
    "iwt": dict(primary_preprocessing=2, primary_encoder_type=1,
                primary_encoder_param=4, secondary_iterations=2,
                secondary_preprocessing=2, secondary_encoder_type=1,
                secondary_encoder_param=2, checksum_enabled=True),
    "fallback": dict(primary_preprocessing=1, primary_encoder_type=1,
                     primary_encoder_param=1,
                     uncompressed_fallback_enabled=True,
                     secondary_iterations=2, secondary_preprocessing=3,
                     secondary_encoder_type=1, secondary_encoder_param=1,
                     model_rate=4, checksum_enabled=True),
}


def dp_frames(p: int) -> np.ndarray:
    """Pass ``p``'s (B, N) u16 frames; block FALLBACK_BLOCK is noise."""
    rng = np.random.default_rng(100 + p)
    f = ((1100 + rng.normal(0, 6, (B, N))).astype(np.int64)
         & 0xFFFF).astype(np.uint16)
    f[FALLBACK_BLOCK] = rng.integers(0, 1 << 16, N).astype(np.uint16)
    return f


def dp_ids(p: int):
    """Pass ``p``'s per-block identifier halves (id_hi, id_lo) and seq."""
    ids = (np.arange(B, dtype=np.int64) + 1000 * p + 1) * 0x10001
    return (ids >> 24) & 0xFFFFFF, ids & 0xFFFFFF, np.full(B, p, np.int32)


def stream(seed: int, n: int, sigma: float = 9.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((1100 + rng.normal(0, sigma, n)).astype(np.int64)
            & 0xFFFF).astype(np.uint16)


def sp_model(n: int) -> np.ndarray:
    return stream(5, n).view(np.int16)


def chain_frames(name: str) -> "list[np.ndarray]":
    """Six frames of a chain, a noise frame in the middle (the fallback
    resets the chain)."""
    rng = np.random.default_rng(12)
    base = 1100 + rng.normal(0, 3000 if name == "fallback" else 9, CHAIN_N)
    frames = [((base + rng.normal(0, 3, CHAIN_N)).astype(np.int64) & 0xFFFF)
              .astype(np.uint16) for _ in range(6)]
    frames[3] = rng.integers(0, 1 << 16, CHAIN_N).astype(np.uint16)
    return frames


class Stamp:
    """Deterministic timestamp source, so every run draws the same ids."""

    def __init__(self, start: int = 0):
        self.counter = start

    def __call__(self):
        c = self.counter
        self.counter += 1
        return (c >> 16) & 0xFFFFFFFF, c & 0xFFFF


def part(a: np.ndarray, rank: int, world: int = WORLD) -> np.ndarray:
    """Rank ``rank``'s contiguous part of the last axis."""
    k = a.shape[-1] // world
    return a[..., rank * k: (rank + 1) * k]


def _code(fn):
    from airs_compression_tpu_torch import CmpError

    try:
        fn()
    except CmpError as e:
        return int(e.code)
    return None


def _dp(mesh, out, tmp: pathlib.Path) -> None:
    import torch

    from airs_compression_tpu_torch import params_from_reference as tparams
    from airs_compression_tpu_torch.ops.encode import (
        make_pass_config,
        worst_case_words,
    )
    from airs_compression_tpu_torch.ops.xxh32_device import (
        checksum_blocks_device,
    )
    from airs_compression_tpu_torch.parallel import dp, gather

    def np_(t):
        return t.cpu().numpy()

    # the headline pass
    cfg = make_pass_config(tparams(HEADLINE), False)
    nw = worst_case_words(cfg, N)
    x = dp_frames(0).view(np.int16)
    id_hi, id_lo, seq = dp_ids(0)
    ops = dp.place_encode_operands(mesh, x, x, seq, id_hi, id_lo,
                                   np.zeros(B, np.int64))
    words, sizes, fell = dp.encode_blocks_sharded(mesh, cfg, None, *ops, nw)
    samples, end = dp.decode_blocks_sharded(mesh, cfg, words, ops[1], N)
    out["dp_headline"] = dict(words=np_(words), sizes=np_(sizes),
                              fell=np_(fell), samples=np_(samples),
                              end=np_(end))

    # the gather: sizes, manifest, one shard a rank, the splice on rank 0
    local_sizes = np_(sizes)
    sizes_all = gather.allgather_sizes(local_sizes, mesh)
    manifest = gather.StreamManifest([B // mesh.size] * mesh.size,
                                     sizes_all)
    (tmp / f"shard_{mesh.rank}.bin").write_bytes(
        gather.assemble_stream(words, sizes))
    mesh.barrier()
    out["sizes_all"] = sizes_all
    out["sizes_all_default_group"] = gather.allgather_sizes(local_sizes)
    if mesh.rank == 0:
        shards = [(tmp / f"shard_{p}.bin").read_bytes()
                  for p in range(mesh.size)]
        offsets = [0] * mesh.size
        spliced = bytearray()
        for p, _j, size in manifest.global_order():
            spliced += shards[p][offsets[p]: offsets[p] + size]
            offsets[p] += size
        out["spliced"] = bytes(spliced)
        out["total_bytes"] = manifest.total_bytes

    # the flagship chain: 4 passes through ShardedBatchState, checksums
    params = tparams(FLAGSHIP)
    fb_cfg = make_pass_config(tparams(FALLBACK), False)
    state = dp.ShardedBatchState(mesh, B, N)
    chain = []
    for p in range(4):
        cfg = make_pass_config(params, p > 0)
        nw = worst_case_words(make_pass_config(params, True), N)
        x = dp_frames(p).view(np.int16)
        id_hi, id_lo, seq = dp_ids(p)
        rows = dp.block_sharding(mesh).rows(B)
        xr = torch.from_numpy(x[rows].astype(np.int32))
        words, sizes, fell = dp.encode_blocks_sharded(
            mesh, cfg, fb_cfg, xr, state.model, seq[rows], id_hi[rows],
            id_lo[rows], checksum_blocks_device(xr), nw)
        dec, end = dp.decode_blocks_sharded(mesh, cfg, words, state.model, N)
        fdec, fend = dp.decode_blocks_sharded(mesh, fb_cfg, words,
                                              state.model, N)
        samples = torch.where(fell[:, None], fdec, dec)
        end = torch.where(fell, fend, end)
        state.update(xr, seq[rows], fell, params.model_rate, True)
        chain.append(dict(words=np_(words), sizes=np_(sizes),
                          fell=np_(fell), samples=np_(samples), end=np_(end),
                          model=np_(state.model)))
    out["dp_chain"] = chain
    # a state seeded from the whole batch's model takes the rank's rows
    seeded = dp.ShardedBatchState(mesh, B, N, model=dp_frames(9)
                                  .view(np.int16))
    out["seeded_model"] = np_(seeded.model)


def _sp(mesh, out) -> None:
    import torch

    import airs_compression_tpu_torch as tx
    from airs_compression_tpu_torch import params_from_reference as tparams
    from airs_compression_tpu_torch.parallel import sp

    r, w = mesh.rank, mesh.size
    x = stream(6, SP_N)
    model = sp_model(SP_N)
    for name, (pd, ident, seq, secondary) in SP_CASES.items():
        out[f"sp_{name}"] = sp.compress_long_stream(
            tparams(pd), part(x, r, w), ident, seq,
            part(model, r, w) if secondary else None, secondary, mesh=mesh)

    for name, (pd, secondary, on_device) in CHUNKED_CASES.items():
        enc = sp.ChunkedLongStreamEncoder(tparams(pd), SP_N, SP_CHUNK,
                                          identifier=21, sequence_number=1,
                                          secondary=secondary, mesh=mesh)
        pieces = part(x.reshape(-1, SP_CHUNK), r, w)
        mp = (part(model.reshape(-1, SP_CHUNK), r, w)
              if secondary else [None] * len(pieces))
        feed = ((lambda v: torch.from_numpy(v.astype(np.int32)))
                if on_device else (lambda v: v))
        enc.feed(feed(pieces[0]), mp[0])
        enc.feed_many(feed(pieces[1:]), None if mp[1] is None else mp[1:])
        out[f"chunked_{name}"] = enc.finish()

    for name, pd in CHAINS.items():
        tx.set_timestamp_func(Stamp())
        try:
            lsc = sp.LongStreamCompressor(tparams(pd), mesh=mesh)
            frames = [lsc.compress(part(f, r, w)) for f in chain_frames(name)]
        finally:
            tx.set_timestamp_func(None)
        out[f"chain_{name}"] = dict(frames=frames, seq=lsc.seq,
                                    identifier=lsc.identifier,
                                    model=(None if lsc.model is None
                                           else lsc.model.cpu().numpy()))

    # refused inputs: an uneven split, an IWT part that is not a power of
    # two, a chunk that does not split over the ranks
    iwt = tparams(SP_CASES["iwt"][0])
    uneven = np.array_split(stream(7, 4097), w)[r]
    out["errors"] = {
        "uneven": _code(lambda: sp.compress_long_stream(
            tparams(HEADLINE_CS), uneven, mesh=mesh)),
        "iwt_not_pow2": _code(lambda: sp.compress_long_stream(
            iwt, part(stream(8, 3072), r, w), mesh=mesh)),
        "chunk_not_dividing": _code(lambda: sp.ChunkedLongStreamEncoder(
            tparams(HEADLINE_CS), SP_N, 1022, mesh=mesh)),
    }


def main(argv) -> None:
    rank, world = int(argv[1]), int(argv[2])
    store_file, out_dir = argv[3], pathlib.Path(argv[4])
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

    import torch
    import torch.distributed as dist

    from airs_compression_tpu_torch.parallel.mesh import (
        make_mesh,
        multihost_initialize,
    )

    torch.set_num_threads(1)
    multihost_initialize(backend="gloo", timeout=60.0,
                         store=dist.FileStore(store_file, world),
                         rank=rank, world_size=world)
    try:
        out = {}
        _dp(make_mesh(world, "dp", device="cpu"), out, out_dir)
        _sp(make_mesh(world, "sp", device="cpu"), out)
        with open(out_dir / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
