#!/usr/bin/env python3
"""Smoke run of the PyTorch port (airs_compression_tpu_torch) on one CUDA card.

Run from the repository root, on a machine with an NVIDIA H100 and the CUDA
toolkit (``nvcc`` under ``$CUDA_HOME`` or ``/usr/local/cuda``):

    python3 chip_smoke.py

It builds the port's kernels from ``airs_compression_tpu_torch/csrc`` (one
``nvcc`` per source, in parallel) and then:

* phase A — the headline batch round trip (DIFF + GOLOMB_ZERO, g=4,
  B=512 blocks x N=8192 samples, data as bench.py:155-158) through
  ``BatchCompressor(device="cuda").compress_frames`` and
  ``BatchDecompressor(device="cuda").decompress_frames``;
* phase B — the flagship chain (__graft_entry__.py:21-34) with checksums,
  one primary and three secondary frames at the same B x N;
* phase D — the adaptive packed stream with the headline encoder
  (``adaptive=True``, the default ladder, widening-noise frames as
  bench.py:1744-1749) through ``compress_frames_packed``, decoded back with
  ``decompress_file_stream`` over one manifest of the four streams and with
  ``decompress_stream`` over ``stage_frames_at`` batches;
* phase E — the same with the flagship chain, adaptive and checksummed
  (MULTI secondary passes: 48-bit codes; XXH32 on both sides; the model
  carried on both sides);
* phase F — the port's CLI in-process on a 64 MiB + 2000-byte file of
  detector-like frames, the headline encoder with checksums: ``-c`` goes
  through ``compress_chunked`` (two batches of 2048 chunks of 8192
  samples, each one packed stream by K5, the tail on the host codec), the
  decompress through ``decompress_chunked`` (device-staged, K3 and K4);
* phase G — the long-stream tier (parallel/sp.py) on one stream of 2^22
  samples (8 MiB, the largest power of two under the header's limit),
  DIFF + GOLOMB_ZERO, g=4, checksums on: ``compress_long_stream`` (K1 in
  long-row mode, K4 over the one row), ``stream_chunk_index`` at 1024
  samples a chunk, ``decompress_long_stream`` (K3 in window mode, K4);
  a ``ChunkedLongStreamEncoder`` at 2^16 samples a chunk, 16 chunks by
  ``feed`` and 48 by ``feed_many`` in 3 calls (K2 in long-row mode, K4 in
  streaming mode); and a ``LongStreamCompressor`` chain of 3 frames under
  the IWT primary / MODEL secondary chain of __graft_entry__.py:175-183,
  held at 2^18 samples because it is decoded by the host decoder
  (``decompress``).  The frames must equal the port's batch path at B=1
  (``BatchCompressor.compress_frames``, whose K1 packs the row in one CTA)
  under the same identifiers, the chunked frame the one-shot frame, and
  every decode its input.  ``utils/profiling.StageTimer`` times each
  call, and a profiled encode and decode split them by step (the
  ``sp.*`` ranges, read by ``utils/profiling.range_times``); then
  ``examples/torch_long_stream.py`` and
  ``examples/torch_streaming_pipeline.py`` run at their default device
  (cuda), each in a process of its own, and must exit 0 with their own
  round-trip checks passing;
* phase H — the multi-rank tier (parallel/mesh.py, dp.py, gather.py and
  ``mesh=`` of parallel/sp.py) on the card: 4 ranks on ``cuda:0`` under
  gloo (a ``FileStore`` in a temporary directory, with a timeout), then 1
  rank under NCCL, each a spawned process running ``mesh_rank``.  dp:
  phase A's and B's batches at 128 rows a rank (``place_encode_operands``,
  ``encode_blocks_sharded`` with K4 checksums, ``decode_blocks_sharded``,
  the flagship chain's model in ``ShardedBatchState``) under the
  identifiers of those phases' frames; each rank's frames joined by K5
  (``gather.assemble_stream``) must equal its part of the phase's stream,
  ``allgather_sizes`` the phase's sizes, and rank 0's splice of the ranks'
  shard files (``StreamManifest``) the whole stream; every decode must
  give its rows back.  sp: phase G's stream at 2^20 samples a rank
  (``compress_long_stream(mesh=)``, the chunked encoder at 2^14 samples a
  rank of each chunk, the IWT/MODEL chain at 2^16 a rank), every frame
  equal to phase G's on rank 0; the XXH32 relay is also timed alone.
  Each rank prints one line: its launches (K1, K3, K4, K5 in dp; K1 and
  K2 long-row and K4 streamed in sp must be over 0), its ``StageTimer``
  times, the relay's and when it reached each point since its spawn;
* phase I — the coalesced decode and the native host core: nine
  headline batches (``make_frames`` seeds 40-48) and the same nine under
  the CLI's checksummed parameters, packed on the card
  (``compress_frames_packed``), decoded by ``decompress_file_stream`` over
  one manifest and by ``decompress_stream`` over ``stage_frames_at``
  stagings at ``coalesce`` False, 2 and True (groups of 1, 2 and 8, the
  last group of 2 and of 8 holding one batch), two rounds; every output
  must equal its input and the ``coalesce=False`` output, and each run
  must launch K3 (and K4 where checksummed) once a group: 9, 5 and 2
  times.  The flagship chain must refuse ``coalesce=True`` and decode
  batch by batch by default.  K3 at the coalesced shape (4096 rows) is
  held against its plain version and timed.  ``stage_frames``,
  ``stage_frames_at`` and ``stage_headers_at`` (native scatter and
  parse) must give the plain twin's columns and rows, each timed on the
  host; a ``CmpContext`` round trip of one 2^21-sample block runs through
  the native core, and one of 2^18 samples through the native core and
  through the Python twins (``engine/host.pack_codes``,
  ``_decode_mapped_plain``, ``cmp_checksum``), which must give the same
  frame and samples;
* phase J — ``tools/torch_fuzz_soak.py``'s soak of the decode tier on the
  card for 30 s from a fixed seed: random configurations at the JAX
  tool's shapes, frames from the port's ``CmpContext``, one frame a batch
  mutated (bit flip, truncation, garbage tail), each batch decoded by
  ``BatchDecompressor(device="cuda").decompress_frames`` and three
  batches by ``decompress_stream(coalesce=g)``, held against the host
  decoder (``engine/host.decode_block``): equal samples where it decodes,
  a refusal where it refuses.  It must find no mismatch and launch K3,
  and K4 where a case was checksummed.  Then ``tools/torch_build_docs.py``
  writes one page a module of the port into a temporary directory, with
  no JAX imported;
* phase K — every entry point of the port that no phase above drives on
  the card, each in a process of its own from the repository root, at
  its default device (cuda), under a timeout, and each held to its own
  checks: ``examples/torch_simple_compression.py``,
  ``examples/torch_device_pipeline.py``,
  ``tools/torch_verify_on_device.py`` at its defaults and at B x N (0
  failures: every frame byte-identical to the host codec), run through a
  shim that prints the kernel wrappers' launch counts as the script
  exits (each must launch its kernels);
  ``examples/torch_distributed_compression.py`` (4 gloo ranks on the
  card); ``tools/torch_dp_scaling.py --sizes 1 2 4 --steps 5`` (gloo on
  the card; every row correct, no collective in a step);
  ``tools/torch_cli_throughput.py`` (256 MiB; streams equal, decodes
  exact; GB/s printed); ``python -m airs_compression_tpu_torch.cli``
  through the shim on a 48 MiB + 2000-byte file (``-c``: K1, K5, K4;
  ``-d``: K3, K4) and a 2 MiB file (the host codec), each restored file
  equal to its input, and on the big stream with a payload byte flipped,
  which must exit with the in-process ``main``'s code; then, in this
  process, checkpoint resume: the flagship chain at B x N saved after
  frame 2 and resumed by a fresh ``BatchCompressor`` and
  ``BatchDecompressor`` (frames 3-5 byte-equal to the unbroken chain's,
  decodes exact, models int32 on the card), and a ``CmpContext`` at 2^18
  samples resumed through ``save_context`` / ``load_context``;
* phase C — each kernel (K1 pack_residuals, K2 pack_codes, K3
  decode_blocks, K4 xxh32_blocks, K5 assemble_stream, and the adaptive
  choice's select_params) against its plain PyTorch version on the card,
  on the phases' inputs and at small odd shapes, with CUDA-event times,
  and a corrupt batch and a corrupt stream
  that must raise ``CmpError``.  K3 is also held on valid, truncated,
  junk, all-ones and all-zero rows under every encoder with per-block g
  from 1 to 0xFFFF, at B=1, N=1 and N=7, on a misaligned row matrix, on
  rows wider than a CTA's shared memory and on the lanes outside a method
  group.  K4 is held at N from 1 to 8192 across the stripe boundaries,
  B from 1 to 512, and on misaligned rows.  K1 and K2 are held at N from 1
  to 8193 across the tile and 16-byte boundaries, B from 1 to 512, every
  encoder with g a power of two and not (K1), codes to 29, 48 and 64 bits
  and lengths over the maximum (K2), on matrices 4 bytes past a 16-byte
  boundary and on rows of 60,000 payload words; both are also timed on
  the MULTI codes (phase B's residuals, phase E's codes).  K5 is held on
  frames of 0-20 bytes at every offset mod 16, runs of frames under 4
  bytes, 4W-byte frames, int64 and int32 words, row views off alignment,
  B = 0, 1 and 65,537, ``total`` given and not, and timed on the int64
  words the encoder hands it in phases D and F (and on int32 bits).  The
  adaptive choice (``csrc/adapt.cu``) is held, for every block's
  parameter, outlier and bits, on phase D's DIFF residuals (ZERO) and
  phase E's MODEL residuals (MULTI) at 512 x 8192, in the fast window and
  over the whole ladder.  The
  long-stream modes are held on phase G's inputs and on edge cases: K1/K2
  long-row with no codes, rows shorter than a tile, one row, rows of 50,
  1000 and 8191 codes, rows wider than a cluster's CTAs take in one round
  (9000, 16384 and 40000 codes), rows of zero-length codes, tiles ending
  on a word boundary, start bits 0, 1, 31 and 32 with header bits kept,
  arrays 4 bytes past a 16-byte boundary, and over a thousand CTAs (more
  than the card holds at once); K3 windows at starts 0-63, near and past
  the stream's end, below 0, on junk words (also decoded as MULTI in
  100- and 400-word windows), 60,000 words wide, on the sidecar windows of a ZERO
  frame and of a MULTI frame with 48-bit escapes (in order, shuffled,
  duplicated, one window, 13 windows, among starts out of the stream, at
  chunks of 512 and 4096; ends on the sidecar's boundaries), under a lying
  sidecar and a payload cut short (which ``decompress_long_stream`` must
  refuse); K4 over one row
  on both sides of its path switch and of each long-path stage boundary,
  0, 4, 8 and 12 bytes past a 16-byte boundary, streamed in pieces that
  are not multiples of 8 samples and that straddle stages, and in
  streaming mode at 1, 3, 5 and as many rows as SMs and one more.

Every phase requires an exact round trip and frames (or streams)
byte-identical to the port's CPU path (the plain versions) on the same
input and identifiers; phases D and E also require the stream to equal the
joined ``compress_frames`` output and every size to equal its header's
``compressed_size``; phase F requires the restored file to equal the input
and the .air file to equal ``compress_frames`` over the same batches plus
the host tail under the same identifiers.  Each kernel of a phase must have been launched in
that phase's run (counts set to 0 just before it).  Any failed check exits
non-zero.  The last lines of standard output are the kernels' JSON line,
the card's name and power limit (nvidia-smi), and the result line.
Without a CUDA card it exits with code 2 and prints no result.

    python3 chip_smoke.py --mesh-cards

runs phases A, B and G on card 0, then phase H with one NCCL rank on
each visible card (rank r on ``cuda:r``) and
``tools/torch_dp_scaling.py --backend nccl --sizes 1 2 4``, one rank a
card, instead of the whole smoke run.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import importlib.util
import io
import json
import multiprocessing
import os
import pathlib
import queue as queue_mod
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

import airs_compression_tpu_torch as tx
from airs_compression_tpu_torch import _build, native
from airs_compression_tpu_torch.engine import host
from airs_compression_tpu_torch.models.stream import _bytes_to_be_words
from airs_compression_tpu_torch.ops import adapt, preprocess
from airs_compression_tpu_torch.ops.adapt import (
    select_params,
    select_params_plain,
)
from airs_compression_tpu_torch.ops.assemble import (
    assemble_stream,
    assemble_stream_plain,
)
from airs_compression_tpu_torch.ops.decode_kernel import (
    decode_blocks,
    decode_codes_plain,
    decode_windows,
    decode_windows_plain,
)
from airs_compression_tpu_torch.ops.encode import (
    PassConfig,
    adaptive_worst_bits,
    make_pass_config,
    worst_case_words,
)
from airs_compression_tpu_torch.ops import golomb
from airs_compression_tpu_torch.ops.pack import (
    ROW_CODES,
    code_words,
    pack_codes,
    pack_codes_at,
    pack_codes_at_plain,
    pack_codes_plain,
    pack_residuals,
    pack_residuals_at,
    pack_residuals_at_plain,
    pack_residuals_plain,
    row_starts,
)
from airs_compression_tpu_torch.ops.u32 import from_bits, to_bits
from airs_compression_tpu_torch.ops.xxh32_device import (
    LONG_MIN_SAMPLES,
    STAGE_STRIPES,
    StreamHasher,
    checksum_blocks_device,
    checksum_stream_device,
    xxh32_blocks,
    xxh32_lanes,
    xxh32_lanes_plain,
)
from airs_compression_tpu_torch.parallel import dp, gather, sp
from airs_compression_tpu_torch.parallel.mesh import (
    make_mesh,
    multihost_initialize,
)
from airs_compression_tpu_torch.utils.bits import derive_encoder_outlier
from airs_compression_tpu_torch.utils.profiling import StageTimer, range_times
from airs_compression_tpu_torch.utils.xxh32 import cmp_checksum

B, N = 512, 8192
CHUNK_BATCH = 2048  # models/chunked.py DEFAULT_BATCH, phase F's batch
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
TIMED_RUNS = 10
# SM cycles the card spins before a timed C entry (entry_ms): about 1 ms
# at the H100's clocks, longer than the host takes to queue the entry
BUSY_CYCLES = 2_000_000

HEADLINE = tx.CmpParams(primary_preprocessing=tx.Preprocessing.DIFF,
                        primary_encoder_type=tx.EncoderType.GOLOMB_ZERO,
                        primary_encoder_param=4)
FLAGSHIP_CS = tx.CmpParams(
    primary_preprocessing=tx.Preprocessing.DIFF,
    primary_encoder_type=tx.EncoderType.GOLOMB_ZERO,
    primary_encoder_param=4,
    secondary_iterations=15,
    secondary_preprocessing=tx.Preprocessing.MODEL,
    secondary_encoder_type=tx.EncoderType.GOLOMB_MULTI,
    secondary_encoder_param=2,
    secondary_encoder_outlier=40,
    model_rate=8,
    checksum_enabled=True)

# phase F: the CLI's headline parameters with checksums
CLI_PARAMS = tx.CmpParams(primary_preprocessing=tx.Preprocessing.DIFF,
                          primary_encoder_type=tx.EncoderType.GOLOMB_ZERO,
                          primary_encoder_param=4, checksum_enabled=True)

# name: (wrapper, source, TPU kernel it replaces, CUDA kernel's symbol)
KERNELS = {
    "pack_residuals": (pack_residuals, "airs_compression_tpu_torch/csrc/pack.cu",
                       "airs_compression_tpu/ops/pallas_pack.py:269",
                       "pack_kernel<(anonymous namespace)::ResidualCodes<"),
    "pack_codes": (pack_codes, "airs_compression_tpu_torch/csrc/pack.cu",
                   "airs_compression_tpu/ops/pallas_pack.py:256",
                   "pack_kernel<(anonymous namespace)::LoadedCodes<"),
    "decode_blocks": (decode_blocks, "airs_compression_tpu_torch/csrc/decode.cu",
                      "airs_compression_tpu/ops/pallas_decode.py:137",
                      "decode_blocks_kernel"),
    "xxh32_blocks": (checksum_blocks_device,
                     "airs_compression_tpu_torch/csrc/xxh32.cu",
                     "airs_compression_tpu/ops/xxh32_device.py:122",
                     "xxh32_blocks_kernel"),
    "assemble_stream": (assemble_stream,
                        "airs_compression_tpu_torch/csrc/assemble.cu",
                        "airs_compression_tpu/ops/pallas_assemble.py:47",
                        "assemble_kernel"),
    # the long-stream modes (phase G)
    "pack_residuals_at": (pack_residuals_at,
                          "airs_compression_tpu_torch/csrc/pack.cu",
                          "airs_compression_tpu/ops/pallas_pack.py:269",
                          "pack_long_kernel<(anonymous namespace)::"
                          "ResidualCodes<"),
    "pack_codes_at": (pack_codes_at, "airs_compression_tpu_torch/csrc/pack.cu",
                      "airs_compression_tpu/ops/pallas_pack.py:256",
                      "pack_long_kernel<(anonymous namespace)::LoadedCodes<"),
    "decode_windows": (decode_windows,
                       "airs_compression_tpu_torch/csrc/decode.cu",
                       "airs_compression_tpu/ops/pallas_decode.py:137",
                       "decode_windows_kernel"),
    "checksum_stream": (checksum_stream_device,
                        "airs_compression_tpu_torch/csrc/xxh32.cu",
                        "airs_compression_tpu/ops/xxh32_device.py:122",
                        "xxh32_long_kernel"),
    "xxh32_lanes": (xxh32_lanes, "airs_compression_tpu_torch/csrc/xxh32.cu",
                    "airs_compression_tpu/ops/xxh32_device.py:122",
                    "xxh32_long_kernel"),
    # the adaptive choice (phases D and E); the JAX package's is plain jnp
    "select_params": (select_params,
                      "airs_compression_tpu_torch/csrc/adapt.cu",
                      "none (plain jnp: airs_compression_tpu/ops/adapt.py)",
                      "adapt_select_kernel"),
}
LONG_KERNELS = ("pack_residuals_at", "pack_codes_at", "decode_windows",
                "checksum_stream", "xxh32_lanes")
# the long-row packers, whose launches are also counted by row count
LONG_ROW_KERNELS = ("pack_residuals_at", "pack_codes_at")

# phase G: one long stream, the sidecar's chunk, the chunked encoder's feed
LONG_N = 1 << 22
LONG_CHAIN_N = 1 << 18
SIDECAR_CHUNK = 1024
FEED_CHUNK = 1 << 16
LONG_RUNS = 3
# the ranges of one profiled one-shot encode and sidecar decode
LONG_STEPS = (
    "sp.encode.upload", "sp.encode.preprocess", "sp.encode.codes",
    "sp.encode.pack", "sp.encode.checksum", "sp.encode.fetch",
    "sp.decode.upload", "sp.decode.decode", "sp.decode.inverse",
    "sp.decode.checksum", "sp.decode.check", "sp.decode.fetch")
# the IWT primary / MODEL secondary chain of __graft_entry__.py:175-183
LONG_CHAIN = tx.CmpParams(primary_preprocessing=tx.Preprocessing.IWT,
                          primary_encoder_type=tx.EncoderType.GOLOMB_ZERO,
                          primary_encoder_param=4,
                          secondary_iterations=2,
                          secondary_preprocessing=tx.Preprocessing.MODEL,
                          secondary_encoder_type=tx.EncoderType.GOLOMB_ZERO,
                          secondary_encoder_param=2, model_rate=8,
                          checksum_enabled=True)


class _Stamp:
    """Deterministic timestamp source, so two runs draw the same ids."""

    def __init__(self, start: int = 0):
        self.counter = start

    def __call__(self):
        c = self.counter
        self.counter += 1
        return (c >> 16) & 0xFFFFFFFF, c & 0xFFFF


def make_frames(seed: int, b: int = B, n: int = N) -> np.ndarray:
    """Detector-like u16 frames, as bench.py:155-158."""
    rng = np.random.default_rng(seed)
    return ((1100 + rng.normal(0, 6, (b, n))).astype(np.int64)
            & 0xFFFF).astype(np.uint16)


def make_widening_frames(seed: int, spikes: bool = False) -> np.ndarray:
    """Widening noise across the batch, so the adaptive ladder really
    varies (bench.py:1744-1749: sigma = 0.7 * (1 + i % 12) in block i).
    ``spikes`` adds a few full-range samples per block (particle hits),
    which make MULTI escapes of up to 48 bits."""
    rng = np.random.default_rng(seed)
    sig = 1100 + rng.normal(0, 1, (B, N)) * (0.7 * (1 + np.arange(B) % 12)
                                             )[:, None]
    frames = (sig.astype(np.int64) & 0xFFFF).astype(np.uint16)
    if spikes:
        hits = rng.random((B, N)) < 1e-3
        frames[hits] = rng.integers(0, 1 << 16, int(hits.sum()))
    return frames


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def counts() -> "dict[str, int]":
    return {name: fn.launches for name, (fn, *_) in KERNELS.items()}


def row_counts() -> "dict[str, dict[int, int]]":
    """The long-row packers' launches by the launch's row count."""
    return {name: dict(KERNELS[name][0].launches_by_rows)
            for name in LONG_ROW_KERNELS}


def reset_counts() -> None:
    for fn, *_ in KERNELS.values():
        fn.launches = 0
    for name in LONG_ROW_KERNELS:
        KERNELS[name][0].launches_by_rows.clear()


def compress_all(params, batches, device):
    tx.set_timestamp_func(_Stamp())
    try:
        bc = tx.BatchCompressor(params, batches[0].shape[0],
                                batches[0].shape[1], device=device)
        return [bc.compress_frames(f) for f in batches]
    finally:
        tx.set_timestamp_func(None)


def run_phase(name, params, batches, need):
    """Drive the port's main path on the card, check it, return a report.

    ``need``: kernels this path must have launched.
    """
    b, n = batches[0].shape
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tx.set_timestamp_func(_Stamp())
    try:
        bc = tx.BatchCompressor(params, b, n, device="cuda")
        comp, enc_s = [], []
        for f in batches:
            t = time.perf_counter()
            comp.append(bc.compress_frames(f))
            enc_s.append(time.perf_counter() - t)
    finally:
        tx.set_timestamp_func(None)
    bd = tx.BatchDecompressor(params, b, n, device="cuda")
    dec, dec_s = [], []
    for c in comp:
        t = time.perf_counter()
        dec.append(bd.decompress_frames(c))
        dec_s.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    for k in need:
        check(launched[k] > 0, f"phase {name}: kernel {k} was not launched")
    for i, (f, d) in enumerate(zip(batches, dec)):
        check(np.array_equal(f, d), f"phase {name}: batch {i} round trip")
    cpu = compress_all(params, batches, "cpu")
    for i, (g, c) in enumerate(zip(comp, cpu)):
        check(g == c, f"phase {name}: batch {i} GPU frames != CPU frames")
    for fr in comp:
        for f in fr:
            check(len(f) == tx.CmpHeader.deserialize(f)[0].compressed_size,
                  f"phase {name}: frame size != header compressed_size")
    raw = 2 * b * n
    packed = [sum(map(len, c)) for c in comp]
    report = {
        "phase": name, "blocks": b, "samples": n, "batches": len(batches),
        "launches": launched, "wall_s": wall,
        "encode_ms": [1e3 * s for s in enc_s],
        "decode_ms": [1e3 * s for s in dec_s],
        "ratio": raw * len(batches) / sum(packed),
        "compressed_bytes": packed,
    }
    print(json.dumps(report), flush=True)
    return report, comp


def manifest(packed):
    """One file stream of several packed batches, its offsets and lens."""
    stream = b"".join(st for st, _ in packed)
    lens = np.concatenate([z for _, z in packed]).astype(np.int64)
    return stream, np.cumsum(lens) - lens, lens


def timed_iter(gen):
    """Drain a generator; returns (items, ms between consecutive items)."""
    items, ms = [], []
    t = time.perf_counter()
    for item in gen:
        items.append(item)
        now = time.perf_counter()
        ms.append(1e3 * (now - t))
        t = now
    return items, ms


def run_packed_phase(name, params, batches, need):
    """Drive the adaptive packed-stream path on the card, check it, return
    a report: compress_frames_packed per batch, then the four streams
    decoded with decompress_file_stream (one manifest) and with
    decompress_stream over stage_frames_at batches.

    ``need``: kernels this path must have launched.
    """
    b, n = batches[0].shape
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tx.set_timestamp_func(_Stamp())
    try:
        bc = tx.BatchCompressor(params, b, n, adaptive=True, device="cuda")
        packed, enc_s = [], []
        for f in batches:
            t = time.perf_counter()
            packed.append(bc.compress_frames_packed(f))
            enc_s.append(time.perf_counter() - t)
    finally:
        tx.set_timestamp_func(None)
    stream, offs, lens = manifest(packed)
    bd = tx.BatchDecompressor(params, b, n, device="cuda")
    dec_file, file_ms = timed_iter(bd.decompress_file_stream(stream, offs,
                                                             lens))
    bd2 = tx.BatchDecompressor(params, b, n, device="cuda")
    dec_stream, stream_ms = timed_iter(bd2.decompress_stream(
        bd2.stage_frames_at(st, np.cumsum(z) - z, z) for st, z in packed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    for k in need:
        check(launched[k] > 0, f"phase {name}: kernel {k} was not launched")
    check(len(dec_file) == len(dec_stream) == len(batches),
          f"phase {name}: decoded batch count")
    for i, f in enumerate(batches):
        check(np.array_equal(f, dec_file[i]),
              f"phase {name}: batch {i} decompress_file_stream round trip")
        check(np.array_equal(f, dec_stream[i]),
              f"phase {name}: batch {i} decompress_stream round trip")

    # the same streams from the port's CPU path and from compress_frames
    tx.set_timestamp_func(_Stamp())
    try:
        cpu = tx.BatchCompressor(params, b, n, adaptive=True, device="cpu")
        cpu_packed = [cpu.compress_frames_packed(f) for f in batches]
    finally:
        tx.set_timestamp_func(None)
    tx.set_timestamp_func(_Stamp())
    try:
        bcl = tx.BatchCompressor(params, b, n, adaptive=True, device="cuda")
        lists = [bcl.compress_frames(f) for f in batches]
    finally:
        tx.set_timestamp_func(None)
    g_used = collections.Counter()
    for i, ((st, z), (cst, cz), fr) in enumerate(zip(packed, cpu_packed,
                                                     lists)):
        check(st == cst and np.array_equal(z, cz),
              f"phase {name}: batch {i} GPU stream != CPU stream")
        check(st == b"".join(fr),
              f"phase {name}: batch {i} stream != joined compress_frames")
        for size, f in zip(z, fr):
            hdr = tx.CmpHeader.deserialize(f)[0]
            check(int(size) == hdr.compressed_size == len(f),
                  f"phase {name}: size != header compressed_size")
            g_used[hdr.encoder_param] += 1
    raw = 2 * b * n
    report = {
        "phase": name, "blocks": b, "samples": n, "batches": len(batches),
        "launches": launched, "wall_s": wall,
        "encode_ms": [1e3 * s for s in enc_s],
        "decode_file_stream_ms": file_ms,
        "decode_stream_ms": stream_ms,
        "ratio": raw * len(batches) / len(stream),
        "compressed_bytes": [len(st) for st, _ in packed],
        "g_selected": dict(sorted(g_used.items())),
    }
    print(json.dumps(report), flush=True)
    return report, packed


CLI_PARAM_STRING = ("primary_preprocessing=diff,primary_encoder_type="
                    "golomb_zero,primary_encoder_param=4,checksum_enabled=true")
CLI_TAIL = 1000  # samples past the last full chunk: phase F's host block


def run_cli_phase(need):
    """Phase F: the port's CLI on the card, in-process, on a big-endian u16
    file of 2 x 2048 chunks of 8192 detector-like samples and a 1000-sample
    tail (64 MiB + 2000 bytes, over one block's limit): ``-c`` runs
    compress_chunked (two device batches, K5 assembling each, the tail on
    the host codec), then decompressing the .air file runs
    decompress_chunked (device-staged: one upload, two device runs, the
    tail on the host path).  Checks the restored file, and the .air file
    against compress_frames over the same batches plus the host tail
    under the same identifiers (a reference without K5).

    ``need``: kernels this path must have launched."""
    from airs_compression_tpu_torch.cli.main import main as cli_main
    from airs_compression_tpu_torch.cli.params_parse import parse_params
    from airs_compression_tpu_torch.engine.context import CmpContext

    check(parse_params(CLI_PARAM_STRING) == CLI_PARAMS, "phase F params")
    rows = make_frames(40, 2 * CHUNK_BATCH, N)
    tail = make_frames(41, 1, CLI_TAIL)[0]
    raw = np.concatenate([rows.ravel(), tail]).astype(">u2").tobytes()
    scratch = pathlib.Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    launched, wall = {}, {}
    with tempfile.TemporaryDirectory(prefix="phase_f_", dir=scratch) as d:
        src, air, back = (os.path.join(d, name) for name in
                          ("frames.dat", "frames.dat.air", "restored.dat"))
        with open(src, "wb") as f:
            f.write(raw)
        for step, argv in (("compress", ["-c", src, "-o", air, "-p",
                                         CLI_PARAM_STRING]),
                           ("decompress", [air, "-o", back])):
            torch.cuda.synchronize()
            reset_counts()
            tx.set_timestamp_func(_Stamp())
            try:
                t = time.perf_counter()
                rc = cli_main(argv)
                torch.cuda.synchronize()
                wall[step] = time.perf_counter() - t
            finally:
                tx.set_timestamp_func(None)
            check(rc == 0, f"phase F: CLI {step} exit code {rc}")
            launched[step] = counts()
        with open(air, "rb") as f:
            stream = f.read()
        with open(back, "rb") as f:
            restored = f.read()
    check(restored == raw, "phase F: restored file != input")
    total = {k: launched["compress"][k] + launched["decompress"][k]
             for k in KERNELS}
    for k in need:
        check(total[k] > 0, f"phase F: kernel {k} was not launched")

    # the CLI's context draws first, then compress_chunked's, then each
    # chunk in block order (the tail last)
    tx.set_timestamp_func(_Stamp())
    try:
        CmpContext(CLI_PARAMS)
        tail_ctx = CmpContext(CLI_PARAMS)
        bc = tx.BatchCompressor(CLI_PARAMS, CHUNK_BATCH, N, device="cuda")
        ref = [f for k in range(2) for f in bc.compress_frames(
            rows[k * CHUNK_BATCH:(k + 1) * CHUNK_BATCH])]
        ref.append(tail_ctx.compress_u16(tail))
    finally:
        tx.set_timestamp_func(None)
    check(stream == b"".join(ref),
          "phase F: .air file != joined compress_frames + host tail")
    report = {
        "phase": "F", "file_bytes": len(raw), "air_bytes": len(stream),
        "blocks": len(ref), "launches": total,
        "launches_by_step": launched,
        "encode_s": wall["compress"], "decode_s": wall["decompress"],
        "encode_MBps": len(raw) / 1e6 / wall["compress"],
        "decode_MBps": len(raw) / 1e6 / wall["decompress"],
        "ratio": len(raw) / len(stream),
    }
    print(json.dumps(report), flush=True)
    return report


def cuda_ms(fn, runs: int) -> float:
    """Median over ``runs`` of one call's time between two CUDA events
    recorded around it, after one warm-up call: the device time plus
    whatever of the host's work in the call the card waits for."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def kernel_ms(fn, symbol: str, runs: int) -> "float | None":
    """Mean device time of the CUDA kernel whose name holds ``symbol``,
    alone, over ``runs`` calls (torch.profiler); None where the trace holds
    no device time for it."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if symbol in e.key:
            dt = getattr(e, "device_time_total", None)
            total += dt if dt is not None else e.cuda_time_total
            count += e.count
    return total / count / 1e3 if count and total else None


def cold_kernel_ms(fn, symbol: str) -> "float | None":
    """As :func:`kernel_ms`, with the 50 MB L2 flushed before each call
    (a 128 MiB buffer written), so the kernel reads from device memory."""
    flush = torch.empty(32 << 20, dtype=torch.int32, device="cuda")

    def cold():
        flush.fill_(1)
        fn()
    return kernel_ms(cold, symbol, TIMED_RUNS)


def entry_ms(fn, runs: int) -> "float | None":
    """Mean device time of one C entry that ``fn`` calls through
    ``_build.function`` (a kernel launch of the port; each entry launches
    one kernel), over ``runs`` calls of ``fn``, between CUDA events
    recorded on the current stream just before and just after the entry.
    The card spins BUSY_CYCLES (``torch.cuda._sleep``) before each start
    event, so the event, the launch and the stop event are all queued
    before the card reaches them: the host's launch latency is not timed.
    None where ``fn`` called no C entry."""
    real = _build.function
    pairs = []

    def timed(name, symbol, argtypes):
        entry = real(name, symbol, argtypes)

        def call(*args):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(BUSY_CYCLES)
            start.record()
            err = entry(*args)
            stop.record()
            pairs.append((start, stop))
            return err
        return call

    fn()
    torch.cuda.synchronize()
    _build.function = timed
    try:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    finally:
        _build.function = real
    return (sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)
            if pairs else None)


def device_ms(fn, symbol: str) -> "tuple[float, str, float]":
    """A kernel's own device time as ``(ms, ms_by, events_ms)``: ``ms`` from
    torch.profiler (:func:`kernel_ms`) where its trace holds the kernel,
    else :func:`entry_ms`'s, ``ms_by`` which of the two, ``events_ms``
    :func:`entry_ms`'s in every case.  A trace that lost the kernel's
    device records (seen on H100s, once three times running in one
    process) is taken again, up to three times in all, before the events
    stand in."""
    ms = None
    for _ in range(3):
        ms = kernel_ms(fn, symbol, TIMED_RUNS)
        if ms is not None:
            break
    events = entry_ms(fn, TIMED_RUNS)
    check(ms is not None or events is not None,
          f"{symbol}: neither the profiler nor the events saw device time")
    return (ms, "profiler", events) if ms is not None else (
        events, "events", events)


def timings(fn, name: str) -> "dict[str, float]":
    """A kernel wrapper's times: ``ms``, ``ms_by`` and ``events_ms`` the
    CUDA kernel's own device time as :func:`device_ms` gives them,
    ``call_ms`` one wrapper call between two events, the host's work in
    the call included (how chip_smoke.py timed kernels before)."""
    ms, by, events = device_ms(fn, KERNELS[name][3])
    return dict(ms=ms, ms_by=by, events_ms=events,
                call_ms=cuda_ms(fn, TIMED_RUNS))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def k4_long_rows(b: int, n: int) -> bool:
    """Whether K4 hashes b rows of n samples on its long path."""
    fn = _build.function("xxh32", "airs_xxh32_long_rows",
                         [ctypes.c_int, ctypes.c_int])
    return bool(fn(b, n))


def _residuals(rng, b: int, n: int) -> torch.Tensor:
    """Small residuals with a full-range one every fifth sample (escapes:
    ZERO's 16 raw bits, MULTI codes of up to 48 bits)."""
    r = torch.from_numpy(rng.integers(-40, 41, (b, n)).astype(np.int32))
    r[:, ::5] = torch.from_numpy(rng.integers(
        -0x8000, 0x8000, (b, (n + 4) // 5)).astype(np.int32))
    return r


# per-block Golomb parameters of the K3 edge cases, cycled over the blocks
K3_EDGE_G = {0: (0,), 1: (1, 4, 0xFFFF, 7), 2: (1, 2, 0xFFFF, 5)}
K3_EDGE_KINDS = ("valid", "truncated", "junk", "junk7", "ones", "zeros")


def k3_edge_rows(rng, kind: str, enc: int, gs, outs, n: int):
    """(B, W) int32 word rows for one K3 edge case and the bit decoding
    starts at: valid payloads (3 zero words either side, each block packed
    under its own g), the same cut to about half (the chain runs past the
    row's end), random words (40 words, or 14 words: 7 segments of 64
    bits), all-ones and all-zero rows."""
    b = len(gs)
    if kind in ("junk", "junk7", "ones", "zeros"):
        width = 14 if kind == "junk7" else 40
        fill = {"ones": -1, "zeros": 0}.get(kind)
        if fill is None:
            rows = rng.integers(-2**31, 2**31, (b, width)).astype(np.int32)
        else:
            rows = np.full((b, width), fill, np.int32)
        return torch.from_numpy(rows), 16
    payloads = []
    for g, o in zip(gs, outs):
        p, bits = pack_residuals_plain(_residuals(rng, 1, n), enc, g, o)
        payloads.append(p[0, : (int(bits[0]) + 31) // 32])
    width = 6 + max(len(p) for p in payloads)
    rows = torch.zeros((b, width), dtype=torch.int32)
    for i, p in enumerate(payloads):
        rows[i, 3: 3 + len(p)] = p
    if kind == "truncated":
        rows = rows[:, : 3 + max(1, min(len(p) for p in payloads) // 2)]
    return rows.contiguous(), 96


def k3_edge_checks(dev) -> int:
    """K3 against decode_codes_plain on every edge corpus: valid ZERO,
    MULTI and UNCOMPRESSED payloads with per-block g from 1 to 0xFFFF,
    truncated, junk, all-ones and all-zero rows; B=1, N=1 and N=7; rows
    of 1, 7 and up to 256 segments; a row whose start is not 16-byte
    aligned; rows wider than the shared memory a CTA may hold.  Returns
    the number of cases."""
    rng = np.random.default_rng(11)
    cases = 0

    def hold(words, hdr_bits, n, enc, gs, outs, what, view=False):
        g = torch.tensor(gs, dtype=torch.int64)
        o = torch.tensor(outs, dtype=torch.int64)
        want = decode_codes_plain(words, hdr_bits, n, enc, g, o)
        w = words.to(dev)
        if view:  # a contiguous row matrix 4 bytes past a 16-byte boundary
            buf = torch.empty(words.numel() + 1, dtype=torch.int32,
                              device=dev)
            w = buf[1:].view(words.shape)
            w.copy_(words)
        got = decode_blocks(w, hdr_bits, n, enc, g.to(dev), o.to(dev))
        check(all(torch.equal(a, v.cpu()) for a, v in zip(want, got)),
              f"K3 edge {what}")

    for enc in (0, 1, 2):
        for kind in K3_EDGE_KINDS:
            for b, n in ((1, 1), (1, 7), (3, 7), (16, 256)) + (
                    ((4, 2048),) if kind == "valid" else ()):
                gs = [K3_EDGE_G[enc][i % len(K3_EDGE_G[enc])]
                      for i in range(b)]
                outs = [derive_encoder_outlier(enc, g, 40) for g in gs]
                words, hdr_bits = k3_edge_rows(rng, kind, enc, gs, outs, n)
                hold(words, hdr_bits, n, enc, gs, outs,
                     f"{kind} enc={enc} b={b} n={n}",
                     view=kind == "valid" and b == 16)
                cases += 1
    # rows wider than a CTA's shared memory: a valid payload then zeros,
    # and random words across the whole row
    wide = 60000
    gs, outs = [4, 4], [derive_encoder_outlier(1, 4, 40)] * 2
    valid, hdr_bits = k3_edge_rows(rng, "valid", 1, gs[:1], outs[:1], 512)
    words = torch.zeros((2, wide), dtype=torch.int32)
    words[0, : valid.shape[1]] = valid[0]
    words[1] = torch.from_numpy(rng.integers(-2**31, 2**31, wide)
                                .astype(np.int32))
    hold(words, hdr_bits, 512, 1, gs, outs, f"W={wide} (device-memory row)")
    return cases + 1


def k4_edge_checks(dev) -> int:
    """K4 against xxh32_blocks at N across the stripe, word and odd-sample
    boundaries and B from 1 to 512, and on rows not 16-byte aligned.
    Returns the number of cases."""
    rng = np.random.default_rng(12)
    cases = 0
    for n in (1, 7, 8, 9, 15, 16, 17, 8191, 8192):
        for b in (1, 3, 33, 512):
            x = torch.from_numpy(rng.integers(-0x8000, 0x8000, (b, n))
                                 .astype(np.int32))
            check(torch.equal(checksum_blocks_device(x.to(dev)).cpu(),
                              xxh32_blocks(x)), f"K4 edge b={b} n={n}")
            cases += 1
    for b, n in ((3, 16), (33, 8192)):
        x = torch.from_numpy(rng.integers(-0x8000, 0x8000, (b, n))
                             .astype(np.int32))
        buf = torch.empty(x.numel() + 1, dtype=torch.int32, device=dev)
        xv = buf[1:].view(b, n)
        xv.copy_(x)
        check(torch.equal(checksum_blocks_device(xv).cpu(), xxh32_blocks(x)),
              f"K4 edge b={b} n={n} (row 4 bytes past 16-byte alignment)")
        cases += 1
    # both sides of the path switch: rows of LONG_MIN_SAMPLES and one stripe
    # fewer, as many rows as SMs and one more
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, n in ((1, LONG_MIN_SAMPLES - 8), (1, LONG_MIN_SAMPLES),
                 (sms, LONG_MIN_SAMPLES + 3), (sms + 1, LONG_MIN_SAMPLES + 3)):
        x = torch.from_numpy(rng.integers(-0x8000, 0x8000, (b, n))
                             .astype(np.int32))
        check(torch.equal(checksum_blocks_device(x.to(dev)).cpu(),
                          xxh32_blocks(x)),
              f"K4 edge b={b} n={n} (long path: {k4_long_rows(b, n)})")
        cases += 1
    return cases


# K1's edge configurations: every encoder, g a power of two and not
K1_EDGE_CONFIGS = ((0, 0), (1, 4), (1, 5), (2, 2), (2, 3))
PACK_EDGE_N = (1, 7, 8191, 8192, 8193)
PACK_EDGE_B = (1, 3, 512)
# (codes, row_len, max_bits) of the long-row edge cases: no codes, rows
# shorter than a tile (K2's 1024 codes, K1's 2048), one row, row_len off
# the tile (50, 1000, 8191), rows wider than the 8 CTAs of a cluster take
# in one round (16384, 9000 and 40000 codes: 2, 2 and 5 rounds of K2's)
LONG_ROW_EDGES = ((0, 8, 48), (1, 8, 48), (7, 3, 29), (500, 1000, 48),
                  (3000, 50, 48), (5000, 1000, 29), (8193, 2048, 48),
                  (30000, 8191, 48), (40000, 16384, 48), (27000, 9000, 48),
                  (100000, 40000, 29))


def _misaligned(x: torch.Tensor, dev) -> torch.Tensor:
    """A contiguous copy of x on dev, 4 bytes past a 16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    v = buf[1:].view(x.shape)
    v.copy_(x)
    return v


def k1_edge_checks(dev) -> int:
    """K1 against pack_residuals_plain (on the card) at N across the tile
    and 16-byte boundaries and B from 1 to 512 under every encoder with g
    a power of two and not; g = 1 and 0xFFFF, MULTI with its largest
    outlier; a residual matrix 4 bytes past a 16-byte boundary; rows of
    40,000 residuals (60,000 MULTI payload words).  Returns the number of
    cases."""
    rng = np.random.default_rng(13)
    cases = 0

    def hold(r, enc, g, what, misaligned=False, outlier=40):
        o = derive_encoder_outlier(enc, g, outlier) if enc else 0
        r = r.to(dev)
        want = pack_residuals_plain(r, enc, g, o)
        got = pack_residuals(_misaligned(r, dev) if misaligned else r, enc,
                             g, o)
        check(all(torch.equal(w, v) for w, v in zip(want, got)),
              f"K1 edge {what} enc={enc} g={g}")

    for enc, g in K1_EDGE_CONFIGS:
        for n in PACK_EDGE_N:
            for b in PACK_EDGE_B:
                hold(_residuals(rng, b, n), enc, g, f"b={b} n={n}")
                cases += 1
    # the extreme parameters; MULTI's largest outlier (codes to 48 bits)
    for enc, g, outlier in ((1, 1, 40), (2, 1, 40), (1, 0xFFFF, 40),
                            (2, 0xFFFF, 40), (2, 0xFFFF, 1 << 30)):
        hold(_residuals(rng, 3, 257), enc, g, f"b=3 n=257 outlier={outlier}",
             outlier=outlier)
        cases += 1
    for enc, g in ((1, 4), (2, 2)):
        hold(_residuals(rng, 3, 8192), enc, g, "misaligned", misaligned=True)
        cases += 1
    hold(_residuals(rng, 2, 40000), 2, 2, "b=2 n=40000 (wide row)")
    return cases + 1


def _codes(rng, b: int, k: int, max_bits: int, top: "int | None" = None):
    """(hi or None, lo, lens) int32 tensors: codes of 0 (a quarter of them
    pads) to ``top`` (default max_bits) bits, the last one max_bits."""
    top = top or max_bits
    lens = rng.integers(1, top + 1, (b, k))
    lens[rng.random((b, k)) < 0.25] = 0
    lens[:, -1] = max_bits
    val = rng.integers(0, 1 << 64, (b, k), dtype=np.uint64)
    val >>= (64 - lens).astype(np.uint64)
    val[lens == 0] = 0
    hi = torch.from_numpy((val >> 32).astype(np.uint32).view(np.int32))
    lo = torch.from_numpy((val & 0xFFFFFFFF).astype(np.uint32)
                          .view(np.int32))
    return (hi if top > 32 else None, lo,
            torch.from_numpy(lens.astype(np.int32)))


def k2_edge_checks(dev) -> int:
    """K2 against pack_codes_plain (on the card): codes of 0 (pads) to 29
    bits without hi, to 48 and to 64 bits with hi, at N across the tile
    and 16-byte boundaries and B from 1 to 512; lengths over max_bits
    (pieces past C dropped); arrays 4 bytes past a 16-byte boundary; rows
    of 40,000 48-bit codes (60,000 payload words).  Returns the number of
    cases."""
    rng = np.random.default_rng(14)
    cases = 0

    def hold(codes, max_bits, what, misaligned=False):
        codes = tuple(None if a is None else a.to(dev) for a in codes)
        want = pack_codes_plain(*codes, max_bits)
        if misaligned:
            codes = tuple(None if a is None else _misaligned(a, dev)
                          for a in codes)
        got = pack_codes(*codes, max_bits)
        check(all(torch.equal(w, v) for w, v in zip(want, got)),
              f"K2 edge {what} max_bits={max_bits}")

    for max_bits in (29, 48, 64):
        for n in PACK_EDGE_N:
            for b in PACK_EDGE_B:
                hold(_codes(rng, b, n, max_bits), max_bits, f"b={b} k={n}")
                cases += 1
    hold(_codes(rng, 3, 8193, 16, top=48), 16, "b=3 k=8193 lengths to 48")
    hold(_codes(rng, 3, 8192, 48), 48, "b=3 k=8192 misaligned",
         misaligned=True)
    hold(_codes(rng, 2, 40000, 48), 48, "b=2 k=40000 (wide row)")
    return cases + 3


def k5_edge_checks(dev) -> int:
    """K5 against assemble_stream_plain (on the card): frames of 0-20 bytes
    at every start offset mod 16; runs of frames under 4 bytes that share
    one 16-byte chunk; frames of exactly 4W bytes and frames of several
    rounds a CTA; int64 and int32 words, each as contiguous rows and as
    row views 4 (int32) or 8 (int64) bytes off alignment; B = 0, 1 and
    65,537; ``total`` given and not.  Returns the number of cases."""
    rng = np.random.default_rng(15)
    cases = 0

    def hold(sizes, w, what):
        b = len(sizes)
        full = torch.from_numpy(rng.integers(0, 1 << 32, (b, w + 1),
                                             dtype=np.uint64).astype(np.int64))
        sz = torch.tensor(sizes, dtype=torch.int32)
        szd = sz.to(dev)
        for words in (full, to_bits(full)):
            on_dev = words.to(dev)
            for view in (on_dev[:, :w].contiguous(), on_dev[:, 1:]):
                want = assemble_stream_plain(view.cpu(), sz)
                for total in (None, int(sz.sum())):
                    got = assemble_stream(view, szd, total)
                    check(torch.equal(got.cpu(), want),
                          f"K5 edge {what} {view.dtype} stride "
                          f"{view.stride(0)} total={total}")
        return 1

    for lead in range(16):
        cases += hold([lead] + list(range(21)) + list(range(20, -1, -1)), 6,
                      f"0-20 bytes after {lead}")
    cases += hold([5] + [1, 3, 0, 2, 3, 1, 1, 2, 0, 0, 3, 3] * 4 + [17, 2, 1],
                  5, "runs under 4 bytes")
    cases += hold([4 * 300, 3, 4 * 300, 0, 4 * 300], 300, "4W bytes")
    sizes = rng.integers(0, 4 * 4000 + 1, 64)
    sizes[::7] = 4 * 4000
    cases += hold(sizes.tolist(), 4000, "B=64 up to 16,000 bytes")
    for sizes in ([], [0], [3], [28], [27]):
        cases += hold(sizes, 7, f"B={len(sizes)}")
    cases += hold(rng.integers(0, 13, 65537).tolist(), 3, "B=65537")
    return cases


def edge_checks(dev) -> None:
    """Kernels against their plain versions at small and odd shapes, every
    encoder type, and on random words (malformed codes, poisoned ends)."""
    print(json.dumps({"edge_cases": {"pack_residuals": k1_edge_checks(dev),
                                     "pack_codes": k2_edge_checks(dev),
                                     "decode_blocks": k3_edge_checks(dev),
                                     "xxh32_blocks": k4_edge_checks(dev),
                                     "assemble_stream": k5_edge_checks(dev)}}),
          flush=True)


def encoder_words(params, frames, adaptive):
    """The (B, n_words) int64 frame words and (B,) int32 sizes that
    ``BatchCompressor`` hands K5 for one batch of frames, and their sum."""
    tx.set_timestamp_func(_Stamp())
    try:
        bc = tx.BatchCompressor(params, *frames.shape, adaptive=adaptive,
                                device="cuda")
        words, sizes, sizes_np, _ = bc._encode_frames(frames)
    finally:
        tx.set_timestamp_func(None)
    return words, sizes, int(sizes_np.sum())


def k5_bytes(words, sizes, total) -> int:
    """Bytes K5 must move: the words each frame's bytes lie in, read once,
    the sizes, and the stream written once."""
    used = int(((sizes.to(torch.int64) + 3) // 4).sum())
    return used * words.element_size() + 4 * sizes.numel() + total


def k5_cases():
    """K5's main-path inputs: phase D's first batch (adaptive headline,
    B=512) and the first batch of phase F's file (headline + checksum,
    B=2048), the int64 words as the encoder makes them; phase D's also as
    int32 bits, as K5 was timed before."""
    wd, sd, td = encoder_words(HEADLINE, make_widening_frames(20), True)
    wf, sf, tf = encoder_words(CLI_PARAMS, make_frames(40, CHUNK_BATCH, N),
                               False)
    return {"D_int64": (wd, sd, td), "D_int32": (to_bits(wd), sd, td),
            "F_int64": (wf, sf, tf)}


def k5_report(words, sizes, total) -> dict:
    """K5's times on one input: ``ms`` and ``call_ms`` as :func:`timings`,
    ``cold_ms`` with the L2 flushed first, the plain version's time, the
    bytes it must move and their bound."""
    def call():
        return assemble_stream(words, sizes, total)
    nbytes = k5_bytes(words, sizes, total)
    return dict(shape=list(words.shape), stream_bytes=total,
                **timings(call, "assemble_stream"),
                cold_ms=cold_kernel_ms(call, KERNELS["assemble_stream"][3]),
                plain_ms=cuda_ms(lambda: assemble_stream_plain(words, sizes),
                                 3),
                bytes=nbytes, bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)


def select_inputs(batches_d, batches_e):
    """The adaptive choice's arguments on the main path, as
    ``(residuals, caller_outlier)`` on the card: phase D's first batch of
    DIFF residuals (ZERO, no caller outlier) and phase E's secondary
    MODEL residuals (MULTI, the flagship's outlier)."""
    dev = torch.device("cuda")
    x_d = torch.from_numpy(batches_d[0].view(np.int16)).to(dev).int()
    x_e = [torch.from_numpy(f.view(np.int16)).to(dev).int()
           for f in batches_e[:2]]
    return ((preprocess.diff_forward(x_d), None),
            (preprocess.model_forward(x_e[1], x_e[0]),
             make_pass_config(FLAGSHIP_CS, True).raw_outlier))


def k2_inputs(batches_d, batches_e):
    """K2's arguments on the main path: phase D's adaptive ZERO codes (no
    hi) and phase E's secondary MULTI codes against the model (48-bit
    escapes), as the encoder makes them; the kernel reads int32 words."""
    ladder = tx.DEFAULT_LADDER
    (r, _), (r_e, outlier) = select_inputs(batches_d, batches_e)
    g, _, _ = select_params(r, ladder)
    _, lo, lens = adapt.encode_codewords_dynamic(r, g)
    zero_args = (None, to_bits(lo), lens.int(),
                 adaptive_worst_bits(make_pass_config(HEADLINE, False),
                                     ladder))
    g, o, _ = select_params(r_e, ladder, outlier)
    hi, lo, lens = adapt.encode_codewords_dynamic_multi(r_e, g, o)
    return zero_args, (to_bits(hi), to_bits(lo), lens.int(), 48)


@contextlib.contextmanager
def select_mode(mode: str):
    """``AIRS_ADAPTIVE_SELECT`` set to ``mode`` inside the block."""
    old = os.environ.get("AIRS_ADAPTIVE_SELECT")
    os.environ["AIRS_ADAPTIVE_SELECT"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["AIRS_ADAPTIVE_SELECT"]
        else:
            os.environ["AIRS_ADAPTIVE_SELECT"] = old


def select_checks(batches_d, batches_e):
    """Phase C for the adaptive choice: ``select_params`` against
    ``select_params_plain`` on phases D's and E's residuals at B x N, in
    the fast window and over the whole ladder, every block's parameter,
    outlier and bits exactly; timed on phase D's ZERO residuals in the
    fast window (the main path's), and reported on phase E's MULTI ones
    and in exact mode."""
    ladder = tx.DEFAULT_LADDER
    cases = select_inputs(batches_d, batches_e)
    err, reports = 0, {}
    for mode in ("fast", "exact"):
        with select_mode(mode):
            for (r, outlier), enc in zip(cases, ("zero", "multi")):
                got = select_params(r, ladder, outlier)
                want = select_params_plain(r, ladder, outlier)
                err = max(err, *(max_abs_err(a, b)
                                 for a, b in zip(got, want)))
                reports[f"{enc}_{mode}"] = dict(
                    **timings(lambda: select_params(r, ladder, outlier),
                              "select_params"),
                    plain_ms=cuda_ms(
                        lambda: select_params_plain(r, ladder, outlier), 3),
                    bytes=4 * r.numel() + 24 * r.shape[0],
                    g_selected=len(set(got[0].tolist())))
    print(json.dumps({"select_params": reports}), flush=True)
    check(reports["zero_fast"]["g_selected"] > 1,
          "phase D's residuals chose a single parameter")
    return dict(max_abs_err=err, **reports["zero_fast"])


def packed_kernel_checks(batches_d, batches_e, packed_d, multi_codes):
    """Phase C for the adaptive choice, K2 and K5, on phases D and E's
    inputs; K2's report on phase E's MULTI codes goes into
    ``multi_codes``; K5 on phase D's and phase F's words."""
    out = {"select_params": select_checks(batches_d, batches_e)}
    zero_args, multi_args = k2_inputs(batches_d, batches_e)
    lens = multi_args[2]
    err = 0
    for args in (zero_args, multi_args):
        pk, bk = pack_codes(*args)
        pp, bp = pack_codes_plain(*args)
        err = max(err, max_abs_err(from_bits(pk), from_bits(pp)),
                  max_abs_err(bk, bp))
    longest = int(lens.max())
    check(longest > 32, f"phase E codes reach {longest} bits, not > 32")
    n_codes = B * N
    out["pack_codes"] = dict(
        max_abs_err=err,
        **timings(lambda: pack_codes(*zero_args), "pack_codes"),
        plain_ms=cuda_ms(lambda: pack_codes_plain(*zero_args), 3),
        bytes=8 * n_codes + 4 * B * code_words(zero_args[3], N) + 4 * B)
    multi_codes["pack_codes"] = dict(
        case="phase E MULTI secondary", longest_code_bits=longest,
        **timings(lambda: pack_codes(*multi_args), "pack_codes"),
        plain_ms=cuda_ms(lambda: pack_codes_plain(*multi_args), 3),
        bound_ms=1e3 * (12 * n_codes + 4 * B * code_words(48, N) + 4 * B)
        / HBM_BYTES_PER_S)

    # K5: the int64 words phase D's encoder hands it (under phase D's
    # identifiers: they must give phase D's first stream), the same words
    # as int32 bits (as K5 was timed before) and the first batch of phase
    # F's file
    cases = k5_cases()
    reports = {}
    for case, (words, sizes, total) in cases.items():
        sk = assemble_stream(words, sizes, total)
        sp = assemble_stream_plain(words, sizes)
        check(sk.shape == sp.shape, f"K5 {case} stream length")
        if case.startswith("D"):
            check(sk.cpu().numpy().tobytes() == packed_d[0][0],
                  f"K5 {case} stream != phase D stream")
        reports[case] = dict(max_abs_err=max_abs_err(sk, sp),
                             **k5_report(words, sizes, total))
    print(json.dumps({"k5_words": reports}), flush=True)
    for case, rep in reports.items():
        check(rep["max_abs_err"] == 0, f"K5 {case} disagrees with its plain "
              f"version: max abs err {rep['max_abs_err']}")
    out["assemble_stream"] = reports["D_int64"]

    # a corrupt stream must raise, not decode garbage
    stream, offs, lens = manifest(packed_d)
    bad = bytearray(stream)
    a, e = int(offs[2]) + 22, int(offs[2] + lens[2])
    bad[a:e] = b"\xff" * (e - a)
    t = time.perf_counter()
    try:
        list(tx.BatchDecompressor(HEADLINE, B, N, device="cuda")
             .decompress_file_stream(bytes(bad), offs, lens))
    except tx.CmpError as exc:
        corrupt = {"corrupt_stream_decode_ms": 1e3 * (time.perf_counter()
                                                      - t),
                   "error": exc.code.name}
    else:
        raise AssertionError("corrupt stream decoded without CmpError")
    print(json.dumps(corrupt), flush=True)
    return out


def k1_inputs(frames_a, batches_b):
    """K1's arguments on the main path: headline DIFF residuals (ZERO) and
    the flagship's MODEL residuals (MULTI secondary)."""
    dev = torch.device("cuda")
    x_a = torch.from_numpy(frames_a.view(np.int16)).to(dev).int()
    x_b = [torch.from_numpy(f.view(np.int16)).to(dev).int()
           for f in batches_b[:2]]
    zero = make_pass_config(HEADLINE, False)
    multi = make_pass_config(FLAGSHIP_CS, True)
    return [(r, cfg.enc_type, cfg.g_par, cfg.outlier) for r, cfg in (
        (preprocess.diff_forward(x_a), zero),
        (preprocess.model_forward(x_b[1], x_b[0]), multi))]


def kernel_checks(comp_a, comp_b, batches_b, multi_codes):
    """Phase C: each kernel against its plain version, on the card; K1's
    report on phase B's MULTI residuals goes into ``multi_codes``."""
    dev = torch.device("cuda")
    out = {}
    zero = make_pass_config(HEADLINE, False)
    multi = make_pass_config(FLAGSHIP_CS, True)
    x_b = [torch.from_numpy(f.view(np.int16)).to(dev).int() for f in batches_b]

    # K1: headline DIFF residuals (ZERO) and flagship MODEL residuals (MULTI)
    k1_cases = k1_inputs(make_frames(0), batches_b)
    err = 0
    for args in k1_cases:
        pk, bk = pack_residuals(*args)
        pp, bp = pack_residuals_plain(*args)
        err = max(err, max_abs_err(from_bits(pk), from_bits(pp)),
                  max_abs_err(bk, bp))
    reports = []
    for args in k1_cases:
        payload, _ = pack_residuals(*args)
        reports.append(dict(
            max_abs_err=err,
            **timings(lambda: pack_residuals(*args), "pack_residuals"),
            plain_ms=cuda_ms(lambda: pack_residuals_plain(*args), 3),
            bytes=4 * args[0].numel() + 4 * payload.numel() + 4 * B))
    out["pack_residuals"] = reports[0]
    multi_codes["pack_residuals"] = dict(
        case="phase B MULTI secondary",
        **{k: v for k, v in reports[1].items() if k.endswith("ms")},
        bound_ms=1e3 * reports[1]["bytes"] / HBM_BYTES_PER_S)

    # K3: the headline frames (ZERO) and the flagship's secondary (MULTI)
    bd = tx.BatchDecompressor(HEADLINE, B, N, device="cpu")
    k3_cases = []
    for frames, cfg in ((comp_a[0], zero), (comp_b[1], multi)):
        st = bd.stage_frames(frames)
        words = _bytes_to_be_words(st.buf, dev)
        g = torch.from_numpy(st.g.astype(np.int64)).to(dev)
        o = torch.from_numpy(st.outlier.astype(np.int64)).to(dev)
        k3_cases.append(((words, cfg.hdr_bits, N, cfg.enc_type, g, o),
                         int(st.csize.sum())))
    err = 0
    plain_ms = None
    for args, _ in k3_cases:
        vk, ek = decode_blocks(*args)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        vp, ep = decode_codes_plain(*args)
        stop.record()
        stop.synchronize()
        plain_ms = plain_ms or start.elapsed_time(stop)
        err = max(err, max_abs_err(from_bits(vk), from_bits(vp)),
                  max_abs_err(ek, ep))
    args, frame_bytes = k3_cases[0]
    out["decode_blocks"] = dict(
        max_abs_err=err,
        **timings(lambda: decode_blocks(*args), "decode_blocks"),
        plain_ms=plain_ms,
        bytes=frame_bytes + 8 * B + 4 * N * B + 4 * B)

    # K3 on the lanes outside a method group, as decode_staged decodes them
    # in a mixed batch: phase B's MULTI frames decoded as ZERO with g=1,
    # outlier=1, against the plain version on the CPU
    words, hdr_bits, _, _, g, o = k3_cases[1][0]
    garbage = (words, hdr_bits, N, 1, torch.ones_like(g), torch.ones_like(o))
    vk, ek = decode_blocks(*garbage)
    vp, ep = decode_codes_plain(*(a.cpu() if torch.is_tensor(a) else a
                                  for a in garbage))
    err = max(max_abs_err(vk.cpu(), vp), max_abs_err(ek.cpu(), ep))
    check(err == 0, f"K3 on lanes outside the group: max abs err {err}")
    args = k3_cases[1][0]
    print(json.dumps({"k3_lanes_outside_group": {
        "case": "phase B MULTI frames decoded as ZERO, g=1, outlier=1",
        "max_abs_err": err,
        "kernel_ms": kernel_ms(lambda: decode_blocks(*garbage),
                               "decode_blocks_kernel", TIMED_RUNS),
        "own_group_kernel_ms": kernel_ms(lambda: decode_blocks(*args),
                                         "decode_blocks_kernel", TIMED_RUNS)}}),
        flush=True)

    # K4: the flagship's samples; a few rows also against the host XXH32
    x = x_b[0]
    hk = checksum_blocks_device(x)
    hp = xxh32_blocks(x)
    host = torch.tensor([cmp_checksum(batches_b[0][i]) for i in range(8)])
    check(torch.equal(hk[:8].cpu(), host), "K4 != host XXH32")
    out["xxh32_blocks"] = dict(
        max_abs_err=max_abs_err(hk, hp),
        **timings(lambda: checksum_blocks_device(x), "xxh32_blocks"),
        plain_ms=cuda_ms(lambda: xxh32_blocks(x), 3),
        bytes=4 * x.numel() + 4 * B)

    edge_checks(dev)
    for name, res in out.items():
        check(res["max_abs_err"] == 0, f"{name} disagrees with its plain "
              f"version: max abs err {res['max_abs_err']}")

    # a corrupt batch must raise, not decode garbage
    bad = list(comp_a[0])
    frame = bytearray(bad[2])
    frame[22:] = b"\xff" * (len(frame) - 22)
    bad[2] = bytes(frame)
    t = time.perf_counter()
    try:
        tx.BatchDecompressor(HEADLINE, B, N, device="cuda") \
            .decompress_frames(bad)
    except tx.CmpError as e:
        corrupt = {"corrupt_decode_ms": 1e3 * (time.perf_counter() - t),
                   "error": e.code.name}
    else:
        raise AssertionError("corrupt batch decoded without CmpError")
    print(json.dumps(corrupt), flush=True)
    return out


def make_stream(seed: int, n: int, sigma: float = 4.0,
                level: int = 1000) -> np.ndarray:
    """Smooth detector data for one long stream (__graft_entry__.py:155-158,
    scaled up)."""
    rng = np.random.default_rng(seed)
    return ((level + rng.normal(0, sigma, n)).astype(np.int64)
            & 0xFFFF).astype(np.uint16)


def batch_reference(params, frames, start: int = 0):
    """The port's batch path at B=1 (K1 packs the row in one CTA) over a
    chain of frames, identifiers drawn from a stamp at ``start``."""
    tx.set_timestamp_func(_Stamp(start))
    try:
        bc = tx.BatchCompressor(params, 1, frames[0].size, device="cuda")
        return [bc.compress_frames(f[None])[0] for f in frames]
    finally:
        tx.set_timestamp_func(None)


def run_long_phase(need, card: str):
    """Phase G: the long-stream tier on the card, checked, with a report
    (``card``: its name and power limit, beside the times).

    ``need``: kernels this path must have launched."""
    dev = "cuda"
    n = LONG_N
    x = make_stream(50, n)
    base = make_stream(51, LONG_CHAIN_N, sigma=20, level=1100)
    chain_in = [((base.astype(np.int64) + k) & 0xFFFF).astype(np.uint16)
                for k in range(3)]
    feeds = x.reshape(-1, FEED_CHUNK)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    runs = []
    for _ in range(LONG_RUNS):
        total = StageTimer()
        with total.stage("encode", 2 * n, sync=dev):
            frame = sp.compress_long_stream(CLI_PARAMS, x, device=dev)
        with total.stage("sidecar", 2 * n, sync=dev):
            idx = sp.stream_chunk_index(CLI_PARAMS, x, SIDECAR_CHUNK,
                                        device=dev)
        with total.stage("decode", 2 * n, sync=dev):
            back = sp.decompress_long_stream(frame, idx, device=dev)
        runs.append(total.as_dict())
    feed_t = StageTimer()
    with feed_t.stage("upload", 2 * 48 * FEED_CHUNK, sync=dev):
        many = torch.from_numpy(feeds[16:].view(np.int16)).to(dev)
    enc = sp.ChunkedLongStreamEncoder(CLI_PARAMS, n, FEED_CHUNK, device=dev)
    feed_host_ms = []  # each feed's host time, no wait for the card
    with feed_t.stage("feed", 2 * 16 * FEED_CHUNK, sync=dev):
        for k in range(16):
            t = time.perf_counter()
            enc.feed(feeds[k])
            feed_host_ms.append(1e3 * (time.perf_counter() - t))
    with feed_t.stage("feed_many", 2 * 48 * FEED_CHUNK, sync=dev):
        for k in range(3):
            enc.feed_many(many[16 * k: 16 * (k + 1)])
    with feed_t.stage("finish", sync=dev):
        chunked = enc.finish()
    tx.set_timestamp_func(_Stamp())
    try:
        lsc = sp.LongStreamCompressor(LONG_CHAIN, device=dev)
        with feed_t.stage("chain_encode", 2 * 3 * LONG_CHAIN_N, sync=dev):
            chain = [lsc.compress(f) for f in chain_in]
    finally:
        tx.set_timestamp_func(None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    launch_rows = row_counts()
    for k in need:
        check(launched[k] > 0, f"phase G: kernel {k} was not launched")

    check(np.array_equal(back, x), "phase G: long-stream round trip")
    check(chunked == frame, "phase G: chunked frame != one-shot frame")
    hdr = tx.CmpHeader.deserialize(frame)[0]
    check(hdr.compressed_size == len(frame) and hdr.original_size == 2 * n,
          "phase G: header sizes")
    check(22 + (int(idx.sum()) + 7) // 8 + 4 == len(frame),
          "phase G: sidecar bits against the frame's size")
    t = time.perf_counter()
    dec_chain, hdrs = tx.decompress(b"".join(chain))
    chain_decode_s = time.perf_counter() - t
    check(np.array_equal(dec_chain, np.concatenate(chain_in)),
          "phase G: chain round trip through decompress")
    check([(h.sequence_number, h.preprocessing) for h in hdrs]
          == [(0, 2), (1, 3), (2, 3)], "phase G: chain passes")
    # the independent reference: the batch path at B=1 under the same ids
    # (the chain's context drew one identifier before its first frame)
    check(batch_reference(CLI_PARAMS, [x]) == [frame],
          "phase G: long frame != BatchCompressor(B=1) frame")
    check(batch_reference(LONG_CHAIN, chain_in, start=1) == chain,
          "phase G: chain frames != BatchCompressor(B=1) frames")
    # the steps of one more encode and decode, from their profiler ranges
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        check(sp.compress_long_stream(CLI_PARAMS, x, device=dev) == frame,
              "phase G: profiled encode")
        check(np.array_equal(sp.decompress_long_stream(frame, idx,
                                                       device=dev), x),
              "phase G: profiled decode")
    steps = range_times(prof, "sp.")
    check(sorted(steps) == sorted(LONG_STEPS),
          f"phase G: profiled steps {sorted(steps)}")
    # K4 over the one row takes milliseconds: the split must see it
    check(steps["sp.encode.checksum"]["device_s"] > 1e-3,
          "phase G: the profiled steps miss K4's device time")
    report = {
        "phase": "G", "card": card, "samples": n, "launches": launched,
        "launch_rows": launch_rows, "wall_s": wall,
        "frame_bytes": len(frame), "ratio": 2 * n / len(frame),
        "chunks": int(idx.size), "runs": runs, "steps": steps,
        "chunked": feed_t.as_dict(), "feed_host_ms": feed_host_ms,
        "chain_samples": LONG_CHAIN_N, "chain_bytes": [len(c) for c in chain],
        "chain_host_decode_s": chain_decode_s,
    }
    print(json.dumps(report), flush=True)
    return report, (x, frame, idx, many), chain


# the examples that drive the long-row packers through the public entry
# points, run at their default device (cuda) after phase G
CARD_EXAMPLES = ("examples/torch_long_stream.py",
                 "examples/torch_streaming_pipeline.py")
EXAMPLE_TIMEOUT_S = 300


def run_script(cmd: "list[str]", timeout: float):
    """``cmd`` from the repository root in a session of its own, which is
    killed whole (the script's own children too) once ``cmd`` ends or its
    time is up; a timeout raises.  Returns (exit code, stdout, stderr,
    wall seconds)."""
    root = pathlib.Path(__file__).resolve().parent
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:  # the session ended with the script
            pass
        proc.wait()
    return proc.returncode, out, err, time.perf_counter() - t


def run_examples(card: str) -> dict:
    """Each of CARD_EXAMPLES in a process of its own, from the repository
    root: it must exit 0, its own round-trip checks (asserts) passing."""
    out = {}
    for path in CARD_EXAMPLES:
        rc, stdout, stderr, s = run_script([sys.executable, path],
                                           EXAMPLE_TIMEOUT_S)
        check(rc == 0, f"{path} exited {rc}:\n{stdout[-2000:]}\n"
              f"{stderr[-2000:]}")
        out[path] = {"s": s, "last_line": stdout.strip().splitlines()[-1]}
    print(json.dumps({"examples": out, "card": card}), flush=True)
    return out


# -- phase H: the multi-rank tier ---------------------------------------------

# the ranks of phase H: 4 on the one card under gloo, then 1 under NCCL
MESH_GROUPS = (("gloo", 4), ("nccl", 1))
MESH_TIMEOUT_S = 240
# kernels each rank's dp and sp runs must have launched
MESH_DP_KERNELS = ("pack_residuals", "decode_blocks", "xxh32_blocks",
                   "assemble_stream")
MESH_SP_KERNELS = ("pack_residuals_at", "pack_codes_at", "xxh32_lanes")


def frame_meta(batches) -> dict:
    """Identifiers, sequence numbers and sizes of each batch's frames (from
    their headers), (batches, B) each."""
    hdrs = [[tx.CmpHeader.deserialize(f)[0] for f in frames]
            for frames in batches]
    return {"ids": np.array([[h.identifier for h in hs] for hs in hdrs]),
            "seq": np.array([[h.sequence_number for h in hs] for hs in hdrs],
                            dtype=np.int32),
            "sizes": np.array([[len(f) for f in frames]
                               for frames in batches])}


def _mesh_dp(mesh, tmp: pathlib.Path, tag: str, name: str, params,
             seeds) -> "list[dict]":
    """One rank's dp run over phase ``name``'s batches (regenerated from
    their seeds), with the identifiers of that phase's frames: its rows'
    frames joined by K5 must equal its part of the phase's stream, the
    decode must give its rows back, and rank 0's splice of the ranks'
    shard files must equal the whole stream.  Returns each batch's
    ``StageTimer`` times."""
    meta = np.load(tmp / f"{name}_meta.npz")
    rows = dp.block_sharding(mesh).rows(B)
    dev = mesh.device
    state = dp.ShardedBatchState(mesh, B, N)
    n_words = max(worst_case_words(make_pass_config(params, s), N)
                  for s in (False, True))
    local_bytes = 2 * (rows.stop - rows.start) * N
    runs = []
    for i, seed in enumerate(seeds):
        timer = StageTimer()
        frames = make_frames(seed).view(np.int16)
        ids, seq = meta["ids"][i], meta["seq"][i]
        check((seq == seq[0]).all(), f"phase H {tag}: {name}{i} passes")
        cfg = make_pass_config(params, bool(seq[0]))
        with timer.stage("encode", local_bytes, sync=dev):
            x, model, seq_r, id_hi, id_lo, _ = dp.place_encode_operands(
                mesh, frames, frames, seq, (ids >> 24) & 0xFFFFFF,
                ids & 0xFFFFFF, np.zeros(B, np.int64))
            if params.checksum_enabled:
                checksum = checksum_blocks_device(x)
            else:
                checksum = torch.zeros_like(id_hi)
            if params.model_is_needed():
                model = state.model
            words, sizes, fell = dp.encode_blocks_sharded(
                mesh, cfg, None, x, model, seq_r, id_hi, id_lo, checksum,
                n_words)
        with timer.stage("assemble", sync=dev):
            shard = gather.assemble_stream(words, sizes)
        with timer.stage("decode", local_bytes, sync=dev):
            back, _ = dp.decode_blocks_sharded(mesh, cfg, words, model, N)
        check(torch.equal(back, x), f"phase H {tag}: {name}{i} round trip")
        if params.checksum_enabled:
            check(torch.equal(checksum_blocks_device(back), checksum),
                  f"phase H {tag}: {name}{i} checksums of the decode")
        if params.model_is_needed():
            state.update(x, seq_r, fell, params.model_rate, True)
        sizes_all = gather.allgather_sizes(sizes.cpu().numpy(), mesh)
        check(np.array_equal(sizes_all, meta["sizes"][i]),
              f"phase H {tag}: {name}{i} gathered sizes")
        start = int(sizes_all[: rows.start].sum())
        whole = (tmp / f"{name}{i}.air").read_bytes()
        check(shard == whole[start: start + len(shard)],
              f"phase H {tag}: {name}{i} rank frames != phase frames")
        (tmp / f"{tag}-{name}{i}-{mesh.rank}.bin").write_bytes(shard)
        mesh.barrier()
        if mesh.rank == 0:
            manifest = gather.StreamManifest([B // mesh.size] * mesh.size,
                                             sizes_all)
            shards = [(tmp / f"{tag}-{name}{i}-{p}.bin").read_bytes()
                      for p in range(mesh.size)]
            offsets = [0] * mesh.size
            spliced = bytearray()
            for p, _j, size in manifest.global_order():
                spliced += shards[p][offsets[p]: offsets[p] + size]
                offsets[p] += size
            check(bytes(spliced) == whole,
                  f"phase H {tag}: {name}{i} splice != phase frames")
        runs.append(timer.as_dict())
    return runs


def _mesh_sp(mesh, tmp: pathlib.Path, tag: str) -> dict:
    """One rank's part of phase G's stream: the one-shot frame (LONG_RUNS
    times), the chunked encoder's and the IWT/MODEL chain's must equal
    phase G's one-card frames on rank 0.  Returns the ``StageTimer`` times
    of each one-shot run and of the rest, and the times of LONG_RUNS
    rounds of the one-shot's XXH32 relay alone (``sp._hash_round`` over
    the rank's part, host clock from a barrier to the synchronised end:
    on rank 0 the whole ring, whose digest must be the frame's trailer).
    No profiler here: its first start in a process took 7.5 s."""
    r, w = mesh.rank, mesh.size
    dev = mesh.device
    x = make_stream(50, LONG_N)
    mine = x.reshape(w, -1)[r]
    frame_g = (tmp / "g.air").read_bytes()
    runs = []
    for k in range(LONG_RUNS):
        timer = StageTimer()
        with timer.stage("encode", 2 * mine.size, sync=dev):
            frame = sp.compress_long_stream(CLI_PARAMS, mine, mesh=mesh)
        check(frame == (frame_g if r == 0 else None),
              f"phase H {tag}: split frame {k} != phase G frame")
        runs.append(timer.as_dict())

    part = torch.from_numpy(mine.view(np.int16)).to(dev).to(torch.int32)
    relay_ms = []
    for _ in range(LONG_RUNS):
        hasher = StreamHasher(dev)
        mesh.barrier()
        torch.cuda.synchronize()
        t = time.perf_counter()
        sp._hash_round(mesh, hasher, part)
        torch.cuda.synchronize()
        relay_ms.append(1e3 * (time.perf_counter() - t))
        if r == 0:
            check(hasher.intdigest() == int.from_bytes(frame_g[-4:], "big"),
                  f"phase H {tag}: relayed digest != the frame's trailer")

    timer = StageTimer()
    piece = FEED_CHUNK // w
    feeds = x.reshape(-1, FEED_CHUNK)[:, r * piece: (r + 1) * piece]
    with timer.stage("upload", 2 * 48 * piece, sync=dev):
        many = torch.from_numpy(feeds[16:].view(np.int16)).to(dev)
    enc = sp.ChunkedLongStreamEncoder(CLI_PARAMS, LONG_N, FEED_CHUNK,
                                      mesh=mesh)
    with timer.stage("feed", 2 * 16 * piece, sync=dev):
        for k in range(16):
            enc.feed(feeds[k])
    with timer.stage("feed_many", 2 * 48 * piece, sync=dev):
        for k in range(3):
            enc.feed_many(many[16 * k: 16 * (k + 1)])
    with timer.stage("finish", sync=dev):
        chunked = enc.finish()
    check(chunked == (frame_g if r == 0 else None),
          f"phase H {tag}: split chunked frame != phase G frame")

    base = make_stream(51, LONG_CHAIN_N, sigma=20, level=1100)
    tx.set_timestamp_func(_Stamp())
    try:
        lsc = sp.LongStreamCompressor(LONG_CHAIN, mesh=mesh)
        with timer.stage("chain_encode", 2 * 3 * LONG_CHAIN_N // w,
                         sync=dev):
            chain = [lsc.compress(((base.astype(np.int64) + k) & 0xFFFF)
                                  .astype(np.uint16).reshape(w, -1)[r])
                     for k in range(3)]
    finally:
        tx.set_timestamp_func(None)
    for k, c in enumerate(chain):
        check(c == ((tmp / f"chain{k}.air").read_bytes() if r == 0
                    else None), f"phase H {tag}: split chain frame {k}")
    return {"runs": runs, "relay_ms": relay_ms, "rest": timer.as_dict()}


def mesh_rank(backend: str, rank: int, world: int, tmp: str, queue,
              spawned: float) -> None:
    """One rank of phase H, in a process of its own (spawned at
    ``spawned``, a ``time.time()``): joins the group (a FileStore in
    ``tmp``, with a timeout), runs the dp path over phases A and B and the
    sp path over phase G's stream on the card, checks them, and puts its
    report on ``queue``."""
    clock = {"started": time.time() - spawned}
    tmp = pathlib.Path(tmp)
    tag = f"{backend}{world}"
    card = rank % torch.cuda.device_count()
    torch.cuda.set_device(card)
    torch.zeros(1, device="cuda")  # the CUDA context, timed apart
    clock["cuda"] = time.time() - spawned
    multihost_initialize(backend=backend, timeout=MESH_TIMEOUT_S / 2,
                         store=dist.FileStore(str(tmp / f"store-{tag}"),
                                              world),
                         rank=rank, world_size=world)
    mesh = make_mesh(world, "dp")
    check(mesh.device == torch.device(f"cuda:{card}") and mesh.rank == rank,
          f"phase H {tag}: mesh {mesh}")
    clock["group"] = time.time() - spawned
    report = {"phase": "H", "backend": backend, "world": world,
              "rank": rank}

    torch.cuda.synchronize()
    reset_counts()
    report["dp_a"] = _mesh_dp(mesh, tmp, tag, "a", HEADLINE, range(4))
    report["dp_b"] = _mesh_dp(mesh, tmp, tag, "b", FLAGSHIP_CS,
                              range(10, 14))
    torch.cuda.synchronize()
    report["dp_launches"] = counts()
    clock["dp"] = time.time() - spawned

    reset_counts()
    report["sp"] = _mesh_sp(make_mesh(world, "sp"), tmp, tag)
    torch.cuda.synchronize()
    report["sp_launches"] = counts()
    report["sp_launch_rows"] = row_counts()
    clock["sp"] = time.time() - spawned
    dist.destroy_process_group()
    clock["done"] = time.time() - spawned
    report["clock_s"] = clock  # since the spawn, at each point
    queue.put(report)


def run_mesh_phase(comp_a, comp_b, frame_g, chain_g, card: str,
                   groups=MESH_GROUPS) -> dict:
    """Phase H: the multi-rank tier on the card.  The ranks of each group
    of MESH_GROUPS run ``mesh_rank`` in spawned processes, one group after
    the other, against phases A's, B's and G's outputs (written to a
    temporary directory); any rank that fails or times out fails the
    phase.  Prints one report line a rank; returns the launches summed
    over the ranks and the phase's wall time."""
    ctx = multiprocessing.get_context("spawn")
    launched = collections.Counter()
    launch_rows = {name: collections.Counter() for name in LONG_ROW_KERNELS}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = pathlib.Path(tmp_name)
        for name, comp in (("a", comp_a), ("b", comp_b)):
            np.savez(tmp / f"{name}_meta.npz", **frame_meta(comp))
            for i, frames in enumerate(comp):
                (tmp / f"{name}{i}.air").write_bytes(b"".join(frames))
        (tmp / "g.air").write_bytes(frame_g)
        for k, c in enumerate(chain_g):
            (tmp / f"chain{k}.air").write_bytes(c)
        for backend, world in groups:
            queue = ctx.Queue()
            t = time.perf_counter()
            procs = [ctx.Process(target=mesh_rank,
                                 args=(backend, r, world, tmp_name, queue,
                                       time.time()))
                     for r in range(world)]
            for p in procs:
                p.start()
            reports = []
            try:
                deadline = time.monotonic() + MESH_TIMEOUT_S
                while len(reports) < world:
                    check(time.monotonic() < deadline,
                          f"phase H {backend}: ranks timed out")
                    check(all(p.exitcode in (None, 0) for p in procs),
                          f"phase H {backend}: a rank failed "
                          f"(exit codes {[p.exitcode for p in procs]})")
                    try:
                        reports.append(queue.get(timeout=1))
                    except queue_mod.Empty:  # no report yet: poll again
                        pass
                for p in procs:
                    p.join(timeout=60)
            finally:
                for p in procs:
                    if p.is_alive():
                        p.kill()
                        p.join()
            check(all(p.exitcode == 0 for p in procs),
                  f"phase H {backend}: exit codes "
                  f"{[p.exitcode for p in procs]}")
            check(len(reports) == world, f"phase H {backend}: reports")
            group_s = time.perf_counter() - t
            for rep in sorted(reports, key=lambda d: d["rank"]):
                for k in MESH_DP_KERNELS:
                    check(rep["dp_launches"][k] > 0,
                          f"phase H {backend} rank {rep['rank']}: dp did "
                          f"not launch {k}")
                for k in MESH_SP_KERNELS:
                    check(rep["sp_launches"][k] > 0,
                          f"phase H {backend} rank {rep['rank']}: sp did "
                          f"not launch {k}")
                launched.update(rep["dp_launches"])
                launched.update(rep["sp_launches"])
                for name, by_rows in rep["sp_launch_rows"].items():
                    launch_rows[name].update(by_rows)
                rep["card"] = card
                rep["group_s"] = group_s
                print(json.dumps(rep), flush=True)
    wall = time.perf_counter() - t0
    launch_rows = {k: dict(v) for k, v in launch_rows.items()}
    print(json.dumps({"phase": "H", "wall_s": wall,
                      "launches": dict(launched),
                      "launch_rows": launch_rows}), flush=True)
    return {"launches": dict(launched), "launch_rows": launch_rows,
            "wall_s": wall}


# -- phase I: the coalesced decode and the native host tier -------------------

COALESCE_RUNS = (False, 2, True)
GROUP_ROWS = tx.BatchDecompressor.COALESCE_LANES  # rows of a full group
COALESCE_BATCHES = 9
# decode launches of one stateless uniform pass over nine batches, by
# coalesce value: one a batch, groups of 2 (the last of 1), groups of 8
# (GROUP_ROWS // B; the last of 1)
COALESCE_GROUPS = {False: 9, 2: 5, True: 2}
HOST_BLOCK_N = 1 << 21     # one CLI single block of 4 MiB
HOST_PLAIN_N = 1 << 18     # the Python twins' run


def fetch_probe(repeats: int = 5) -> "dict[str, list[float]]":
    """Host ms of what ``finish`` fetches for 4096 rows of int32 samples:
    eight (512, N) ``.cpu()`` copies (one a batch), one (4096, N) copy (one
    a group of 8), the same into a reused pinned buffer, and host memory
    alone: a fresh (4096, N) numpy array written once against eight
    (512, N) ones."""
    group = GROUP_ROWS // B
    t_batch = torch.ones((B, N), dtype=torch.int32, device="cuda")
    t_group = torch.ones((GROUP_ROWS, N), dtype=torch.int32,
                         device="cuda")
    pinned = torch.empty((GROUP_ROWS, N), dtype=torch.int32,
                         pin_memory=True)
    cases = {
        "per_batch_cpu_x8": lambda: [t_batch.cpu() for _ in range(group)],
        "group_cpu": lambda: t_group.cpu(),
        "group_pinned_copy": lambda: pinned.copy_(t_group),
        "host_fill_x8": lambda: [np.empty((B, N), np.int32).fill(1)
                                 for _ in range(group)],
        "host_fill_group": lambda: np.empty((GROUP_ROWS, N),
                                            np.int32).fill(1),
    }
    out = {}
    for name, fn in cases.items():
        out[name] = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            out[name].append(1e3 * (time.perf_counter() - t))
    return out


def _coalesce_run(params, packed, coalesce, file_path: bool):
    """One decode of the nine packed batches, by decompress_file_stream
    over one manifest or by decompress_stream over stage_frames_at
    stagings; returns (outputs, wall s, launches)."""
    bd = tx.BatchDecompressor(params, B, N, device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    if file_path:
        gen = bd.decompress_file_stream(*manifest(packed), coalesce=coalesce)
    else:
        gen = bd.decompress_stream(
            (bd.stage_frames_at(st, np.cumsum(z) - z, z) for st, z in packed),
            coalesce=coalesce)
    outs = list(gen)
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t, counts()


def k3_coalesced(params, packed, launches: int, card: str) -> dict:
    """K3 at the coalesced launch's shape: the first group of 8 batches'
    rows (B = 4096), gathered as decode_staged_from_multi gathers them,
    against its plain version on the same inputs."""
    from airs_compression_tpu_torch.models.stream import (
        _combine_staged,
        _gather_rows_device,
    )
    dev = torch.device("cuda")
    group = GROUP_ROWS // B
    bd = tx.BatchDecompressor(params, B, N, device="cuda")
    stream, offs, lens = manifest(packed[:group])
    sts = [bd.stage_headers_at(stream, offs[w * B:(w + 1) * B],
                               lens[w * B:(w + 1) * B]) for w in range(group)]
    comb = _combine_staged(sts, max(s.n_words for s in sts))
    words = _gather_rows_device(
        bd.upload_stream(stream).data, torch.from_numpy(comb.row_off).to(dev),
        torch.from_numpy(comb.row_len).to(dev), comb.n_words)
    cfg = make_pass_config(params, False)
    rows = comb.prep.size
    args = (words, cfg.hdr_bits, N, cfg.enc_type,
            torch.from_numpy(comb.g.astype(np.int64)).to(dev),
            torch.from_numpy(comb.outlier.astype(np.int64)).to(dev))
    vk, ek = decode_blocks(*args)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    vp, ep = decode_codes_plain(*args)
    stop.record()
    stop.synchronize()
    err = max(max_abs_err(from_bits(vk), from_bits(vp)),
              max_abs_err(ek, ep))
    check(err == 0, f"K3 at {rows} rows: max abs err {err}")
    nbytes = int(lens.sum()) + 8 * rows + 4 * N * rows + 4 * rows
    rep = {"k3_coalesced": dict(
        card=card, rows=rows, launches=launches, max_abs_err=err,
        **timings(lambda: decode_blocks(*args), "decode_blocks"),
        plain_ms=start.elapsed_time(stop),
        bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by="bytes")}
    print(json.dumps(rep), flush=True)
    return rep["k3_coalesced"]


class _PlainCore:
    """The host codec's native calls answered by their Python twins
    (``engine/host.pack_codes``, ``_decode_mapped_plain``,
    ``utils/xxh32.cmp_checksum``), to time the codec without the native
    core."""

    @staticmethod
    def encode_residuals(res, enc, g, outlier, dst, start_bit):
        codes, lens = host.encode_codewords(res, enc, g, outlier)
        payload = host.pack_codes(codes, lens)
        dst[start_bit // 8: start_bit // 8 + len(payload)] = payload
        return start_bit + int(lens.sum())

    decode_mapped = staticmethod(host._decode_mapped_plain)

    @staticmethod
    def checksum_u16(samples, seed):
        return cmp_checksum(samples)


def _host_round_trip(x, plain: bool):
    """CmpContext encode and decompress of one block under CLI_PARAMS
    (identifier stubbed); returns (frame, samples, encode s, decode s)."""
    saved = host.native
    host.native = _PlainCore if plain else saved
    tx.set_timestamp_func(_Stamp())
    try:
        t = time.perf_counter()
        frame = tx.CmpContext(CLI_PARAMS).compress_u16(x)
        t_enc = time.perf_counter() - t
        t = time.perf_counter()
        back, _ = tx.decompress(frame)
        t_dec = time.perf_counter() - t
    finally:
        tx.set_timestamp_func(None)
        host.native = saved
    return frame, back, t_enc, t_dec


def native_tier(packed, card: str, chain_decode_s: float) -> dict:
    """The native host tier on phase I's inputs: the three stagings
    against their plain twin (columns and rows equal; host times), and
    the host codec through the native core against its Python twins."""
    bd = tx.BatchDecompressor(CLI_PARAMS, B, N, device="cuda")
    fields = ("prep", "enc", "cs", "seq", "g", "outlier", "csize",
              "stored_csum", "uniform")
    times = collections.defaultdict(list)

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        times[name].append(1e3 * (time.perf_counter() - t))
        return out

    for st_bytes, z in packed:
        offs = np.cumsum(z) - z
        frames = [st_bytes[o:o + n] for o, n in zip(offs, z)]
        twin = timed("plain_ms", lambda: bd._stage_plain_at(st_bytes, offs,
                                                             z))
        got = {"stage_frames": timed("stage_frames_ms",
                                     lambda: bd.stage_frames(frames)),
               "stage_frames_at": timed("stage_frames_at_ms",
                                        lambda: bd.stage_frames_at(
                                            st_bytes, offs, z)),
               "stage_headers_at": timed("stage_headers_at_ms",
                                         lambda: bd.stage_headers_at(
                                             st_bytes, offs, z))}
        for name, st in got.items():
            for f in fields:
                check(np.array_equal(getattr(st, f), getattr(twin, f)),
                      f"phase I: {name} {f} != plain twin")
            check(st.buf is None if name == "stage_headers_at"
                  else np.array_equal(st.buf, twin.buf),
                  f"phase I: {name} rows != plain twin")
        check(twin.uniform, "phase I: a headline batch is not uniform")

    x_big = make_stream(60, HOST_BLOCK_N)
    x_small = make_stream(61, HOST_PLAIN_N)
    big = _host_round_trip(x_big, plain=False)
    check(np.array_equal(big[1], x_big), "phase I: native host round trip")
    small = _host_round_trip(x_small, plain=False)
    plain = _host_round_trip(x_small, plain=True)
    check(plain[0] == small[0], "phase I: plain host frame != native")
    check(np.array_equal(plain[1], x_small) and np.array_equal(small[1],
                                                               x_small),
          "phase I: host round trip at 2^18")
    rep = {"phase": "I", "part": "native host tier", "card": card,
           "staging_host_ms": {k: v for k, v in times.items()},
           "host_codec": {
               "native_2^21": {"encode_s": big[2], "decode_s": big[3],
                               "frame_bytes": len(big[0])},
               "native_2^18": {"encode_s": small[2], "decode_s": small[3]},
               "plain_2^18": {"encode_s": plain[2], "decode_s": plain[3]}},
           "phase_G_chain_host_decode_s": chain_decode_s}
    print(json.dumps(rep), flush=True)
    return rep


def run_coalesce_phase(card: str, chain_decode_s: float) -> dict:
    """Phase I: nine headline batches and the same nine under CLI_PARAMS
    (checksums) packed on the card, each set decoded by
    decompress_file_stream and by decompress_stream with coalesce False, 2
    and True, every output equal to its input; one K3 launch (and K4 where
    checksummed) per group; the flagship chain refuses coalesce=True and
    decodes per batch with the default.  Then K3 at 4096 rows and the
    native host tier.  Prints the reports; returns the launches and
    times."""
    batches = [make_frames(40 + s) for s in range(COALESCE_BATCHES)]
    launched = collections.Counter()
    runs = []
    packs = {}
    for label, params in (("headline", HEADLINE), ("cli", CLI_PARAMS)):
        torch.cuda.synchronize()
        reset_counts()
        tx.set_timestamp_func(_Stamp())
        try:
            bc = tx.BatchCompressor(params, B, N, device="cuda")
            packs[label] = [bc.compress_frames_packed(f) for f in batches]
        finally:
            tx.set_timestamp_func(None)
        launched.update(counts())
        for rnd in range(2):  # the first round warms the 4096-row shapes
            for file_path in (True, False):
                ref = None
                for coalesce in COALESCE_RUNS:
                    outs, wall, got = _coalesce_run(params, packs[label],
                                                    coalesce, file_path)
                    launched.update(got)
                    what = (f"phase I {label} "
                            f"{'file' if file_path else 'stream'} "
                            f"coalesce={coalesce}")
                    check(len(outs) == COALESCE_BATCHES, f"{what}: batches")
                    for i, (f, d) in enumerate(zip(batches, outs)):
                        check(np.array_equal(f, d),
                              f"{what}: batch {i} round trip")
                    if ref is None:
                        ref = outs
                    check(all(np.array_equal(a, b)
                              for a, b in zip(outs, ref)),
                          f"{what}: output != coalesce=False")
                    groups = COALESCE_GROUPS[coalesce]
                    check(got["decode_blocks"] == groups,
                          f"{what}: {got['decode_blocks']} K3 launches, "
                          f"not {groups}")
                    check(got["xxh32_blocks"] == (groups if params
                                                  .checksum_enabled else 0),
                          f"{what}: {got['xxh32_blocks']} K4 launches")
                    runs.append({"round": rnd, "params": label,
                                 "path": "file" if file_path else "stream",
                                 "coalesce": coalesce, "groups": groups,
                                 "wall_s": wall,
                                 "per_batch_ms": 1e3 * wall
                                 / COALESCE_BATCHES})

    fetch = fetch_probe()

    # a MODEL chain: coalesce=True is refused, the default decodes per batch
    comp_b = compress_all(FLAGSHIP_CS, [make_frames(10 + s) for s in range(4)],
                          "cuda")
    try:
        list(tx.BatchDecompressor(FLAGSHIP_CS, B, N, device="cuda")
             .decompress_stream(iter(comp_b), coalesce=True))
    except tx.CmpError as e:
        check(e.code is tx.CmpErrorCode.PARAMS_INVALID,
              f"phase I: flagship coalesce=True raised {e.code.name}")
    else:
        raise AssertionError("phase I: flagship chain coalesced")
    torch.cuda.synchronize()
    reset_counts()
    dec_b = list(tx.BatchDecompressor(FLAGSHIP_CS, B, N, device="cuda")
                 .decompress_stream(iter(comp_b)))
    got = counts()
    launched.update(got)
    check(got["decode_blocks"] == len(comp_b),
          f"phase I: flagship default decode made {got['decode_blocks']} "
          f"K3 launches for {len(comp_b)} batches")
    for s, d in enumerate(dec_b):
        check(np.array_equal(d, make_frames(10 + s)),
              f"phase I: flagship batch {s} round trip")
    for k in ("pack_residuals", "assemble_stream", "decode_blocks",
              "xxh32_blocks"):
        check(launched[k] > 0, f"phase I: kernel {k} was not launched")
    print(json.dumps({"phase": "I", "card": card, "blocks": B, "samples": N,
                      "batches": COALESCE_BATCHES, "runs": runs,
                      "launches": dict(launched), "fetch_ms": fetch}),
          flush=True)
    k3 = k3_coalesced(HEADLINE, packs["headline"],
                      sum(r["coalesce"] is True for r in runs), card)
    native = native_tier(packs["cli"], card, chain_decode_s)
    return {"launches": dict(launched), "runs": runs, "k3": k3,
            "native": native}


# -- phase J: the fuzz soak of the decode tier and the docs build -------------

SOAK_SECONDS = 30.0
SOAK_SEED = 9


def _load_tool(name: str):
    """``tools/<name>.py`` of this checkout as a module."""
    path = pathlib.Path(__file__).resolve().parent / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_soak_phase(card: str) -> dict:
    """Phase J: ``tools/torch_fuzz_soak.py``'s soak on the card for
    SOAK_SECONDS (mutated batches through the batch tier and the coalesced
    decode, held against the host oracle), which must find no mismatch
    and launch K3, and K4 where a case was checksummed; then
    ``tools/torch_build_docs.py`` into a temporary directory, one page a
    module of the port, with no JAX imported."""
    soak = _load_tool("torch_fuzz_soak").soak
    torch.cuda.synchronize()
    reset_counts()
    res = soak(SOAK_SECONDS, SOAK_SEED, "cuda")
    launched = counts()
    check(res["cases"] > 0, "phase J: the soak ran no case")
    check(res["mismatches"] == 0,
          f"phase J: the soak found {res['mismatches']} mismatches")
    check(launched["decode_blocks"] > 0, "phase J: K3 was not launched")
    check(launched["xxh32_blocks"] > 0 or not res["checksummed_cases"],
          "phase J: checksummed cases ran and K4 was not launched")
    docs = _load_tool("torch_build_docs")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        docs.OUT = pathlib.Path(tmp)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = docs.main()
        pages = len(list(docs.OUT.glob("*.html")))
    docs_s = time.perf_counter() - t
    check(rc == 0 and pages == len(docs.MODULES) + 1,
          f"phase J: the docs build wrote {pages} pages (exit code {rc})")
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "airs_compression_tpu"))
    check(not foreign, f"phase J: imported {foreign[:5]}")
    rep = {"phase": "J", "card": card, "seed": SOAK_SEED,
           "cases": res["cases"],
           "checksummed_cases": res["checksummed_cases"],
           "mutations": res["mutations"], "mismatches": res["mismatches"],
           "launches": {k: launched[k] for k in ("decode_blocks",
                                                 "xxh32_blocks")},
           "seconds": res["seconds"],
           "cases_per_s": res["cases"] / res["seconds"],
           "pages": pages, "docs_s": docs_s}
    print(json.dumps(rep), flush=True)
    return rep


# -- phase K: the entry points not yet run on the card ------------------------

ENTRY_TIMEOUT_S = 300
# the line a shimmed entry point prints last: this tag, then a JSON object
# of the kernel wrappers' launch counts
LAUNCHES_TAG = "kernel launches: "
K1_K4 = ("pack_residuals", "pack_codes", "decode_blocks", "xxh32_blocks")
# (name, script, arguments, kernels it must launch, a line it must print);
# each runs at its default device (cuda) through the shim
ENTRY_SCRIPTS = (
    ("simple_compression", "examples/torch_simple_compression.py", (),
     ("pack_residuals", "decode_blocks", "xxh32_blocks"), "round-trip OK"),
    ("device_pipeline", "examples/torch_device_pipeline.py", (),
     (*K1_K4, "assemble_stream"), "chunked file round-trip OK"),
    ("verify", "tools/torch_verify_on_device.py", (), K1_K4,
     "torch_verify_on_device: 0 failures"),
    ("verify_headline", "tools/torch_verify_on_device.py",
     ("--batch", str(B), "--samples", str(N)), K1_K4,
     "torch_verify_on_device: 0 failures"),
)
DP_SIZES = (1, 2, 4)
DP_STEPS = 5
CLI_MODULE = "airs_compression_tpu_torch.cli"
CLI_BIG_ROWS = 3 * CHUNK_BATCH // 2  # a full batch of chunks and a half one
CLI_SMALL_N = 1 << 20                # 2 MiB: one host block
RESUME_FRAMES = 6                    # frames 0-5, resumed from frame 3
RESUME_AT = 3
CTX_RESUME_N = 1 << 18


def shim_cmd(target: str, args=()) -> "list[str]":
    """A command that runs ``target`` (a script's path, or a module as
    ``python -m`` runs it) with ``args`` in a fresh interpreter and, as it
    exits, prints the kernel wrappers' launch counts on a line of its own
    (LAUNCHES_TAG, then a JSON object)."""
    wrappers = {name: (fn.__module__, fn.__name__)
                for name, (fn, *_) in KERNELS.items()}
    run = ("runpy.run_path(target, run_name='__main__')"
           if target.endswith(".py") else
           "runpy.run_module(target, run_name='__main__', alter_sys=True)")
    code = "\n".join((
        "import importlib, json, runpy, sys",
        f"target, wrappers = {target!r}, {wrappers!r}",
        f"sys.argv = [target, *{list(args)!r}]",
        "try:",
        f"    {run}",
        "finally:",
        f"    print({LAUNCHES_TAG!r} + json.dumps({{name: getattr(",
        "        importlib.import_module(m), f).launches",
        "        for name, (m, f) in wrappers.items()}), flush=True)"))
    return [sys.executable, "-c", code]


def run_entry(name: str, target: str, args, need, card: str,
              expect: "str | None" = None, shim: bool = True,
              rc_want: "int | None" = 0) -> dict:
    """Phase K: one entry point in a process of its own at its default
    device.  It must exit with ``rc_want`` (None: any code but 0) and
    print ``expect``; run through the shim, it must have launched each
    kernel of ``need``.  Prints and returns its report: wall seconds,
    last line, launches (None without the shim), exit code."""
    cmd = shim_cmd(target, args) if shim else [sys.executable, target, *args]
    rc, out, err, s = run_script(cmd, ENTRY_TIMEOUT_S)
    lines = out.strip().splitlines()
    launched = None
    if shim:
        tagged = [ln for ln in lines if ln.startswith(LAUNCHES_TAG)]
        check(bool(tagged), f"phase K {name}: no launch counts printed")
        launched = json.loads(tagged[-1][len(LAUNCHES_TAG):])
        lines = [ln for ln in lines if not ln.startswith(LAUNCHES_TAG)]
    what = f"phase K {name}: exit code {rc}:\n{out[-2000:]}\n{err[-2000:]}"
    check(rc != 0 if rc_want is None else rc == rc_want, what)
    check(expect is None or expect in out, f"{what}\n(no {expect!r})")
    for k in need:
        check(launched[k] > 0, f"phase K {name}: {k} was not launched")
    rep = {"phase": "K", "entry": name, "s": s,
           "last_line": lines[-1] if lines else "", "launches": launched,
           "rc": rc, "card": card}
    print(json.dumps(rep), flush=True)
    return rep


def dp_scaling(card: str, sizes=DP_SIZES, backend: str = "gloo") -> dict:
    """``tools/torch_dp_scaling.py`` over ``sizes`` ranks under
    ``backend``, DP_STEPS timed steps: every row of both curves must be
    correct and no step may make a collective."""
    args = ("--sizes", *map(str, sizes), "--steps", str(DP_STEPS),
            "--backend", backend)
    rep = run_entry(f"dp_scaling {backend}", "tools/torch_dp_scaling.py",
                    args, (), card, shim=False)
    res = json.loads(rep["last_line"])
    rows = res["rows"] + res["fixed_total_rows"]
    check([r["ranks"] for r in res["rows"]] == list(sizes)
          and all(r["correct"] for r in rows) and res["collective_free"],
          f"phase K dp scaling under {backend}: {res}")
    return res


def _concurrently(entries: dict) -> dict:
    """``run_entry(*args, **kwargs)`` for each (args, kwargs) of
    ``entries``, all started together; their reports by key."""
    with concurrent.futures.ThreadPoolExecutor(len(entries)) as pool:
        futures = {key: pool.submit(run_entry, *args, **kwargs)
                   for key, (args, kwargs) in entries.items()}
        return {key: f.result() for key, f in futures.items()}


def cli_process(tmp: pathlib.Path, card: str) -> dict:
    """Phase K: the CLI as a process (``python -m
    airs_compression_tpu_torch.cli``, its default device cuda) under phase
    F's checksummed headline parameters.  A file over one block's limit
    round-trips through the chunked device path (compress: K1, K5, K4;
    its stream over 4 MiB, so decompress_chunked decodes it: K3, K4), a
    2 MiB file through the host codec, the two files side by side; each
    restored file must equal its input.  The big stream with one payload
    byte flipped must exit with the code the in-process ``main`` gives
    for it, and not 0.  Returns each process's report."""
    from airs_compression_tpu_torch.cli.main import main as cli_main

    files = {"big": np.concatenate([make_frames(50, CLI_BIG_ROWS, N).ravel(),
                                    make_frames(51, 1, CLI_TAIL)[0]]),
             "small": make_frames(52, 1, CLI_SMALL_N)[0]}
    need = {"big": (("pack_residuals", "assemble_stream", "xxh32_blocks"),
                    ("decode_blocks", "xxh32_blocks")),
            "small": ((), ())}
    path = {kind: {ext: tmp / f"{kind}{ext}"
                   for ext in (".dat", ".dat.air", ".out")}
            for kind in files}
    for kind, samples in files.items():
        path[kind][".dat"].write_bytes(samples.astype(">u2").tobytes())
    reps = _concurrently({f"{kind} -c": (
        (f"cli -c {kind}", CLI_MODULE,
         ("-c", str(path[kind][".dat"]), "-o", str(path[kind][".dat.air"]),
          "-p", CLI_PARAM_STRING), need[kind][0], card), {})
        for kind in files})
    stream = bytearray(path["big"][".dat.air"].read_bytes())
    stream[tx.CmpHeader.deserialize(bytes(stream))[0].compressed_size // 2] \
        ^= 0x10  # a payload byte of the first frame
    bad = tmp / "corrupt.air"
    bad.write_bytes(stream)
    argv = ("-d", str(bad), "-o", str(tmp / "corrupt.out"))
    with contextlib.redirect_stdout(io.StringIO()):
        rc_in = cli_main(list(argv))
    reps.update(_concurrently({
        **{f"{kind} -d": ((f"cli -d {kind}", CLI_MODULE,
                           ("-d", str(path[kind][".dat.air"]), "-o",
                            str(path[kind][".out"])), need[kind][1], card),
                          {})
           for kind in files},
        "corrupt -d": (("cli -d corrupt", CLI_MODULE, argv, (), card),
                       {"rc_want": None})}))
    for kind in files:
        check(path[kind][".out"].read_bytes()
              == path[kind][".dat"].read_bytes(),
              f"phase K: the CLI's {kind} file did not round-trip")
    sizes = {kind: (path[kind][".dat"].stat().st_size,
                    path[kind][".dat.air"].stat().st_size) for kind in files}
    check(sizes["big"][0] > (1 << 24) - 1 and sizes["big"][1] > 4 << 20
          and sizes["small"][1] < 4 << 20,
          f"phase K: the CLI's files miss their paths: {sizes}")
    check(reps["corrupt -d"]["rc"] == rc_in,
          f"phase K: a corrupt stream exits {reps['corrupt -d']['rc']} as "
          f"a process, {rc_in} in-process")
    return reps


def checkpoint_resume(tmp: pathlib.Path, device, b: int = B, n: int = N,
                      ctx_n: int = CTX_RESUME_N) -> dict:
    """Phase K: the flagship chain (checksummed) on ``device`` at b x n,
    checkpointed after frame RESUME_AT - 1 (``save_batch_state``) and
    resumed by a fresh ``BatchCompressor`` (``load_batch_state``): frames
    RESUME_AT on must equal the unbroken chain's byte for byte, identifier
    bytes included, and a ``BatchDecompressor`` resumed the same way must
    decode them exactly; every restored model is int32 on ``device``.  A
    ``CmpContext`` chain at ``ctx_n`` samples resumed through
    ``save_context`` / ``load_context`` must give the unbroken chain's
    frames, which decode back.  Returns the batch part's launches,
    counted from 0."""
    from airs_compression_tpu_torch.engine import checkpoint

    dev = _build.resolve_device(device)
    t = time.perf_counter()
    frames = [make_frames(60 + k, b, n) for k in range(RESUME_FRAMES)]
    reset_counts()
    tx.set_timestamp_func(_Stamp())
    try:
        whole = tx.BatchCompressor(FLAGSHIP_CS, b, n, device=dev)
        want = [whole.compress_frames(f) for f in frames]
    finally:
        tx.set_timestamp_func(None)
    tx.set_timestamp_func(_Stamp())
    try:
        first = tx.BatchCompressor(FLAGSHIP_CS, b, n, device=dev)
        for f in frames[:RESUME_AT]:
            first.compress_frames(f)
    finally:
        tx.set_timestamp_func(None)
    checkpoint.save_batch_state(first, str(tmp / "bc.npz"))
    resumed = tx.BatchCompressor(FLAGSHIP_CS, b, n, device=dev)
    checkpoint.load_batch_state(resumed, str(tmp / "bc.npz"))
    got = [resumed.compress_frames(f) for f in frames[RESUME_AT:]]
    check(got == want[RESUME_AT:],
          "phase K: the resumed chain's frames != the unbroken chain's")

    bd = tx.BatchDecompressor(FLAGSHIP_CS, b, n, device=dev)
    for c in want[:RESUME_AT]:
        bd.decompress_frames(c)
    checkpoint.save_batch_state(bd, str(tmp / "bd.npz"))
    bd_resumed = tx.BatchDecompressor(FLAGSHIP_CS, b, n, device=dev)
    checkpoint.load_batch_state(bd_resumed, str(tmp / "bd.npz"))
    for k in range(RESUME_AT, RESUME_FRAMES):
        check(np.array_equal(bd_resumed.decompress_frames(want[k]),
                             frames[k]),
              f"phase K: the resumed decompressor's frame {k}")
    for obj, unbroken in ((resumed, first), (bd_resumed, bd)):
        check(obj.model.device == unbroken.model.device
              and obj.model.device.type == dev.type
              and obj.model.dtype == torch.int32,
              f"phase K: a restored model is {obj.model.dtype} on "
              f"{obj.model.device}")
    launched = counts()

    series = make_frames(70, RESUME_FRAMES, ctx_n)
    tx.set_timestamp_func(_Stamp())
    try:
        ctx = tx.CmpContext(FLAGSHIP_CS)
        ctx_want = [ctx.compress_u16(f) for f in series]
    finally:
        tx.set_timestamp_func(None)
    tx.set_timestamp_func(_Stamp())
    try:
        ctx = tx.CmpContext(FLAGSHIP_CS)
        for f in series[:RESUME_AT]:
            ctx.compress_u16(f)
    finally:
        tx.set_timestamp_func(None)
    checkpoint.save_context(ctx, str(tmp / "ctx.npz"))
    ctx = tx.CmpContext(FLAGSHIP_CS)
    checkpoint.load_context(ctx, str(tmp / "ctx.npz"))
    ctx_got = [ctx.compress_u16(f) for f in series[RESUME_AT:]]
    check(ctx_got == ctx_want[RESUME_AT:],
          "phase K: the resumed context's frames != the unbroken chain's")
    decoded, _ = tx.decompress(b"".join(ctx_want))
    check(np.array_equal(decoded, series.ravel()),
          "phase K: the context chain did not decode back")
    return {"blocks": b, "samples": n, "context_samples": ctx_n,
            "frames": RESUME_FRAMES, "resumed_at": RESUME_AT,
            "launches": launched, "s": time.perf_counter() - t}


def run_entry_phase(card: str) -> dict:
    """Phase K: every entry point of the port that no earlier phase runs
    on the card, at its default device: ENTRY_SCRIPTS through the
    launch-counting shim, the distributed example (4 gloo ranks on the
    card), ``tools/torch_dp_scaling.py`` (up to 4 gloo ranks on the
    card), ``tools/torch_cli_throughput.py``, the CLI as a process, then
    checkpoint resume in this process.  Returns the launches summed over
    them and the phase's wall time."""
    t0 = time.perf_counter()
    launched = collections.Counter()
    for name, target, args, need, expect in ENTRY_SCRIPTS:
        launched.update(run_entry(name, target, args, need, card,
                                  expect)["launches"])
    run_entry("distributed_compression",
              "examples/torch_distributed_compression.py", (), (), card,
              "distributed walkthrough OK over 4 ranks", shim=False)
    dp_scaling(card)
    rep = run_entry("cli_throughput", "tools/torch_cli_throughput.py", (),
                    ("pack_residuals", "assemble_stream", "decode_blocks",
                     "xxh32_blocks"), card)
    launched.update(rep["launches"])
    res = json.loads(rep["last_line"])
    gb = res["file_bytes"] / 1e9
    print(json.dumps({
        "phase": "K", "entry": "cli_throughput GB/s",
        "file_bytes": res["file_bytes"],
        "device_encode": gb / res["device_encode_s"],
        "host_encode": gb / res["host_encode_s"],
        "device_decode": gb / res["device_decode_s"],
        "host_decode": res["host_decode_bytes"] / 1e9 / res["host_decode_s"],
        "card": card}), flush=True)
    scratch = pathlib.Path(__file__).resolve().parent / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="phase_k_", dir=scratch) as d:
        for r in cli_process(pathlib.Path(d), card).values():
            launched.update(r["launches"])
        torch.cuda.synchronize()
        resume = checkpoint_resume(pathlib.Path(d), "cuda")
    for k in ("pack_residuals", "decode_blocks", "xxh32_blocks"):
        check(resume["launches"][k] > 0,
              f"phase K: checkpoint resume did not launch {k}")
    launched.update(resume["launches"])
    print(json.dumps({"phase": "K", "entry": "checkpoint_resume", **resume,
                      "card": card}), flush=True)
    wall = time.perf_counter() - t0
    print(json.dumps({"phase": "K", "wall_s": wall,
                      "launches": dict(launched), "card": card}), flush=True)
    return {"launches": dict(launched), "wall_s": wall}


def long_edge_checks(dev) -> "dict[str, int]":
    """The long-stream modes against their plain versions (on the card) at
    small and odd shapes; decompress_long_stream must refuse a lying
    sidecar, a payload cut short and a corrupt payload.  Returns the cases
    per mode."""
    rng = np.random.default_rng(16)
    cases = dict.fromkeys(LONG_KERNELS, 0)

    def hold_pack(codes, max_bits, row_len, first, what, misaligned=False):
        hi, lo, lens = (None if a is None else a.to(dev) for a in codes)
        starts, bits = row_starts(lens, row_len, first)
        width = (first + int(bits) + 31) // 32 + 3
        stream = torch.zeros(width, dtype=torch.int32, device=dev)
        if first:  # header bits before the first row are kept
            words = torch.from_numpy(rng.integers(-2**31, 2**31, width)
                                     .astype(np.int32)).to(dev)
            keep = first // 32
            stream[:keep] = words[:keep]
            if first % 32:  # the bits before `first` in its word
                mask = (0xFFFFFFFF << (32 - first % 32)) & 0xFFFFFFFF
                stream[keep] = words[keep] & (mask - (1 << 32))
        want = stream.clone()
        wb = pack_codes_at_plain(want, hi, lo, lens, row_len, starts,
                                 max_bits)
        if misaligned:
            hi, lo, lens = (None if a is None else _misaligned(a, dev)
                            for a in (hi, lo, lens))
        gb = pack_codes_at(stream, hi, lo, lens, row_len, starts, max_bits)
        check(torch.equal(stream, want) and torch.equal(gb, wb),
              f"K2 long-row edge {what}")
        cases["pack_codes_at"] += 1

    empty = torch.zeros((1, 0), dtype=torch.int32)
    for first in (0, 1, 31, 32, 176):
        for k, row_len, max_bits in LONG_ROW_EDGES + (
                (3000, 1024, 64), (20000, ROW_CODES, 16)):
            codes = _codes(rng, 1, k, max_bits) if k else (None, empty,
                                                           empty)
            hold_pack(tuple(None if a is None else a[0] for a in codes),
                      max_bits, row_len, first, f"k={k} row={row_len} "
                      f"first={first} max_bits={max_bits}")
    # rows whose codes all have length 0, between rows that share words
    hi, lo, lens = _codes(rng, 1, 6000, 48)
    lens[0, 1000:3000] = 0
    hold_pack((hi[0], lo[0], lens[0]), 48, 1000, 33, "zero-length rows")
    # tiles whose bits end on a word boundary: 16-bit codes, and codes
    # whose every tile of 1024 sums to a multiple of 32
    _, lo, lens = _codes(rng, 1, 9000, 16)
    for first in (0, 16, 32):
        hold_pack((None, lo[0], torch.full_like(lens[0], 16)), 16, 3000,
                  first, f"16-bit codes first={first}")
    lens = lens[0].clone()
    for t0 in range(0, lens.numel(), 1024):
        tile = lens[t0: t0 + 1024]
        tile[-1] = (tile[-1] - int(tile.sum())) % 32
    hold_pack((None, lo[0], lens), 31, 9000, 7, "tiles ending on words")
    # arrays 4 bytes past a 16-byte boundary (4-byte copies): rows of one
    # alignment, and rows of 1001 codes, every fourth row on 16 bytes
    for k, row_len, max_bits in ((20000, ROW_CODES, 48), (9000, 1001, 29)):
        codes = _codes(rng, 1, k, max_bits)
        hold_pack(tuple(None if a is None else a[0] for a in codes),
                  max_bits, row_len, 5, f"misaligned k={k} row={row_len}",
                  misaligned=True)
    # more CTAs than the card holds at once (8 an SM on 132 SMs): 1100
    # rows of two tiles, one CTA a row
    check(long_row_ctas("pack_codes_at", 1100, 2048) == 1100,
          "K2 long-row edge: 1100 rows of 2048 codes, one CTA a row")
    codes = _codes(rng, 1, 1100 * 2048, 29)
    hold_pack(tuple(None if a is None else a[0] for a in codes), 29, 2048,
              37, "1100 rows: 1100 CTAs")

    def hold_res(r, enc, g, row_len, first, what, misaligned=False):
        o = derive_encoder_outlier(enc, g, 40) if enc else 0
        r = r.to(dev)
        lens = golomb.encode_codewords(r, enc, g, o)[2]
        starts, bits = row_starts(lens, row_len, first)
        width = (first + int(bits) + 31) // 32 + 3
        want = torch.zeros(width, dtype=torch.int32, device=dev)
        got = want.clone()
        wb = pack_residuals_at_plain(want, r, row_len, starts, enc, g, o)
        gb = pack_residuals_at(got, _misaligned(r, dev) if misaligned else r,
                               row_len, starts, enc, g, o)
        check(torch.equal(got, want) and torch.equal(gb, wb),
              f"K1 long-row edge {what} enc={enc} g={g}")
        cases["pack_residuals_at"] += 1

    for enc, g in K1_EDGE_CONFIGS:
        for k, row_len, _ in LONG_ROW_EDGES + ((20000, ROW_CODES, 0),):
            for first in (0, 1, 31, 32):
                hold_res(_residuals(rng, 1, k)[0], enc, g, row_len, first,
                         f"k={k} row={row_len} first={first}")
    for enc, g in ((1, 4), (2, 2)):
        for k, row_len in ((20000, ROW_CODES), (9000, 1001)):
            hold_res(_residuals(rng, 1, k)[0], enc, g, row_len, 5,
                     f"misaligned k={k} row={row_len}", misaligned=True)
    check(long_row_ctas("pack_residuals_at", 1100, 4096) == 1100,
          "K1 long-row edge: 1100 rows of 4096 codes, one CTA a row")
    hold_res(_residuals(rng, 1, 1100 * 4096)[0], 1, 4, 4096, 37,
             "1100 rows: 1100 CTAs")

    # K3 windows: starts 0-63 into a valid stream, near and past its end,
    # below 0, random words, windows wider than a CTA's shared memory
    outlier = derive_encoder_outlier(1, 4, 40)
    valid, _ = k3_edge_rows(rng, "valid", 1, [4], [outlier], 4096)
    stream = valid[0].to(dev)
    W = stream.numel()

    def hold_windows(words, starts, width, n, what, hdr_bits=16, enc=1,
                     g=4, o=outlier, ends=None):
        st = torch.as_tensor(starts, dtype=torch.int64).to(dev)
        g = torch.as_tensor(g, dtype=torch.int64).expand(st.numel()).to(dev)
        o = torch.as_tensor(o, dtype=torch.int64).expand(st.numel()).to(dev)
        want = decode_windows_plain(words, st, width, hdr_bits, n, enc, g, o)
        got = decode_windows(words, st, width, hdr_bits, n, enc, g, o)
        check(all(torch.equal(a, b) for a, b in zip(want, got)),
              f"K3 window edge {what}")
        if ends is not None:  # sidecar windows end on their boundaries
            check(np.array_equal(got[1].cpu().numpy(), ends),
                  f"K3 window edge {what}: ends off their boundaries")
        cases["decode_windows"] += 1

    hold_windows(stream, list(range(64)), 40, 64, "starts 0-63")
    hold_windows(stream, [32 * W - 64 + k for k in (0, 1, 31, 33, 63)]
                 + [32 * W, 32 * W + 5, 1 << 30], 9, 16, "near and past end")
    hold_windows(stream, [-1, -32, -(1 << 30), 0], 12, 32, "below 0")
    junk = torch.from_numpy(rng.integers(-2**31, 2**31, 3000)
                            .astype(np.int32)).to(dev)
    hold_windows(junk, rng.integers(0, 32 * 3000, 300).tolist(), 30, 48,
                 "junk words")
    hold_windows(stream, [96 + 7 * k for k in range(20)], 60000, 64,
                 "windows wider than shared memory")
    # junk windows decoded as MULTI codes (values over 16 bits), 300
    # windows of 100 and of 400 words: two and four warps a window
    junk = torch.from_numpy(rng.integers(-2**31, 2**31, 20000)
                            .astype(np.int32)).to(dev)
    for width in (100, 400):
        hold_windows(junk, rng.integers(0, 32 * 20000, 300).tolist(), width,
                     512, f"junk MULTI words, {width}-word windows", 16, 2,
                     2, derive_encoder_outlier(2, 2, 40))
    # sidecar windows of a ZERO frame and of a MULTI frame whose spikes
    # make 48-bit escapes: in order, shuffled, duplicated, one window, 13
    # windows (not a multiple of a CTA's 8), among starts below 0 and past
    # the end, and at chunks of 4096 (few windows: four warps a window)
    spiky = make_stream(53, 1 << 15)
    hits = rng.random(spiky.size) < 0.02
    spiky[hits] = rng.integers(0, 1 << 16, int(hits.sum()))
    multi = tx.CmpParams(primary_preprocessing=tx.Preprocessing.DIFF,
                         primary_encoder_type=tx.EncoderType.GOLOMB_MULTI,
                         primary_encoder_param=2,
                         primary_encoder_outlier=40)
    lens = golomb.encode_codewords(
        preprocess.diff_forward(torch.from_numpy(
            spiky.view(np.int16).astype(np.int32))[None].to(dev)),
        2, 2, derive_encoder_outlier(2, 2, 40))[2]
    check(int(lens.max()) > 40, "K3 window edge: no MULTI code over 40 bits")
    for label, params, xs in (("ZERO", CLI_PARAMS, make_stream(54, 1 << 15)),
                              ("MULTI", multi, spiky)):
        frame_w = sp.compress_long_stream(params, xs, device=dev)
        idx_w = sp.stream_chunk_index(params, xs, 256, device=dev)
        words_w, st_w, width_w, hb_w, n_w, enc_w, g_w, o_w = \
            sidecar_windows(frame_w, idx_w, 256, dev)
        st_w = st_w.cpu().numpy()
        ends_w = hb_w + idx_w.astype(np.int64)
        order = rng.permutation(st_w.size)
        dup = np.sort(rng.integers(0, st_w.size, 24))
        dup[5:9] = dup[5]
        W32 = 32 * words_w.numel()
        for what, pick in (("in order", np.arange(st_w.size)),
                           ("shuffled", order), ("duplicated", dup),
                           ("B=1", np.array([7])),
                           ("B=13", np.arange(13) + 40)):
            hold_windows(words_w, st_w[pick], width_w, n_w,
                         f"{label} sidecar {what}", hb_w, enc_w, g_w[0],
                         o_w[0], ends_w[pick])
        hold_windows(words_w, np.concatenate(
            [st_w[:5], [-1, -33, W32, W32 + 9, W32 - 70], st_w[5:10]]),
            width_w, n_w, f"{label} sidecar among starts out of the stream",
            hb_w, enc_w, g_w[0], o_w[0])
        for chunk in (512, 4096):  # two and four warps a window
            idx_w = sp.stream_chunk_index(params, xs, chunk, device=dev)
            words_w, st_w, width_w, hb_w, n_w, enc_w, g_w, o_w = \
                sidecar_windows(frame_w, idx_w, chunk, dev)
            hold_windows(words_w, st_w.cpu().numpy(), width_w, n_w,
                         f"{label} sidecar at chunks of {chunk}", hb_w,
                         enc_w, g_w[0], o_w[0],
                         hb_w + idx_w.astype(np.int64))

    # decompress_long_stream refuses a lying sidecar, a cut payload and a
    # corrupt payload
    xs = make_stream(52, 1 << 16)
    frame = sp.compress_long_stream(CLI_PARAMS, xs, device=dev)
    idx = sp.stream_chunk_index(CLI_PARAMS, xs, SIDECAR_CHUNK, device=dev)
    lie = idx.copy()
    lie[3] += 1
    lie[4] -= 1
    for what, fr, ix, code in (
            ("lying sidecar", frame, lie, tx.CmpErrorCode.INT_BITSTREAM),
            ("payload cut short", frame[:len(frame) // 2], idx,
             tx.CmpErrorCode.INT_HDR),
            ("corrupt payload", frame[:100] + bytes(16) + frame[116:], idx,
             tx.CmpErrorCode.INT_BITSTREAM)):
        try:
            sp.decompress_long_stream(fr, ix, device=dev)
        except tx.CmpError as e:
            check(e.code == code, f"{what}: {e.code.name}, not {code.name}")
        else:
            raise AssertionError(f"{what} decoded without CmpError")
        cases["decode_windows"] += 1

    # K4: one row at N across the stripe boundaries, on both sides of the
    # path switch and of each long-path stage boundary (one stripe either
    # side, and 7 samples past), 0, 4, 8 and 12 bytes past a 16-byte
    # boundary
    stage = 8 * STAGE_STRIPES
    lmin = LONG_MIN_SAMPLES
    check(not k4_long_rows(1, lmin - 1) and k4_long_rows(1, lmin),
          f"K4's path switch is not at {lmin} samples")
    one_row = [1, 7, 8, 9, 15, 16, 17, 4095, lmin - 8, lmin - 1, lmin,
               lmin + 1, lmin + 8, 65537, 7 * stage + 7]
    for k in (2, 3, 4, 5):
        one_row += [k * stage - 8, k * stage + 7, k * stage + 8]
    for n in one_row:
        v = rng.integers(-0x8000, 0x8000, n).astype(np.int32)
        want = int(xxh32_blocks(torch.from_numpy(v)[None])[0])
        check(want == cmp_checksum(v.astype(np.uint16)),
              f"K4 plain one row n={n}")
        buf = torch.empty(n + 3, dtype=torch.int32, device=dev)
        for off in (0, 1, 2, 3):  # int32 samples past the aligned start
            xv = buf[off:off + n]
            xv.copy_(torch.from_numpy(v))
            check(int(checksum_stream_device(xv)) == want,
                  f"K4 one row n={n}, {4 * off} bytes past 16-byte "
                  f"alignment (long path: {k4_long_rows(1, n)})")
            cases["checksum_stream"] += 1
    # streamed in pieces that are not multiples of 8 samples, pieces that
    # straddle stages on the long path
    v = rng.integers(0, 1 << 16, 9 * stage + 1003).astype(np.uint16)
    for cuts in ([], [1], [7, 8, 9], [3, 1000, 1003, 65539, 70000],
                 [stage - 3, stage + lmin + 5, 3 * stage + lmin + 9,
                  3 * stage + lmin + 16, 6 * stage + lmin - 1]):
        hasher = StreamHasher(dev)
        prev = 0
        for c in cuts + [v.size]:
            hasher.update(torch.from_numpy(v[prev:c].view(np.int16)).to(dev))
            prev = c
        check(hasher.intdigest() == cmp_checksum(v),
              f"K4 streamed in pieces cut at {cuts}")
        cases["xxh32_lanes"] += 1
    # lanes: each row its own, on both paths (b = 1, 3, 5 long; b across
    # the SM count)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    check(k4_long_rows(sms, lmin) and not k4_long_rows(sms + 1, lmin),
          f"K4's path switch is not at {sms} rows")
    for b, n in ((1, 8), (3, 64), (1, 1 << 16), (5, 8000), (1, lmin),
                 (3, 3 * stage + 8), (5, 5 * stage - 8), (5, 2 * stage + 16),
                 (sms, lmin), (sms + 1, lmin)):
        x = torch.from_numpy(rng.integers(-0x8000, 0x8000, (b, n))
                             .astype(np.int32))
        lanes = torch.from_numpy(rng.integers(-2**31, 2**31, (b, 4))
                                 .astype(np.int32))
        want = xxh32_lanes_plain(lanes.clone(), x)
        got = xxh32_lanes(lanes.to(dev), x.to(dev))
        check(torch.equal(got.cpu(), want),
              f"K4 lanes b={b} n={n} (long path: {k4_long_rows(b, n)})")
        cases["xxh32_lanes"] += 1
    return cases


def sidecar_windows(frame: bytes, idx, chunk: int, dev):
    """decode_windows's arguments for a long frame's sidecar windows, as
    parallel/sp.py decompress_long_stream builds them: (words, starts,
    width, hdr_bits, chunk, enc, g, outlier)."""
    hdr, hsz = tx.CmpHeader.deserialize(frame)
    hb = PassConfig(0, hdr.encoder_type, hdr.encoder_param,
                    hdr.encoder_outlier, bool(hdr.checksum_enabled),
                    0).hdr_bits
    padded = np.zeros(len(frame) + (-len(frame)) % 4, np.uint8)
    padded[: len(frame)] = np.frombuffer(frame, np.uint8)
    words = _bytes_to_be_words(padded[None], dev)[0]
    chunk_bits = np.asarray(idx, np.int64)
    off = 8 * hsz + np.concatenate(([0], np.cumsum(chunk_bits)[:-1]))
    width = (hb + int(chunk_bits.max()) + 63) // 32 + 2
    g, o = (torch.full((idx.size,), v, dtype=torch.int64, device=dev)
            for v in (hdr.encoder_param, hdr.encoder_outlier))
    return (words, torch.from_numpy(off - hb).to(dev), width, hb, chunk,
            hdr.encoder_type, g, o)


def long_kernel_checks(inputs, card: str) -> dict:
    """The long-stream modes against their plain versions on phase G's
    inputs (the one stream's residuals, the feed_many buffer's codes, the
    frame's windows, the stream's samples), with their times and bounds,
    then the edge cases."""
    dev = torch.device("cuda")
    x, frame, idx, many = inputs
    n = x.size
    cfg = make_pass_config(CLI_PARAMS, False)
    out = {}
    xd = torch.from_numpy(x.view(np.int16)).to(dev).int()

    # K1 long-row: the stream's DIFF residuals into its frame's stream
    res = preprocess.diff_forward(xd[None])[0]
    lens = golomb.encode_codewords(res, 1, cfg.g_par, cfg.outlier)[2]
    starts, bits = row_starts(lens, ROW_CODES, cfg.hdr_bits)
    W = worst_case_words(cfg, n)
    k1_args = (res, ROW_CODES, starts, 1, cfg.g_par, cfg.outlier)
    got = torch.zeros(W, dtype=torch.int32, device=dev)
    want = torch.zeros(W, dtype=torch.int32, device=dev)
    err = max(max_abs_err(pack_residuals_at(got, *k1_args),
                          pack_residuals_at_plain(want, *k1_args)),
              max_abs_err(from_bits(got), from_bits(want)))
    used = (cfg.hdr_bits + int(bits) + 31) // 32
    out["pack_residuals_at"] = dict(
        max_abs_err=err, rows=starts.numel(),
        **timings(lambda: pack_residuals_at(got, *k1_args),
                  "pack_residuals_at"),
        plain_ms=cuda_ms(lambda: pack_residuals_at_plain(want, *k1_args), 3),
        bytes=4 * n + 8 * starts.numel() + 4 * used)

    # K2 long-row: the feed_many buffer's ZERO codes (one call's 16 chunks)
    # from a start bit off the word grid, as a feed packs them
    r2 = preprocess.diff_forward(many[:16].reshape(1, -1).int())[0]
    _, lo, lens2 = golomb.encode_codewords(r2, 1, cfg.g_par, cfg.outlier)
    first = cfg.hdr_bits + 5
    starts2, bits2 = row_starts(lens2, ROW_CODES, first)
    W2 = (first + int(bits2) + 31) // 32 + 1
    k2_args = (None, to_bits(lo), lens2.int(), ROW_CODES, starts2,
               cfg.worst_bits_per_sample)
    got = torch.zeros(W2, dtype=torch.int32, device=dev)
    want = torch.zeros(W2, dtype=torch.int32, device=dev)
    err = max(max_abs_err(pack_codes_at(got, *k2_args),
                          pack_codes_at_plain(want, *k2_args)),
              max_abs_err(from_bits(got), from_bits(want)))
    out["pack_codes_at"] = dict(
        max_abs_err=err, rows=starts2.numel(),
        **timings(lambda: pack_codes_at(got, *k2_args), "pack_codes_at"),
        plain_ms=cuda_ms(lambda: pack_codes_at_plain(want, *k2_args), 3),
        bytes=8 * lens2.numel() + 8 * starts2.numel() + 4 * (W2 - 1))

    # K3 windows: the frame's chunks from the sidecar, as the decode runs
    hb = cfg.hdr_bits
    chunk_bits = idx.astype(np.int64)
    k3_args = sidecar_windows(frame, idx, SIDECAR_CHUNK, dev)
    words, st, width = k3_args[:3]
    vk, ek = decode_windows(*k3_args)
    t = time.perf_counter()
    vp, ep = decode_windows_plain(*k3_args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t)
    err = max(max_abs_err(from_bits(vk), from_bits(vp)), max_abs_err(ek, ep))
    check(np.array_equal(ek.cpu().numpy(), hb + chunk_bits),
          "K3 windows: ends off their boundaries")
    out["decode_windows"] = dict(
        max_abs_err=err, windows=int(idx.size), width=width,
        **timings(lambda: decode_windows(*k3_args), "decode_windows"),
        plain_ms=plain_ms,
        bytes=4 * words.numel() + 20 * idx.size + 4 * n + 4 * idx.size)

    # K4: the one row of 2^22 samples (its plain version on the CPU copy:
    # a chain of small ops runs faster there) and one feed_many call's
    # stripes as the streaming form takes them
    hk = checksum_stream_device(xd)
    xc = xd.cpu()
    t = time.perf_counter()
    hp = xxh32_blocks(xc[None])[0]
    plain_ms = 1e3 * (time.perf_counter() - t)
    check(int(hk) == cmp_checksum(x), "K4 one row != host XXH32")
    out["checksum_stream"] = dict(
        max_abs_err=max_abs_err(hk.cpu(), hp),
        **timings(lambda: checksum_stream_device(xd), "checksum_stream"),
        plain_ms=plain_ms, bytes=4 * n + 4)
    feed = many[:16].reshape(1, -1).int()
    lanes0 = torch.from_numpy(np.random.default_rng(17).integers(
        -2**31, 2**31, (1, 4)).astype(np.int32))
    lk = xxh32_lanes(lanes0.clone().to(dev), feed)
    t = time.perf_counter()
    lp = xxh32_lanes_plain(lanes0.clone(), feed.cpu())
    plain_ms = 1e3 * (time.perf_counter() - t)
    lanes = lanes0.to(dev)
    out["xxh32_lanes"] = dict(
        max_abs_err=max_abs_err(from_bits(lk.cpu()), from_bits(lp)),
        samples=feed.numel(),
        **timings(lambda: xxh32_lanes(lanes, feed), "xxh32_lanes"),
        plain_ms=plain_ms, bytes=4 * feed.numel() + 32)
    print(json.dumps({"long_kernels": out, "card": card}), flush=True)
    print(json.dumps({"long_edge_cases": long_edge_checks(dev)}), flush=True)
    for name, res in out.items():
        check(res["max_abs_err"] == 0, f"{name} disagrees with its plain "
              f"version: max abs err {res['max_abs_err']}")
    return out


def long_row_ctas(name: str, rows: int, row_len: int) -> int:
    """CTAs of a long-row launch of ``name`` over ``rows`` rows of
    ``row_len`` codes (the kernel's own count, airs_pack_long_ctas)."""
    fn = _build.function("pack", "airs_pack_long_ctas",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_int])
    return fn(rows, row_len, int(name == "pack_residuals_at"))


def mesh_cards(smi: str) -> None:
    """Phase H with one NCCL rank on each visible card (rank r on
    ``cuda:r``), held against phases A's, B's and G's one-card outputs,
    which run first on card 0."""
    _, comp_a = run_phase("A", HEADLINE, [make_frames(s) for s in range(4)],
                          ("pack_residuals", "decode_blocks"))
    _, comp_b = run_phase("B", FLAGSHIP_CS,
                          [make_frames(10 + s) for s in range(4)],
                          ("pack_residuals", "decode_blocks",
                           "xxh32_blocks"))
    _, long_inputs, chain_g = run_long_phase(LONG_KERNELS, smi)
    run_mesh_phase(comp_a, comp_b, long_inputs[1], chain_g, smi,
                   (("nccl", torch.cuda.device_count()),))
    dp_scaling(smi, backend="nccl")
    print(smi, flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t
    t = time.perf_counter()
    native.get_lib()  # g++ builds the host core; a failure raises
    print(json.dumps({"build_s": build_s,
                      "native_build_s": time.perf_counter() - t}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if sys.argv[1:] == ["--mesh-cards"]:
        mesh_cards(smi)
        return 0

    batches_a = [make_frames(seed) for seed in range(4)]
    rep_a, comp_a = run_phase("A", HEADLINE, batches_a,
                              ("pack_residuals", "decode_blocks"))
    batches_b = [make_frames(10 + seed) for seed in range(4)]
    rep_b, comp_b = run_phase("B", FLAGSHIP_CS, batches_b,
                              ("pack_residuals", "decode_blocks",
                               "xxh32_blocks"))
    batches_d = [make_widening_frames(20 + seed) for seed in range(4)]
    rep_d, packed_d = run_packed_phase(
        "D", HEADLINE, batches_d,
        ("select_params", "pack_codes", "assemble_stream", "decode_blocks"))
    batches_e = [make_widening_frames(30 + seed, spikes=True)
                 for seed in range(4)]
    rep_e, _ = run_packed_phase(
        "E", FLAGSHIP_CS, batches_e,
        ("select_params", "pack_codes", "assemble_stream", "decode_blocks",
         "xxh32_blocks"))
    rep_f = run_cli_phase(("pack_residuals", "assemble_stream",
                           "decode_blocks", "xxh32_blocks"))
    rep_g, long_inputs, chain_g = run_long_phase(LONG_KERNELS, smi)
    run_examples(smi)
    rep_h = run_mesh_phase(comp_a, comp_b, long_inputs[1], chain_g, smi)
    rep_i = run_coalesce_phase(smi, rep_g["chain_host_decode_s"])
    run_soak_phase(smi)
    rep_k = run_entry_phase(smi)

    multi_codes = {}
    results = kernel_checks(comp_a, comp_b, batches_b, multi_codes)
    results.update(packed_kernel_checks(batches_d, batches_e, packed_d,
                                        multi_codes))
    print(json.dumps({"multi_codes": multi_codes}), flush=True)
    results.update(long_kernel_checks(long_inputs, smi))
    for name, res in results.items():
        check(res["max_abs_err"] == 0, f"{name} disagrees with its plain "
              f"version: max abs err {res['max_abs_err']}")
    kernels = []
    for name, (_, source, replaces, _) in KERNELS.items():
        res = results[name]
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(r["launches"].get(name, 0) for r in (
                rep_a, rep_b, rep_d, rep_e, rep_f, rep_g, rep_h, rep_i,
                rep_k)),
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "ms_by": res["ms_by"], "events_ms": res["events_ms"],
            "call_ms": res["call_ms"], "plain_ms": res["plain_ms"],
            "bound_ms": 1e3 * res["bytes"] / HBM_BYTES_PER_S,
            "bound_by": "bytes", "library_ms": None}
        if name in LONG_ROW_KERNELS:  # the main path's launches by rows
            by_rows = collections.Counter()
            for rep in (rep_g, rep_h):
                by_rows.update({int(r): k for r, k in
                                rep["launch_rows"][name].items()})
            row["launches_by_rows"] = dict(sorted(by_rows.items()))
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
