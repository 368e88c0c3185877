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
* phase C — each kernel (K1 pack_residuals, K2 pack_codes, K3
  decode_blocks, K4 xxh32_blocks, K5 assemble_stream) against its plain
  PyTorch version on the card, on the phases' inputs and at small odd
  shapes, with CUDA-event times, and a corrupt batch and a corrupt stream
  that must raise ``CmpError``.  K3 is also held on valid, truncated,
  junk, all-ones and all-zero rows under every encoder with per-block g
  from 1 to 0xFFFF, at B=1, N=1 and N=7, on a misaligned row matrix, on
  rows wider than a CTA's shared memory and on the lanes outside a method
  group; its synchronise rounds per block on phase A's and B's frames are
  printed.  K4 is held at N from 1 to 8192 across the stripe boundaries,
  B from 1 to 512, and on misaligned rows.  K1 and K2 are held at N from 1
  to 8193 across the tile and 16-byte boundaries, B from 1 to 512, every
  encoder with g a power of two and not (K1), codes to 29, 48 and 64 bits
  and lengths over the maximum (K2), on matrices 4 bytes past a 16-byte
  boundary and on rows of 60,000 payload words; both are also timed on
  the MULTI codes (phase B's residuals, phase E's codes).

Every phase requires an exact round trip and frames (or streams)
byte-identical to the port's CPU path (the plain versions) on the same
input and identifiers; phases D and E also require the stream to equal the
joined ``compress_frames`` output and every size to equal its header's
``compressed_size``.  Each kernel of a phase must have been launched in
that phase's run (counts set to 0 just before it).  Any failed check exits
non-zero.  The last lines of standard output are the kernels' JSON line,
the card's name and power limit (nvidia-smi), and the result line.
Without a CUDA card it exits with code 2 and prints no result.

    python3 chip_smoke.py --pack-sweep

builds K1 and K2 at each tile geometry of ``PACK_SWEEP`` instead, holds
each build against the port's own on the main path's inputs and prints
their kernel times, two rounds in turn.
"""

from __future__ import annotations

import collections
import ctypes
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import airs_compression_tpu_torch as tx
from airs_compression_tpu_torch import _build
from airs_compression_tpu_torch.models.stream import _bytes_to_be_words
from airs_compression_tpu_torch.ops import adapt, preprocess
from airs_compression_tpu_torch.ops.assemble import (
    assemble_stream,
    assemble_stream_plain,
)
from airs_compression_tpu_torch.ops.decode_kernel import (
    decode_blocks,
    decode_codes_plain,
)
from airs_compression_tpu_torch.ops.encode import (
    adaptive_worst_bits,
    adaptive_worst_case_words,
    encode_blocks_adaptive,
    make_pass_config,
)
from airs_compression_tpu_torch.ops import pack as pack_ops
from airs_compression_tpu_torch.ops.pack import (
    code_words,
    pack_codes,
    pack_codes_plain,
    pack_residuals,
    pack_residuals_plain,
    payload_words,
)
from airs_compression_tpu_torch.ops.u32 import from_bits, to_bits
from airs_compression_tpu_torch.ops.xxh32_device import (
    checksum_blocks_device,
    xxh32_blocks,
)
from airs_compression_tpu_torch.utils.bits import derive_encoder_outlier
from airs_compression_tpu_torch.utils.xxh32 import cmp_checksum

B, N = 512, 8192
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
TIMED_RUNS = 10

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
}


class _Stamp:
    """Deterministic timestamp source, so two runs draw the same ids."""

    def __init__(self):
        self.counter = 0

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


def reset_counts() -> None:
    for fn, *_ in KERNELS.values():
        fn.launches = 0


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


def timings(fn, name: str) -> "dict[str, float]":
    """A kernel wrapper's times: ``ms`` the CUDA kernel's own device time,
    ``call_ms`` one wrapper call between two events, the host's work in
    the call included (how chip_smoke.py timed kernels before).  A trace
    that lost the kernel's device records (seen once on an H100) is taken
    again, up to three times in all."""
    ms = None
    for _ in range(3):
        ms = kernel_ms(fn, KERNELS[name][3], TIMED_RUNS)
        if ms is not None:
            break
    check(ms is not None, f"{name}: the profiler saw no device time")
    return dict(ms=ms, call_ms=cuda_ms(fn, TIMED_RUNS))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


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
    return cases


# K1's edge configurations: every encoder, g a power of two and not
K1_EDGE_CONFIGS = ((0, 0), (1, 4), (1, 5), (2, 2), (2, 3))
PACK_EDGE_N = (1, 7, 8191, 8192, 8193)
PACK_EDGE_B = (1, 3, 512)


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


def edge_checks(dev) -> None:
    """Kernels against their plain versions at small and odd shapes, every
    encoder type, and on random words (malformed codes, poisoned ends)."""
    print(json.dumps({"edge_cases": {"pack_residuals": k1_edge_checks(dev),
                                     "pack_codes": k2_edge_checks(dev),
                                     "decode_blocks": k3_edge_checks(dev),
                                     "xxh32_blocks": k4_edge_checks(dev)}}),
          flush=True)
    rng = np.random.default_rng(7)
    # K5: frames of 0-3 bytes, odd B, B=1 and B=0
    for sizes in ([0, 1, 2, 3, 3, 2, 1], [3], [1, 0, 2], [9, 0, 7, 4, 5],
                  []):
        w = 3
        words = torch.from_numpy(rng.integers(
            -2**31, 2**31, (len(sizes), w)).astype(np.int32))
        sz = torch.tensor(sizes, dtype=torch.int32)
        want = assemble_stream_plain(words, sz)
        got = assemble_stream(words.to(dev), sz.to(dev))
        check(torch.equal(want, got.cpu()), f"K5 edge sizes={sizes}")


def k2_inputs(batches_d, batches_e):
    """K2's arguments on the main path: phase D's adaptive ZERO codes (no
    hi) and phase E's secondary MULTI codes against the model (48-bit
    escapes), as the encoder makes them; the kernel reads int32 words."""
    dev = torch.device("cuda")
    ladder = tx.DEFAULT_LADDER
    x_d = torch.from_numpy(batches_d[0].view(np.int16)).to(dev).int()
    r = preprocess.diff_forward(x_d)
    g, _ = adapt.select_golomb_zero(r, ladder)
    _, lo, lens = adapt.encode_codewords_dynamic(r, g)
    zero_args = (None, to_bits(lo), lens.int(),
                 adaptive_worst_bits(make_pass_config(HEADLINE, False),
                                     ladder))
    x_e = [torch.from_numpy(f.view(np.int16)).to(dev).int()
           for f in batches_e[:2]]
    r = preprocess.model_forward(x_e[1], x_e[0])
    multi = make_pass_config(FLAGSHIP_CS, True)
    g, o, _ = adapt.select_golomb_multi(r, multi.raw_outlier, ladder)
    hi, lo, lens = adapt.encode_codewords_dynamic_multi(r, g, o)
    return zero_args, (to_bits(hi), to_bits(lo), lens.int(), 48)


def packed_kernel_checks(batches_d, batches_e, packed_d, multi_codes):
    """Phase C for K2 and K5, on phases D and E's inputs; K2's report on
    phase E's MULTI codes goes into ``multi_codes``."""
    dev = torch.device("cuda")
    out = {}
    zero = make_pass_config(HEADLINE, False)
    ladder = tx.DEFAULT_LADDER

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

    # K5: the frame words phase D's encoder makes, and the stream it made
    x_d = torch.from_numpy(batches_d[0].view(np.int16)).to(dev).int()
    nw = adaptive_worst_case_words(zero, N, ladder)
    z = torch.zeros((B,), dtype=torch.int64, device=dev)
    words, sizes, _, _ = encode_blocks_adaptive(
        zero, None, x_d, torch.zeros_like(x_d), z.int(), z, z, z, nw, ladder)
    words = to_bits(words)
    total = int(sizes.sum())
    sk = assemble_stream(words, sizes, total)
    sp = assemble_stream_plain(words, sizes)
    check(sk.shape == sp.shape, "K5 stream length")
    err = max_abs_err(sk, sp)
    # the same words under phase D's identifiers give phase D's stream
    # bytes past each header's identifier field
    stream, _ = packed_d[0]
    check(len(stream) == total, "K5 stream length != phase D stream")
    out["assemble_stream"] = dict(
        max_abs_err=err,
        **timings(lambda: assemble_stream(words, sizes, total),
                  "assemble_stream"),
        plain_ms=cuda_ms(lambda: assemble_stream_plain(words, sizes), 3),
        bytes=2 * total + 4 * B)

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


def sync_rounds(bd, batches, dev) -> "dict[str, float]":
    """Mean and max of K3's synchronise rounds per block over a phase's
    frame batches (each batch one method: ZERO or MULTI)."""
    rounds = []
    for frames in batches:
        st = bd.stage_frames(frames)
        enc = int(st.enc[0])
        check((st.enc == enc).all(), "one method per batch")
        cfg = make_pass_config(HEADLINE if enc == 1 else FLAGSHIP_CS,
                               enc == 2)
        r = torch.empty((B,), dtype=torch.int32, device=dev)
        decode_blocks(_bytes_to_be_words(st.buf, dev), cfg.hdr_bits, N, enc,
                      torch.from_numpy(st.g.astype(np.int64)).to(dev),
                      torch.from_numpy(st.outlier.astype(np.int64)).to(dev),
                      rounds=r)
        rounds.append(r.cpu())
    r = torch.cat(rounds).double()
    return {"blocks": r.numel(), "mean": r.mean().item(),
            "max": int(r.max())}


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
    print(json.dumps({"k3_sync_rounds": {
        "A": sync_rounds(bd, comp_a, dev), "B": sync_rounds(bd, comp_b, dev)}}),
        flush=True)

    # K3 on the lanes outside a method group, as decode_staged decodes them
    # in a mixed batch: phase B's MULTI frames decoded as ZERO with g=1,
    # outlier=1, against the plain version on the CPU
    words, hdr_bits, _, _, g, o = k3_cases[1][0]
    garbage = (words, hdr_bits, N, 1, torch.ones_like(g), torch.ones_like(o))
    rounds = torch.empty((B,), dtype=torch.int32, device=dev)
    vk, ek = decode_blocks(*garbage, rounds=rounds)
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
                                         "decode_blocks_kernel", TIMED_RUNS),
        "rounds_mean": rounds.double().mean().item(),
        "rounds_max": int(rounds.max())}}), flush=True)

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


# (threads per CTA, K1's and K2's codes per thread) of the builds that
# --pack-sweep times; the first is the port's own
PACK_SWEEP = ((256, 8, 4), (256, 4, 4), (512, 8, 4), (256, 16, 8),
              (128, 16, 8), (128, 8, 8))


def pack_variant(geometry):
    """K1's and K2's C entries from a build of csrc/pack.cu at another tile
    geometry, called as ops/pack.py's wrappers call theirs."""
    threads, k1_per, k2_per = geometry
    path = _build.build(["pack"], (("AIRS_PACK_THREADS", threads),
                                   ("AIRS_PACK_K1_PER", k1_per),
                                   ("AIRS_PACK_K2_PER", k2_per)))["pack"]
    lib = ctypes.CDLL(str(path))
    entries = []
    for symbol, argtypes in (("airs_pack_residuals",
                              pack_ops._RESIDUAL_ARGTYPES),
                             ("airs_pack_codes", pack_ops._CODES_ARGTYPES)):
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        entries.append(fn)
    ptr = _build.ptr

    def launch(fn, b, c, head, tail, like):
        payload = torch.empty((b, c), dtype=torch.int32, device=like.device)
        bits = torch.empty((b,), dtype=torch.int32, device=like.device)
        err = fn(*head, c, *tail, ptr(payload), ptr(bits),
                 _build.stream_arg(like))
        check(err == 0, f"pack {geometry}: launch error {err}")
        return payload, bits

    def residuals(r, enc, g, outlier):
        b, n = r.shape
        return launch(entries[0], b, payload_words(enc, g, n),
                      (ptr(r), b, n), (enc, g, outlier), r)

    def codes(hi, lo, lens, max_bits):
        b, k = lens.shape
        return launch(entries[1], b, code_words(max_bits, k),
                      (None if hi is None else ptr(hi), ptr(lo), ptr(lens),
                       b, k), (), lens)

    return {"pack_residuals": residuals, "pack_codes": codes}


def pack_sweep() -> None:
    """K1 and K2 built at each geometry of PACK_SWEEP, held against the
    port's build and timed (torch.profiler, as ``ms`` in the kernels
    line) on the main path's four inputs, two rounds in turn."""
    t = time.perf_counter()
    variants = {geo: pack_variant(geo) for geo in PACK_SWEEP}
    print(json.dumps({"sweep_build_s": time.perf_counter() - t}), flush=True)
    k1 = k1_inputs(make_frames(0), [make_frames(10), make_frames(11)])
    k2 = k2_inputs([make_widening_frames(20)],
                   [make_widening_frames(30 + i, spikes=True)
                    for i in range(2)])
    cases = {"k1_zero": ("pack_residuals", k1[0]),
             "k1_multi": ("pack_residuals", k1[1]),
             "k2_zero": ("pack_codes", k2[0]),
             "k2_multi": ("pack_codes", k2[1])}
    want = {case: KERNELS[name][0](*args)
            for case, (name, args) in cases.items()}
    for rnd in range(2):
        for geo, fns in variants.items():
            row = {"threads": geo[0], "k1_per": geo[1], "k2_per": geo[2],
                   "round": rnd}
            for case, (name, args) in cases.items():
                fn = fns[name]
                check(all(torch.equal(a, b) for a, b in
                          zip(fn(*args), want[case])),
                      f"pack {geo} {case} != the port's build")
                row[f"{case}_ms"] = kernel_ms(lambda: fn(*args),
                                              KERNELS[name][3], TIMED_RUNS)
            print(json.dumps({"pack_sweep": row}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t = time.perf_counter()
    _build.build()
    print(json.dumps({"build_s": time.perf_counter() - t}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if sys.argv[1:] == ["--pack-sweep"]:
        pack_sweep()
        print(smi, flush=True)
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
        ("pack_codes", "assemble_stream", "decode_blocks"))
    batches_e = [make_widening_frames(30 + seed, spikes=True)
                 for seed in range(4)]
    rep_e, _ = run_packed_phase(
        "E", FLAGSHIP_CS, batches_e,
        ("pack_codes", "assemble_stream", "decode_blocks", "xxh32_blocks"))

    multi_codes = {}
    results = kernel_checks(comp_a, comp_b, batches_b, multi_codes)
    results.update(packed_kernel_checks(batches_d, batches_e, packed_d,
                                        multi_codes))
    print(json.dumps({"multi_codes": multi_codes}), flush=True)
    for name, res in results.items():
        check(res["max_abs_err"] == 0, f"{name} disagrees with its plain "
              f"version: max abs err {res['max_abs_err']}")
    kernels = []
    for name, (_, source, replaces, _) in KERNELS.items():
        res = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(r["launches"][name]
                            for r in (rep_a, rep_b, rep_d, rep_e)),
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "call_ms": res["call_ms"], "plain_ms": res["plain_ms"],
            "bound_ms": 1e3 * res["bytes"] / HBM_BYTES_PER_S,
            "bound_by": "bytes", "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
