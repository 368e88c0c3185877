"""The port's completeness map: every file of the JAX package, its tools
and its examples has a counterpart in the port, and every public
top-level name of each has one in its counterpart, unless ``NOT_PORTED``
gives the reason it has none.

Names are read with ``ast`` (nothing is imported).  A file's public names
are its top-level functions, classes and assignments not led by ``_``,
and its ``__all__``; its counterpart's names are everything it binds at
top level (imports included: a re-export counts; ``__all__`` alone binds
nothing).  Each entry of
``NOT_PORTED`` must name a public name of its file that the counterpart
lacks, so the table cannot go stale.  ``ROADMAP.md``'s "Not to port"
list is this table.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

# JAX file -> the port's file, where the port's is not the same path with
# airs_compression_tpu_torch/ for the package and torch_ before the name
# for a tool or an example
COUNTERPARTS = {
    "airs_compression_tpu/ops/bitpack.py": "airs_compression_tpu_torch/ops/pack.py",
    "airs_compression_tpu/ops/pallas_pack.py": "airs_compression_tpu_torch/ops/pack.py",
    "airs_compression_tpu/ops/pallas_decode.py":
        "airs_compression_tpu_torch/ops/decode_kernel.py",
    "airs_compression_tpu/ops/pallas_assemble.py":
        "airs_compression_tpu_torch/ops/assemble.py",
    # the repository's lint (stdlib only) lints both packages
    "tools/lint.py": "tools/lint.py",
}

_CLAMP = ("the entropy clamp: the port's packers size every payload by the "
          "worst case and cannot overflow, so there is no cap, re-encode or "
          "rollback to port")
_PALLAS = ("a Pallas entry point: the port launches its CUDA kernel through "
           "the wrapper of the same function on a CUDA tensor (K1/K2 "
           "pack_residuals/pack_codes, K3 decode_blocks, K4 xxh32_blocks, "
           "K5 assemble_stream)")
_PROBE = ("asks whether Mosaic lowers the kernel on the JAX backend; a port "
          "wrapper launches its kernel on a CUDA tensor and runs the plain "
          "version on a CPU one")
_TREE = ("XLA's bit packer (a tree of funnel-shift merges and its scan); the "
         "port packs codes with K2, ops/pack.pack_codes, and its plain "
         "version")

# JAX file -> {public name: why the port has no counterpart}
NOT_PORTED = {
    "airs_compression_tpu/ops/encode.py": {
        "default_cap_bits": _CLAMP,
        "clamped_frame_words": _CLAMP,
        "adaptive_cap_bits": _CLAMP,
    },
    "airs_compression_tpu/ops/pallas_pack.py": {
        "clamped_payload_words": _CLAMP,
        "pack_residuals_pallas": _PALLAS,
        "pack_codes_tree_pallas": _PALLAS,
        "pallas_pack_supported": _PROBE,
    },
    "airs_compression_tpu/ops/pallas_decode.py": {
        "decode_blocks_pallas": _PALLAS,
        "pallas_decode_supported": _PROBE,
    },
    "airs_compression_tpu/ops/pallas_assemble.py": {
        "assemble_stream_pallas": _PALLAS,
        "stream_capacity_words": (
            "the bucketed size of the TPU assembly kernel's padded output; "
            "K5 writes the stream's exact bytes"),
    },
    "airs_compression_tpu/ops/xxh32_device.py": {
        "xxh32_blocks_pallas": _PALLAS,
        "pallas_xxh32_supported": _PROBE,
        "use_device_checksum": (
            "routes the checksum by JAX backend and an environment "
            "variable; the port routes by the tensor's device"),
    },
    "airs_compression_tpu/ops/bitpack.py": {
        "pack_codes_tree": _TREE,
        "merge_streams_tree": _TREE,
        "exclusive_cumsum": _TREE,
    },
    "airs_compression_tpu/ops/adapt.py": {
        "ladder_fast_div": (
            "whether _div_by_g's multiply-shift divide is exact for a "
            "ladder: the TPU has no integer divide; the port's exact // "
            "gives the same codes"),
    },
    "airs_compression_tpu/models/stream.py": {
        "bswap32": (
            "a byte swap fused into the XLA decode programs; the port reads "
            "big-endian words once on staging (_bytes_to_be_words)"),
    },
    "airs_compression_tpu/ops/golomb.py": {
        "ilog2_u32": "an alias of ilog2, which the port has",
    },
    "airs_compression_tpu/utils/profiling.py": {
        "ThroughputMeter": (
            "rolling byte and time counters that nothing read; the port "
            "counts its transfers on models/stream.py's _upload and _fetch "
            "and times its stages by spans (utils/profiling.span)"),
    },
}


def _jax_files() -> "list[str]":
    files = sorted(p.relative_to(REPO).as_posix()
                   for p in (REPO / "airs_compression_tpu").rglob("*.py"))
    for folder in ("tools", "examples"):
        files += sorted(p.relative_to(REPO).as_posix()
                        for p in (REPO / folder).glob("*.py")
                        if not p.name.startswith("torch_"))
    return files


JAX_FILES = _jax_files()


def counterpart(rel: str) -> str:
    if rel in COUNTERPARTS:
        return COUNTERPARTS[rel]
    top, rest = rel.split("/", 1)
    if top == "airs_compression_tpu":
        return f"airs_compression_tpu_torch/{rest}"
    return f"{top}/torch_{rest}"


def _statements(body):
    """Top-level statements, those inside module-level if/try/with too."""
    for node in body:
        yield node
        if isinstance(node, (ast.If, ast.Try, ast.With)):
            for part in (node.body, getattr(node, "orelse", []),
                         getattr(node, "finalbody", []),
                         *(h.body for h in getattr(node, "handlers", []))):
                yield from _statements(part)


def _all(tree) -> "set[str]":
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return set(ast.literal_eval(node.value))
    return set()


def defined(tree) -> "set[str]":
    """Names a module's own top-level code defines (imports left out)."""
    out = set()
    for node in _statements(tree.body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out |= {n.id for t in targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)}
    return out


def bound(tree) -> "set[str]":
    """Every name a module binds at top level, imports included."""
    out = defined(tree)
    for node in _statements(tree.body):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return out


def public(tree) -> "set[str]":
    return {n for n in defined(tree) if not n.startswith("_")} | _all(tree)


def _tree(rel: str):
    return ast.parse((REPO / rel).read_text(), filename=rel)


def test_jax_files_found():
    assert "airs_compression_tpu/models/stream.py" in JAX_FILES
    assert "tools/build_docs.py" in JAX_FILES
    assert "examples/simple_compression.py" in JAX_FILES
    assert set(NOT_PORTED) <= set(JAX_FILES)


@pytest.mark.parametrize("rel", JAX_FILES)
def test_counterpart(rel):
    port = counterpart(rel)
    assert (REPO / port).is_file(), f"{rel} has no counterpart {port}"
    names = public(_tree(rel))
    have = bound(_tree(port))
    reasons = NOT_PORTED.get(rel, {})
    missing = sorted(names - have - set(reasons))
    assert missing == [], f"{port} lacks {missing} of {rel}"
    # the table names only public names of the file that the port lacks
    assert sorted(set(reasons) - names) == [], "not public names of " + rel
    assert sorted(set(reasons) & have) == [], f"ported, yet in NOT_PORTED: {rel}"
    assert all(len(why) > 20 for why in reasons.values())
