"""The port's kernel build (``airs_compression_tpu_torch/_build.py``) from
several processes at once, on the CPU, with a stub compiler.

Ranks of a mesh that start together all call ``_build.build``; the file
lock in the build directory makes them wait for one compiler run per
source instead of each running its own.  The stub ``nvcc`` (a shell
script under a ``CUDA_HOME`` of its own) logs each run, waits, and writes
the library it was asked for.

Each kernel mode has one design: every file of ``csrc/`` is built as the
port builds it, with no build switch that selects other code.
"""

import inspect
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "airs_compression_tpu_torch" / "csrc"
# a conditional on an AIRS_ macro: #ifdef, #ifndef, #if / #elif defined(...)
_SWITCH = re.compile(r"^[ \t]*#[ \t]*(?:ifdef|ifndef|if|elif)\b.*\bAIRS_",
                     re.M)

_STUB = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
echo "$out" >> "$STUB_LOG"
sleep 1
printf 'lib' > "$out"
"""

# one process: point the build at the test's directories, wait until
# every process is ready, then build one source
_CALLER = r"""
import pathlib, sys, time
from airs_compression_tpu_torch import _build
root, me, n = pathlib.Path(sys.argv[1]), sys.argv[2], int(sys.argv[3])
_build._CSRC, _build._BUILD = root / "csrc", root / "build"
(root / f"ready{me}").touch()
while len(list(root.glob("ready*"))) < n:
    time.sleep(0.01)
print(_build.build(["k"])["k"])
"""


def test_two_processes_share_one_compiler_run(tmp_path):
    procs = 2
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("// a kernel\n")
    stub = tmp_path / "cuda" / "bin" / "nvcc"
    stub.parent.mkdir(parents=True)
    stub.write_text(_STUB)
    stub.chmod(0o755)
    log = tmp_path / "nvcc.log"
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"),
               STUB_LOG=str(log), PYTHONPATH=str(REPO))
    runs = [subprocess.Popen([sys.executable, "-c", _CALLER, str(tmp_path),
                              str(i), str(procs)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True) for i in range(procs)]
    outs = []
    for p in runs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(out.strip())
    assert len(set(outs)) == 1
    lib = pathlib.Path(outs[0])
    assert lib.parent == tmp_path / "build" and lib.read_text() == "lib"
    # one compiler run, into a pid-tagged file moved into place
    runs_logged = log.read_text().split()
    assert len(runs_logged) == 1
    assert runs_logged[0].startswith(str(lib) + ".")
    assert sorted(p.name for p in lib.parent.iterdir()) \
        == [".build.lock", lib.name]


def test_built_library_is_not_rebuilt(tmp_path, monkeypatch):
    """With every library present, build() neither locks nor compiles."""
    from airs_compression_tpu_torch import _build

    monkeypatch.setattr(_build, "_CSRC", tmp_path / "csrc")
    monkeypatch.setattr(_build, "_BUILD", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("// a kernel\n")
    (tmp_path / "build").mkdir()
    so = _build._library_path("k")
    so.write_text("lib")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    assert _build.build(["k"]) == {"k": so}
    assert not (tmp_path / "build" / ".build.lock").exists()


@pytest.mark.parametrize("name", sorted(p.name for p in CSRC.iterdir()))
def test_source_has_one_design(name):
    """Every ``.cu`` is a library the port builds, no source compiles code
    only under an ``AIRS_`` macro, and the build passes ``nvcc`` no macro."""
    from airs_compression_tpu_torch import _build

    src = CSRC / name
    if src.suffix == ".cu":
        assert src.stem in _build.SOURCES
    switches = [m.group(0) for m in _SWITCH.finditer(src.read_text())]
    assert switches == []
    assert list(inspect.signature(_build.build).parameters) == ["names"]
    assert not any(f.startswith("-D") for f in _build._FLAGS)
