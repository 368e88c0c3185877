"""Device selection and the build of the port's CUDA kernels.

Every source ``csrc/<name>.cu`` is compiled by ``nvcc`` on its own into a
shared library with a plain C interface and loaded with :mod:`ctypes`
(no PyTorch headers, so a build takes seconds).  Libraries are built at
first use into ``build/`` beside this file, named by a hash of the sources
and flags: an edited source rebuilds, an unchanged one is reused.
:func:`build` starts one ``nvcc`` per source, all at once.

Each C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; :func:`check` turns a non-zero code
into an exception, since a refused launch never runs and a later
synchronize does not report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

__all__ = ["SOURCES", "resolve_device", "build", "function", "check",
           "stream_arg", "ptr"]

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"

#: one shared library per kernel source
SOURCES = ("pack", "decode", "xxh32", "assemble")

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: "dict[str, ctypes.CDLL]" = {}
_fns: "dict[tuple[str, str], object]" = {}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    and absent (there is no quiet CPU path: pass ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the kernels")
    return found


def _flags(defines) -> "list[str]":
    return [*_FLAGS, *(f"-D{k}={v}" for k, v in defines)]


def _library_path(name: str, defines=()) -> pathlib.Path:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return _BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, defines=()) -> "dict[str, pathlib.Path]":
    """Compile every named source that is not built yet, one ``nvcc``
    process each, all started together; returns the library paths.
    ``defines``: (macro, value) pairs for a variant build (the port's own
    libraries take none)."""
    with _lock:
        jobs = []
        for name in names:
            so = _library_path(name, defines)
            if so.exists():
                continue
            _BUILD.mkdir(exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *_flags(defines), "-o", str(tmp),
                   str(_CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, proc, tmp, so))
        errors = []
        for name, proc, tmp, so in jobs:
            out, _ = proc.communicate()
            if proc.returncode:
                errors.append(f"{name}.cu:\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return {name: _library_path(name, defines) for name in names}


def function(name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of library ``name`` (built on first use),
    with its argument types set and an ``int`` (cudaError_t) result."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(name: str, err: int, what: str) -> None:
    """Raise if a C entry of library ``name`` returned a CUDA error."""
    if err:
        to_str = _libs[name].airs_cuda_error_string
        to_str.argtypes = [ctypes.c_int]
        to_str.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({to_str(err).decode()})")


def stream_arg(t: torch.Tensor) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a C pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
