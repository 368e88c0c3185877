"""airs_compression_tpu_torch — the AIRSPACE batch codec on PyTorch and CUDA.

A port of ``airs_compression_tpu`` (JAX, TPU) to PyTorch on an NVIDIA H100,
held against the JAX package byte for byte.  It imports nothing of JAX and
nothing of the JAX package.  Every entry point takes ``device=`` and
defaults to ``"cuda"``; where CUDA is absent it raises.  With
``device="cpu"`` each kernel wrapper runs its plain PyTorch version.

Counterparts in the JAX package (``airs_compression_tpu/``):

==========================  ==================================================
this package                JAX package
==========================  ==================================================
format/errors.py            format/errors.py (copy)
format/header.py            format/header.py (copy)
format/params.py            format/params.py (copy + params_from_reference)
format/dtypes.py            format/dtypes.py (copy)
utils/bits.py               utils/bits.py (copy)
utils/xxh32.py              utils/xxh32.py (pure Python, no ``xxhash``)
utils/profiling.py          utils/profiling.py (CUDA events, torch.profiler)
engine/host.py              engine/host.py (the host codec, numpy)
engine/context.py           engine/context.py (CmpContext, identifiers)
engine/decode.py            engine/decode.py (decompress)
engine/checkpoint.py        engine/checkpoint.py (same .npz layout)
ops/u32.py                  — (u32 words on int64 tensors)
ops/preprocess.py           ops/preprocess.py
ops/golomb.py               ops/golomb.py
ops/adapt.py                ops/adapt.py (adaptive Golomb parameter)
ops/pack.py                 ops/pallas_pack.py K1 + K2 + bitpack.pack_codes_tree
                            (also one long row across CTAs)
ops/assemble.py             ops/pallas_assemble.py K5
ops/encode.py               ops/encode.py (without the TPU entropy clamp)
ops/decode.py               ops/decode.py
ops/decode_kernel.py        ops/pallas_decode.py K3 (also windows of one
                            stream at start bits)
ops/xxh32_device.py         ops/xxh32_device.py K4 (also one long row,
                            streamed)
models/stream.py            models/stream.py (BatchCompressor,
                            BatchDecompressor, the packed stream and the
                            file-stream decode)
models/chunked.py           models/chunked.py (compress_chunked,
                            decompress_chunked)
parallel/sp.py              parallel/sp.py (one long block on one card)
cli/                        cli/ (the ``airspace-torch`` command)
_build.py, csrc/*.cu        — (nvcc build of the CUDA kernels, ctypes)
==========================  ==================================================
"""

from .engine.context import CmpContext, set_timestamp_func
from .engine.decode import decompress
from .format.dtypes import CmpType
from .format.errors import CmpError, CmpErrorCode, error_message
from .format.header import (
    CMP_CHECKSUM_SIZE,
    CMP_HDR_MAX_SIZE,
    CMP_HDR_SIZE,
    CMP_VERSION_NUMBER,
    CMP_VERSION_STRING,
    CmpHeader,
)
from .format.params import (
    CMP_MAX_MODEL_RATE,
    CmpParams,
    EncoderType,
    Preprocessing,
    cal_work_buf_size,
    compress_bound,
    params_from_reference,
    uncompressed_bound,
)
from .models.chunked import compress_chunked, decompress_chunked
from .models.stream import BatchCompressor, BatchDecompressor
from .ops.adapt import DEFAULT_LADDER
from .ops.assemble import assemble_stream
from .ops.pack import pack_codes

__version__ = CMP_VERSION_STRING

__all__ = [
    "CMP_CHECKSUM_SIZE",
    "CMP_HDR_MAX_SIZE",
    "CMP_HDR_SIZE",
    "CMP_MAX_MODEL_RATE",
    "CMP_VERSION_NUMBER",
    "CMP_VERSION_STRING",
    "BatchCompressor",
    "BatchDecompressor",
    "CmpContext",
    "CmpError",
    "CmpErrorCode",
    "CmpHeader",
    "CmpParams",
    "CmpType",
    "DEFAULT_LADDER",
    "EncoderType",
    "Preprocessing",
    "__version__",
    "assemble_stream",
    "cal_work_buf_size",
    "compress_bound",
    "compress_chunked",
    "decompress",
    "decompress_chunked",
    "error_message",
    "pack_codes",
    "params_from_reference",
    "set_timestamp_func",
    "uncompressed_bound",
]
