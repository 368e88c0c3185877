"""The port's public API against the JAX package's.

Every name of the JAX package's ``__all__`` is exported by the port's top
level, with the same value where it is a constant and the same results
where it is a function; the error helpers that ``tests/test_errors.py``
and ``tests/test_format.py`` test on the JAX side give the same answers.
"""

import enum

import pytest

import airs_compression_tpu as act
import airs_compression_tpu_torch as tx
from airs_compression_tpu.format import errors as j_errors
from airs_compression_tpu.format import params as j_params
from airs_compression_tpu_torch.format import errors as t_errors
from airs_compression_tpu_torch.format import params as t_params

P, E = act.Preprocessing, act.EncoderType


@pytest.mark.parametrize("name", act.__all__)
def test_name_exported(name):
    assert name in tx.__all__
    assert hasattr(tx, name)
    j, t = getattr(act, name), getattr(tx, name)
    if isinstance(j, (int, str)) and not isinstance(j, enum.Enum):
        assert t == j


@pytest.mark.parametrize("enum_name", ["Preprocessing", "EncoderType",
                                       "CmpErrorCode"])
def test_enums_alike(enum_name):
    j, t = getattr(act, enum_name), getattr(tx, enum_name)
    assert {m.name: int(m) for m in j} == {m.name: int(m) for m in t}


def test_error_messages_alike():
    for code in act.CmpErrorCode:
        assert tx.error_message(tx.CmpErrorCode(int(code))) \
            == act.error_message(code)


U32_VALUES = [0, 1, 127, 128, 0xFFFFFF80, 0xFFFFFF81, 0xFFFFFFF6,
              0xFFFFFFFF, 0xFFFFFF9C, 0xFFFFFFD8, 1 << 31, (1 << 32) + 5]


@pytest.mark.parametrize("value", U32_VALUES)
def test_u32_error_helpers(value):
    assert t_errors.u32_is_error(value) == j_errors.u32_is_error(value)
    assert int(t_errors.u32_to_error_code(value)) \
        == int(j_errors.u32_to_error_code(value))


def test_error_code_round_trip():
    for code in t_errors.CmpErrorCode:
        if code in (t_errors.CmpErrorCode.NO_ERROR,
                    t_errors.CmpErrorCode.MAX_CODE):
            continue
        u = t_errors.error_to_u32(code)
        assert t_errors.u32_is_error(u)
        assert t_errors.u32_to_error_code(u) == code


@pytest.mark.parametrize("size", [0, 1, 2, 1000, (1 << 24) - 21,
                                  (1 << 24) - 20, (1 << 24) - 19, 1 << 30])
def test_uncompressed_bound(size):
    assert tx.uncompressed_bound(size) == act.uncompressed_bound(size)


@pytest.mark.parametrize("size,stride", [(0, 2), (1, 2), (7, 2), (8, 4),
                                         (9, 4), (1 << 24, 2)])
def test_div_round_up_bytes_to_samples(size, stride):
    assert t_params.div_round_up_bytes_to_samples(size, stride) \
        == j_params.div_round_up_bytes_to_samples(size, stride)


def _outcome(fn):
    try:
        return fn()
    except (act.CmpError, tx.CmpError) as e:
        return ("error", int(e.code))


@pytest.mark.parametrize("prim,sec,iters", [
    (P.DIFF, P.NONE, 0), (P.IWT, P.MODEL, 3), (P.NONE, P.IWT, 1),
    (P.MODEL, P.NONE, 0), (P.DIFF, P.MODEL, 0)])
@pytest.mark.parametrize("size", [0, 1, 1001, 8192])
def test_cal_work_buf_size(prim, sec, iters, size):
    kw = dict(primary_preprocessing=prim, primary_encoder_type=E.GOLOMB_ZERO,
              primary_encoder_param=4, secondary_iterations=iters,
              secondary_preprocessing=sec,
              secondary_encoder_type=E.GOLOMB_ZERO,
              secondary_encoder_param=4)
    jp = act.CmpParams(**kw)
    tp = tx.CmpParams(**kw)
    assert _outcome(lambda: tx.cal_work_buf_size(tp, size)) \
        == _outcome(lambda: act.cal_work_buf_size(jp, size))


@pytest.mark.parametrize("size", [0, 2, 4096, (1 << 24) - 1, 1 << 24])
def test_compress_bound(size):
    assert _outcome(lambda: tx.compress_bound(size)) \
        == _outcome(lambda: act.compress_bound(size))


def test_version():
    assert tx.__version__ == act.__version__ == tx.CMP_VERSION_STRING


def test_profiling_utilities(tmp_path):
    """utils/profiling.py: host stages (no CUDA device named) and a
    torch.profiler trace written as a Chrome trace."""
    import json

    import torch

    from airs_compression_tpu_torch.utils.profiling import StageTimer, trace

    timer = StageTimer()
    for _ in range(2):
        with timer.stage("work", nbytes=1000, sync="cpu"):
            torch.ones(100).sum()
    d = timer.as_dict()["work"]
    assert d["calls"] == 2 and d["bytes"] == 2000 and d["device_s"] is None
    assert d["s"] > 0 and "work: " in timer.report()
    path = str(tmp_path / "trace.json")
    with trace(path):
        torch.arange(10).cumsum(0)
    with open(path) as f:
        assert "traceEvents" in json.load(f)


def test_range_times_counts_work_launched_inside():
    """utils/profiling.range_times: a device record counts for the range
    whose host interval holds the runtime call that launched it (the two
    share an id), whatever launched it; host time and calls per range."""
    import types

    import torch

    from airs_compression_tpu_torch.utils.profiling import range_times

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, dev, eid, start, end, cpu_us=0.0):
        span = types.SimpleNamespace(start=start, end=end,
                                     elapsed_us=lambda: end - start)
        return types.SimpleNamespace(name=name, device_type=dev, id=eid,
                                     time_range=span, cpu_time_total=cpu_us)

    events = [
        ev("sp.a", cpu, 1, 0, 100, cpu_us=100),
        ev("sp.b", cpu, 2, 100, 200, cpu_us=100),
        ev("other", cpu, 3, 200, 300, cpu_us=100),
        ev("cudaLaunchKernel", cpu, 40, 10, 12),
        ev("kernel_a", cuda, 40, 500, 900),
        ev("cudaMemcpyAsync", cpu, 41, 150, 151),
        ev("Memcpy HtoD", cuda, 41, 900, 930),
        ev("cudaLaunchKernel", cpu, 42, 250, 251),  # inside no range
        ev("kernel_c", cuda, 42, 930, 1930),
        ev("cudaStreamSynchronize", cpu, 43, 160, 190),
        ev("aten::add", cpu, 40, 20, 30),  # an op's id is not a launch's
    ]
    got = range_times(types.SimpleNamespace(events=lambda: events), "sp.")
    assert got == {"sp.a": {"s": 1e-4, "device_s": 4e-4, "calls": 1},
                   "sp.b": {"s": 1e-4, "device_s": 3e-5, "calls": 1}}
