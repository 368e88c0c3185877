"""The PyTorch port's tools, run as scripts on the CPU at small sizes.

``tools/torch_verify_on_device.py``, ``tools/torch_dp_scaling.py`` (two
gloo meshes) and ``tools/torch_cli_throughput.py`` run with ``--device
cpu`` (the kernels' plain versions), each in a process of its own, all
started together when the module does; each test waits for its own and
holds the tool to its own checks.  ``chip_smoke.py`` phase K runs the
same tools on the card at their default device.  The dp-scaling tool's
NCCL guard is called in-process with the card count patched.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]

# tool: its arguments after the script
TOOLS = {
    "torch_verify_on_device.py": ("--batch", "16", "--samples", "64"),
    "torch_dp_scaling.py": ("--sizes", "1", "2", "--blocks", "4",
                            "--samples", "256", "--steps", "2"),
    "torch_cli_throughput.py": ("1",),
}


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = {name: subprocess.Popen(
        [sys.executable, str(REPO / "tools" / name), *args, "--device",
         "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for name, args in TOOLS.items()}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _finish(proc):
    """The tool's exit code, its stdout lines and the end of its stderr."""
    out, err = proc.communicate(timeout=300)
    return (proc.returncode, out.decode().strip().splitlines(),
            err.decode()[-3000:])


def test_verify_on_device_finds_no_failure(runs):
    rc, lines, err = _finish(runs["torch_verify_on_device.py"])
    assert rc == 0, err
    assert lines[-1] == "torch_verify_on_device: 0 failures"
    # the five encoder configs and the three chain configs all ran
    assert sum("byte-identical" in ln for ln in lines) == 5
    assert sum("round-trips" in ln for ln in lines) == 3


def test_dp_scaling_rows_correct_and_collective_free(runs):
    rc, lines, err = _finish(runs["torch_dp_scaling.py"])
    assert rc == 0, err
    got = json.loads(lines[-1])
    assert (got["metric"], got["device"], got["backend"]) == (
        "torch_dp_scaling", "cpu", "gloo")
    assert [r["ranks"] for r in got["rows"]] == [1, 2]
    assert [r["blocks"] for r in got["rows"]] == [4, 8]
    assert [r["blocks"] for r in got["fixed_total_rows"]] == [8, 8]
    rows = got["rows"] + got["fixed_total_rows"]
    assert all(r["correct"] for r in rows)
    assert got["collective_free"] and not any(r["collectives"] for r in rows)
    assert all(len(r["ref_ms"]) == r["ranks"] for r in rows)
    assert all(p is None for r in rows for p in r["peak_mib"])  # no card


def test_cli_throughput_streams_equal(runs):
    rc, lines, err = _finish(runs["torch_cli_throughput.py"])
    assert rc == 0, err
    got = json.loads(lines[-1])
    assert (got["device"], got["file_bytes"]) == ("cpu", 1 << 20)
    for key in ("device_encode_s", "host_encode_s", "device_decode_s",
                "host_decode_s"):
        assert got[key] > 0


def _dp_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_dp_scaling", REPO / "tools" / "torch_dp_scaling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cards,sizes", [(0, ["1"]), (1, ["2"]),
                                         (2, ["1", "2", "4"])])
def test_dp_scaling_refuses_nccl_ranks_over_cards(monkeypatch, capsys,
                                                  cards, sizes):
    """NCCL runs one rank a card: a mesh larger than the card count is
    refused up front with exit code 2, before any rank starts."""
    tool = _dp_tool()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(tool.subprocess, "Popen", None)  # no rank may start
    assert tool.main(["--backend", "nccl", "--sizes", *sizes]) == 2
    assert "one rank a card" in capsys.readouterr().err


def test_dp_scaling_meshes_do_not_share_a_store(monkeypatch, capsys):
    """Each mesh of both curves starts its ranks in a fresh directory of
    its own: here the weak curve's second mesh and the fixed-total curve's
    second mesh have one shape (2 ranks of 4 blocks), and a FileStore left
    by the first could join the second's ranks to its stale keys."""
    tool = _dp_tool()
    dirs = []

    def fake_run_size(args, world, blocks, tmp):
        assert tmp.is_dir() and not any(tmp.iterdir())
        dirs.append(tmp)
        return {"ranks": world, "blocks": world * blocks,
                "step_ms_median": 1.0, "step_ms_min": 1.0,
                "step_ms_max": 1.0, "collectives": {},
                "dispatch_floor_ms": 0.0, "correct": True}
    monkeypatch.setattr(tool, "run_size", fake_run_size)
    assert tool.main(["--sizes", "1", "2", "--blocks", "4", "--device",
                      "cpu"]) == 0
    assert len(dirs) == len(set(dirs)) == 4
    assert json.loads(capsys.readouterr().out.splitlines()[-1])[
        "collective_free"]
