"""The harness: the import rule, discovery by name, the result line's
schema, the refusal without a card, and BENCHMARK.json's contract."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.conftest import ROOT

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_forbidden_modules_compares_whole_top_level_names():
    names = ["jax.numpy", "jaxlib", "flax.linen", "airs_compression_tpu.ops",
             "airs_compression_tpu_torch.ops", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(names) == [
        "airs_compression_tpu", "flax", "jax", "jaxlib"]
    assert harness.forbidden_modules(["airs_compression_tpu_torch"]) == []


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, torch; sys.path.insert(0, %r); "
        "from benchmark import harness; "
        "from benchmark.conftest import small_cell; "
        "r = harness.run_cell(harness.Run(small_cell('flagship-encode'), 3, "
        "torch.device('cpu')), 0.2, False); "
        "print(harness.forbidden_modules()); "
        "sys.exit(1 if harness.forbidden_modules() or not r['correct'] "
        "else 0)" % str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


def test_a_forbidden_module_refuses_the_run(run_small, monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.RunRefused, match="jax"):
        run_small("headline-decode")


def _copy_checkout(dest):
    """BENCHMARK.json, benchmark/ and the program, copied to ``dest``."""
    for item in ("BENCHMARK.json", "benchmark", "airs_compression_tpu_torch"):
        src = ROOT / item
        if src.is_dir():
            shutil.copytree(src, dest / item,
                            ignore=shutil.ignore_patterns("__pycache__",
                                                          "build"))
        else:
            shutil.copy(src, dest / item)


def test_a_reader_that_loads_jax_refuses_the_run(tmp_path):
    """The import rule holds after the window: a per-layer reader, run
    after the window has closed, that imports ``jax`` leaves no result."""
    _copy_checkout(tmp_path)
    (tmp_path / "jax").mkdir()              # a stand-in: no real JAX needed
    (tmp_path / "jax" / "__init__.py").write_text("")
    (tmp_path / "benchmark" / "metrics" / "loads_jax.py").write_text(
        "def read(view):\n    import jax  # noqa: F401\n    return 1.0\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "loads_jax", "unit": "1",
                              "better": "lower", "source": "device_trace",
                              "layer": "benchmark", "moves": "decode_GBps",
                              "workloads": ["headline-decode"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys, torch; sys.path.insert(0, %r); "
        "from benchmark import harness; "
        "from benchmark.conftest import small_cell; "
        "cell = small_cell('headline-decode', %r); "
        "r = harness.run_cell(harness.Run(cell, 3, torch.device('cpu')), "
        "0.2, True)" % (str(tmp_path), str(tmp_path)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert "RunRefused: forbidden modules loaded: jax" in proc.stderr, \
        proc.stderr[-2000:]


def test_setup_leaves_out_the_reference(run_small):
    """``setup_s`` is the set-up less the seconds the reference took."""
    res, log = run_small("headline-decode")
    notes = next(json.loads(line)["notes"] for line in log.splitlines()
                 if line.startswith('{"notes"'))
    steps = notes["setup_by_step_s"]
    assert steps["reference_s"] > 0
    assert res["metrics"]["setup_s"]["value"] == pytest.approx(
        steps["warm_s"] - steps["reference_s"])


def test_result_line_schema(run_small):
    for trace in (False, True):
        res, log = run_small("headline-decode", trace=trace)
        assert list(res)[:3] == ["correct", "attempted", "failed"]
        assert list(res)[-1] == "checks"
        assert isinstance(res["correct"], bool)
        assert res["attempted"] >= 1 and res["failed"] == 0
        dev = res["device"]
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
        if trace:
            assert {"busy_s", "window_s"} <= set(dev)
            assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            cell = harness.resolve(harness.load_spec(), "headline-decode")
            assert set(res["metrics"]) == {m["name"]
                                           for m in cell.end_to_end}
        for m in res["metrics"].values():
            assert set(m) == {"value", "unit"}
        for c in res["checks"].values():
            assert set(c) == {"value", "limit"}
        tail = log.strip().splitlines()[-len(res["checks"]):]
        assert all(t.startswith("check ") for t in tail)
        json.dumps(res)


def test_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "headline-decode",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2
    assert "{" not in proc.stdout


def test_refuses_without_the_program(tmp_path):
    """A directory with BENCHMARK.json and benchmark/ alone: no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; sys.path.insert(0, %r); "
            "from benchmark import harness; "
            "from benchmark.conftest import small_cell; "
            "harness.run_cell(harness.Run(small_cell('headline-decode', %r), "
            "3, torch.device('cpu')), 0.2, False)"
            % (str(tmp_path), str(tmp_path)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert "airs_compression_tpu_torch" in proc.stderr


def test_new_parts_are_found_by_name_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files plus entries run with no file of the harness edited."""
    _copy_checkout(tmp_path)
    bench = tmp_path / "benchmark"
    cfg = json.loads((bench / "configs" / "headline_u16.json").read_text())
    cfg.update(name="headline_g2", batch=4, samples=32)
    cfg["params"]["primary_encoder_param"] = 2
    (bench / "configs" / "headline_g2.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "encode_chain.json").read_text())
    mix.update(files=2, batches_per_file=2, keep_share=1.0)
    (bench / "traffic" / "encode_small.json").write_text(json.dumps(mix))
    (bench / "metrics" / "requests_traced.py").write_text(
        "def read(view):\n    return float(view.trace.requests)\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "headline_g2", "source": "test",
                            "file": "benchmark/configs/headline_g2.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "g2-encode", "config": "headline_g2",
                              "traffic": "encode_small", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "encode_p50_ms", "unit": "ms",
                               "better": "lower", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["g2-encode"]})
    spec["per_layer"].append({"name": "requests_traced", "unit": "requests",
                              "better": "higher", "source": "program_span",
                              "layer": "benchmark", "moves": "encode_p50_ms",
                              "workloads": ["g2-encode"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "import sys, json, torch; sys.path.insert(0, %r); "
        "from benchmark import harness; "
        "cell = harness.resolve(harness.load_spec(), 'g2-encode'); "
        "out = [harness.run_cell(harness.Run(cell, 5, torch.device('cpu')), "
        "0.3, t) for t in (False, True)]; "
        "print(json.dumps(out))" % str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    plain, traced = json.loads(proc.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"encode_p50_ms", "setup_s"}
    assert traced["metrics"]["requests_traced"]["value"] == \
        harness.TRACE_REQUESTS


def test_benchmark_json_keeps_its_contract():
    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "benchmark/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        names.add(c["name"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        cell = harness.resolve(spec, w["name"])
        assert harness.kind_module(cell).Work
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        assert cell.per_layer
        for m in cell.per_layer:
            harness.metric_reader(cell, m["name"])
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
    every = [*spec["configs"], *spec["workloads"], *spec["end_to_end"],
             *spec["per_layer"]]
    for item in every:
        assert NAME.fullmatch(item["name"]), item["name"]
        if "unit" in item:
            assert UNIT.fullmatch(item["unit"]), item["unit"]
        if "better" in item:
            assert item["better"] in ("lower", "higher")
        for text in (item.get("why"), item.get("layer"), item.get("source")):
            assert text is None or (1 <= len(text) <= 200
                                    and "\n" not in text and "\t" not in text)
    all_names = [i["name"] for i in every]
    assert len(all_names) == len(set(all_names))
