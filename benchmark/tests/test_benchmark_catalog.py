"""Cells, configurations, traffic and metrics are files found by name; the
harness imports nothing of JAX or the JAX package; run.py refuses to run
without a card."""

import ast
import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import harness, run as run_mod

from .conftest import BENCH, ROOT, small_copy


def test_new_files_are_found_by_name(tmp_path):
    bench = small_copy(tmp_path)
    cfg = json.loads((bench / "configs" / "sym_small.json").read_text())
    cfg["params"] = dict(cfg["params"], n=768)
    (bench / "configs" / "sym_other.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "davidson_sliced_cold.json")
                         .read_text())
    traffic.update(n_targ=3, n_max=6, lo_iter=30)
    (bench / "traffic" / "three_roots.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "solves_counted.py").write_text(
        "def read(run):\n    return float(len(run.solves))\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "sym_other", "source": "test",
                            "file": "benchmark/configs/sym_other.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "other-three", "config": "sym_other",
                              "traffic": "three_roots", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "solves_counted", "unit": "solves",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["other-three"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    catalog = harness.Catalog(bench)
    result, check, _ = harness.run_cell(catalog, "other-three", 3, 0.5, False,
                                     "cpu", time.perf_counter())
    assert result["correct"], check
    assert result["metrics"]["solves_counted"]["value"] == \
        result["attempted"]
    assert catalog.module("inputs", "hilbert_like").shapes(
        cfg["params"])["a"]["n"] == 768
    # an entry that names a cell elsewhere is not reported here
    result, _, _ = harness.run_cell(catalog, "sym-davidson", 3, 0.2, False,
                                 "cpu", time.perf_counter())
    assert "solves_counted" not in result["metrics"]


def test_the_benchmarks_files_are_consistent():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    catalog = harness.Catalog()
    configs = {c["name"]: c for c in spec["configs"]}
    for w in spec["workloads"]:
        cfg = catalog.config(w["config"])
        assert cfg["name"] == w["config"]
        assert cfg["source"] == configs[w["config"]]["source"]
        assert cfg["reduced"] == configs[w["config"]]["reduced"]
        traffic = catalog.traffic(w["traffic"])
        for kind, name in (("inputs", cfg["generator"]),
                           ("reference", cfg["problem"]),
                           ("operators", traffic["operator"]),
                           ("routes", traffic["route"])):
            assert (BENCH / kind / f"{name}.py").is_file()
        assert set(cfg["limits"]) == {"resid_rms", "eig_rel", "ortho"}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not (_imports(path) & run_mod.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "diaglib_tpu_torch" not in _imports(path), path
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; import benchmark.reference.sym; "
         "print(sorted({m.split('.')[0] for m in sys.modules} & "
         "{'diaglib_tpu_torch', 'diaglib_tpu', 'jax'}))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole():
    assert run_mod.forbidden_modules(
        ["diaglib_tpu_torch", "diaglib_tpu_torch.ops", "jaxtyping",
         "torch"]) == []
    assert run_mod.forbidden_modules(
        ["jax.numpy", "diaglib_tpu.solvers", "flax", "jaxlib"]) == \
        ["diaglib_tpu", "flax", "jax", "jaxlib"]


def test_a_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, 'benchmark/tests'); "
        "from pathlib import Path; import tempfile; "
        "from conftest import small_copy; from benchmark import harness, run; "
        "d = Path(tempfile.mkdtemp()); c = harness.Catalog(small_copy(d)); "
        "r, _, _ = harness.run_cell(c, 'sym-davidson-f64', 5, 0.2, True, "
        "'cpu', time.perf_counter()); print(r['correct'], "
        "run.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.stdout.strip().splitlines()[-1] == "True []", out.stderr[-2000:]


def test_run_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py would run the cell")
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
         "sym-davidson-cold", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, BENCH_RUN="1"))
    assert out.returncode != 0 and out.stdout.strip() == ""
