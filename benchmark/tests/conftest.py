"""The benchmark's own tests: on the CPU at small sizes; those marked
``cuda`` need the card and skip here."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "benchmark"
# a small stand-in of the configuration, run on the CPU
SMALL = {"sym_small": ("hilbert_like", "sym", {"n": 1024, "block": 64})}
# each traffic of the benchmark on the stand-in, a block of 8 and 4 roots
CELLS = {"sym-davidson": ("sym_small", "davidson_sliced_cold"),
         "sym-davidson-f64": ("sym_small", "davidson_f64_sliced_cold")}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where there is none")


def small_copy(dest: Path) -> Path:
    """A copy of the benchmark's folder under dest with the small
    configuration and cells, and a BENCHMARK.json naming them; returns
    the copy's folder."""
    bench = dest / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads((BENCH / "configs" / "hilbert_symm_n32768.json")
                      .read_text())
    spec["configs"], spec["workloads"] = [], []
    for name, (gen, problem, params) in SMALL.items():
        cfg = dict(base, name=name, generator=gen, problem=problem,
                   params=params)
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "test",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": [], "why": "test"})
    for name, (cfg, traffic) in CELLS.items():
        t = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
        t.update(n_targ=4, n_max=8)
        (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(t))
        spec["workloads"].append({"name": name, "config": cfg,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
    for m in spec["per_layer"]:
        m.pop("workloads", None)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


@pytest.fixture(scope="session")
def small(tmp_path_factory):
    """The harness's catalog over the small copy."""
    from benchmark import harness

    bench = small_copy(tmp_path_factory.mktemp("bench"))
    return harness.Catalog(bench)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")
