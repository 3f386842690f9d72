"""The PyTorch port stands alone: importing it and every submodule pulls in
no JAX, and builds no kernel (the CUDA build is lazy)."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import diaglib_tpu_torch

ROOT = Path(__file__).resolve().parent.parent


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        diaglib_tpu_torch.__path__, prefix="diaglib_tpu_torch."))


def test_port_covers_the_slice_modules():
    mods = set(_submodules())
    for name in ("types", "problems", "ops.bsr", "ops.slicing",
                 "ops.bsr_sliced", "ops.bsr_sliced_sym", "ops._build",
                 "ortho.core", "utils.guess", "utils.masking",
                 "utils.reduced", "utils.mm", "utils.jacobi",
                 "utils.eberlein", "solvers.davidson",
                 "solvers.lobpcg", "solvers.mixed", "solvers.nonsym",
                 "solvers.caslr",
                 "_device", "ops.dist_bsr", "ops.dist_sliced",
                 "parallel.sharding", "parallel.multihost",
                 "parallel.mh_dryrun"):
        assert f"diaglib_tpu_torch.{name}" in mods, name


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_submodules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import diaglib_tpu_torch.ops._build as b\n"
        "assert not b._libs, 'a kernel was built on import'\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
        "                                            'diaglib_tpu.')))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_kernel_sources_ship_with_the_package():
    csrc = Path(diaglib_tpu_torch.__file__).parent / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "peel.cu", "sym_spmm.cu", "wide_mm.cu", "bsr_spmm.cu",
        "sliced_spmm.cu", "group_spmm.cu"}
    assert (csrc / "peel.cuh").is_file()
    assert (csrc / "sliced_spmm.cuh").is_file()
