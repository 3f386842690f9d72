"""The PyTorch port stands alone: importing it and every submodule pulls in
no JAX, and builds no kernel (the CUDA build is lazy)."""

import ast
import importlib
import inspect
import pkgutil
import subprocess
import sys
from pathlib import Path

import diaglib_tpu
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
                 "parallel.mh_dryrun", "config", "reporting", "checkpoint",
                 "profiling", "ops.ell", "demo"):
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


def test_package_holds_no_test_rig():
    """No module of the port imports the tests, ``chip_smoke`` or the
    benchmark (the fleet jobs and the route comparison live in
    ``tests/torch_fleet.py``), and ``profiling`` offers the reference's
    names and the solve log's, no more."""
    pkg = Path(diaglib_tpu_torch.__file__).parent
    outside = ("tests", "chip_smoke", "benchmark")
    found = []
    for path in sorted(pkg.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            else:
                continue
            found += [(path.name, n) for n in names
                      if n.split(".")[0] in outside]
    assert found == []
    from diaglib_tpu_torch import profiling

    assert set(profiling.__all__) == {
        "trace", "wall", "phase_timings", "collective_inventory",
        "solve_log", "SolveLog", "Span", "LEAF_SPANS"}


def test_kernel_sources_ship_with_the_package():
    csrc = Path(diaglib_tpu_torch.__file__).parent / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "peel.cu", "sym_spmm.cu", "wide_mm.cu", "bsr_spmm.cu",
        "sliced_spmm.cu", "group_spmm.cu"}
    assert (csrc / "peel.cuh").is_file()
    assert (csrc / "sliced_spmm.cuh").is_file()


# the reference's public names the port does not carry (ROADMAP "Not
# carried"): the emulated-float64 split, the XLA compile cache and the
# XLA compile guard
NOT_CARRIED = {
    ("ops.slicing", "SplitF64"), ("ops.slicing", "split_f64"),
    ("config", "enable_persistent_cache"),
    ("utils", "safe_jit"), ("utils", "tpu_compiler_options"),
    ("utils.compile", "safe_jit"), ("utils.compile", "tpu_compiler_options"),
}


def test_port_offers_every_name_of_the_reference():
    """Every (module, name) of an ``__all__`` in diaglib_tpu is in the
    same module of the port, but for the seven not carried."""
    mods = ["diaglib_tpu"] + sorted(m.name for m in pkgutil.walk_packages(
        diaglib_tpu.__path__, prefix="diaglib_tpu."))
    missing = set()
    for name in mods:
        names = getattr(importlib.import_module(name), "__all__", None)
        if names is None:
            continue
        sub = name[len("diaglib_tpu"):]
        try:
            port = importlib.import_module("diaglib_tpu_torch" + sub)
        except ImportError:
            port = None
        missing |= {(sub.lstrip("."), n) for n in names
                    if port is None or not hasattr(port, n)}
    assert missing == NOT_CARRIED


# the parameters of the reference the port renames or drops: a JAX PRNG
# key is a torch.Generator (or an integer seed) in the port; the Pallas
# interpret switch and the presplit float64 operands have no counterpart
RENAMED = {"key": ("generator", "seed")}
DROPPED = {"interpret", "xsplit", "bxsplit"}
# the parallel layer takes a process group where the reference takes a
# device mesh (ROADMAP "Deliberate differences")
OTHER_SIGNATURE = {"VectorSharding", "initialize", "global_sharding",
                   "make_global", "make_replicated"}
# DistSlicedBSR's fields without ``first`` (the port keeps no global
# offset array beside its row partition)
NOT_TAKEN = {("DistSlicedBSR", "first")}


def _signature_faults(sub, name, ref, port):
    """How ``port``'s signature fails to take ``ref``'s calls."""
    try:
        rs, ps = inspect.signature(ref), inspect.signature(port)
    except (TypeError, ValueError):
        return []
    positional = (inspect.Parameter.POSITIONAL_ONLY,
                  inspect.Parameter.POSITIONAL_OR_KEYWORD)
    variadic = (inspect.Parameter.VAR_POSITIONAL,
                inspect.Parameter.VAR_KEYWORD)
    rp = [p for p in rs.parameters.values() if p.name not in DROPPED
          and (name, p.name) not in NOT_TAKEN]
    pp = list(ps.parameters.values())
    port_pos = [p.name for p in pp if p.kind in positional]
    port_kw = {p.name for p in pp if p.kind == inspect.Parameter.KEYWORD_ONLY}
    faults, matched = [], set()
    for i, p in enumerate(q for q in rp if q.kind in positional):
        names = RENAMED.get(p.name, (p.name,))
        if i >= len(port_pos) or port_pos[i] not in names:
            faults.append(f"{sub}.{name}: positional {p.name!r} at {i}")
        else:
            matched.add(port_pos[i])
    for p in rp:
        if p.kind != inspect.Parameter.KEYWORD_ONLY:
            continue
        hit = [n for n in RENAMED.get(p.name, (p.name,)) if n in port_kw]
        if hit:
            matched.add(hit[0])
        else:
            faults.append(f"{sub}.{name}: keyword-only {p.name!r}")
    for p in pp:
        if (p.name not in matched and p.kind not in variadic
                and p.default is inspect.Parameter.empty):
            faults.append(f"{sub}.{name}: added {p.name!r} without default")
    return faults


def test_port_takes_the_reference_calls():
    """Every callable of an ``__all__`` in diaglib_tpu that the port offers
    takes the reference's calls: each positional parameter at the same
    position under the same name, each keyword-only parameter keyword-only
    under the same name, and a default for each parameter the port adds
    (but for RENAMED, DROPPED, OTHER_SIGNATURE and NOT_TAKEN)."""
    mods = ["diaglib_tpu"] + sorted(m.name for m in pkgutil.walk_packages(
        diaglib_tpu.__path__, prefix="diaglib_tpu."))
    faults = []
    for name in mods:
        ref_mod = importlib.import_module(name)
        names = getattr(ref_mod, "__all__", None)
        sub = name[len("diaglib_tpu"):]
        try:
            port_mod = importlib.import_module("diaglib_tpu_torch" + sub)
        except ImportError:
            continue
        for n in names or ():
            ref, port = getattr(ref_mod, n), getattr(port_mod, n, None)
            if port is None or not callable(ref) or n in OTHER_SIGNATURE:
                continue
            faults += _signature_faults(sub.lstrip(".") or "diaglib_tpu", n,
                                        ref, port)
    assert faults == []
