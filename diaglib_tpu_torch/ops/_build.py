"""Build the Hopper kernels of ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, ``_build/lib<name>-<hash>.so``, compiled by ``nvcc`` for
``sm_90a`` and loaded with ctypes.  The hash is of the source and the shared
``csrc/*.cuh`` headers, so an edited source is rebuilt and a built one is
reused.  All sources compile in
parallel, one ``nvcc`` each, the first time any kernel is asked for; nothing
is built on import, so the package imports where there is no ``nvcc``.

The flags keep IEEE float semantics: no ``--use_fast_math`` (denormals
stay on) and ``-fmad=false`` (no multiply-add contraction), which the peel
kernel's bit-exactness relies on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["library", "build_all"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "diaglib_tpu_torch/csrc cannot be built")
    return str(path)


def _target(src: Path) -> Path:
    # the shared headers count: a source that includes an edited header is
    # rebuilt too
    data = src.read_bytes() + b"".join(h.read_bytes()
                                       for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(data + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{src.stem}-{digest}.so"


def build_all() -> float:
    """Compile every ``csrc/*.cu`` not yet built, in parallel; returns the
    seconds spent.  Raises with nvcc's output if any source fails."""
    with _lock:
        t0 = time.perf_counter()
        todo = [(s, _target(s)) for s in sorted(CSRC.glob("*.cu"))
                if not _target(s).exists()]
        if todo:
            BUILD.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = []
            for src, out in todo:
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((src, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            errors = []
            for src, out, tmp, proc in procs:
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"{src.name}:\n{log.decode(errors='replace')}")
                else:
                    os.replace(tmp, out)
            if errors:
                raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(CSRC / f"{name}.cu")))
                _libs[name] = lib
    return lib

