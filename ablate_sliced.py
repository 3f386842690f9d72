#!/usr/bin/env python3
"""Time design variants of the sliced SpMM kernels K1 and K5 on one GPU.

    python3 ablate_sliced.py [variant ...]

Each variant is a copy of ``diaglib_tpu_torch/csrc`` with a few text
substitutions, built with the package's nvcc flags into
``diaglib_tpu_torch/_build/ablate/<variant>``.  Every variant runs at the
flagship shapes of ``chip_smoke.py`` (random_bsr_spd(65536, 512, 8): the
symmetric store for K1 at k = 15, the general store at k = 15 and the
nonsymmetric flagship's T band store at k = 10 for K5), both precision
tiers, and prints the median CUDA-event time of each.  Level sums are held
against the plain versions: a variant that drops work on purpose (marked
``*``) is expected to differ and is printed as such; any other mismatch
fails the run.

Variants (against the current sources):
  base        the kernels as they are
  wide4       the wide instantiation with a 4-stage ring (not 2)
  no_narrow   the float32 tier through the wide instantiation
  rows_first  block rows fastest in the grid (not column tiles)
  prefetch    cp.async with an L2::256B prefetch hint
  row_copies  the direct strips copied one row a thread group (bank
              conflicts on the shared-memory writes)
  copies*     the copies alone: no products
  products*   the products alone: no strip copies (x still copied)
"""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N, BLOCK = 65536, 512

_ROWS_FIRST = [(f, old, new) for f in ("sliced_spmm.cuh", "sym_spmm.cu")
               for old, new in (
                   ("const int r = blockIdx.y;", "const int r = blockIdx.x;"),
                   ("(int)blockIdx.x * kTJ", "(int)blockIdx.y * kTJ"),
                   ("const dim3 grid(B / kTJ, (unsigned)(n",
                    "const dim3 grid((unsigned)(n"),
                   ("/ B), (k + kKC", "/ B), B / kTJ, (k + kKC"))]

VARIANTS = {
    "base": [],
    "wide4": [("sliced_mma.cuh", "using Wide = Config<8, 8, 9, 2, 2>;",
               "using Wide = Config<8, 8, 9, 4, 2>;")],
    "no_narrow": [(f, "if (Narrow::serves(", "if (false && Narrow::serves(")
                  for f in ("sliced_spmm.cuh", "sym_spmm.cu")],
    "rows_first": _ROWS_FIRST,
    "prefetch": [("sliced_mma.cuh", "cp.async.cg.shared.global [%0]",
                  "cp.async.cg.shared.global.L2::256B [%0]")],
    "row_copies": [("sliced_mma.cuh",
                    "const int m = q % 8, w = q / 8 % kWarps, "
                    "lq = q / (8 * kWarps);\n      const int l = 4 * m + lq;",
                    "const int l = q / kWarps, w = q % kWarps;")],
    "copies*": [("sliced_mma.cuh", "    consume<C>(smem",
                 "    if (t.k < 0) consume<C>(smem")],
    "products*": [("sliced_mma.cuh", "    cp_async16(dst, src, 16);",
                   "    if (t.k < 0) cp_async16(dst, src, 16);")],
}


def build(tag, subs):
    """The variant's two libraries, built from a patched copy of csrc."""
    from diaglib_tpu_torch.ops import _build

    d = _build.BUILD / "ablate" / tag.rstrip("*")
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(_build.CSRC, d)
    for name, old, new in subs:
        p = d / name
        src = p.read_text()
        if old not in src:
            raise RuntimeError(f"{tag}: {name} no longer holds {old!r}")
        p.write_text(src.replace(old, new))
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"{name}.so"),
         str(d / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for name in ("sym_spmm", "sliced_spmm")}
    fns = {}
    p_, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{tag}: nvcc failed:\n{out.decode()}")
        fn = getattr(ctypes.CDLL(str(d / f"{name}.so")), name)
        fn.argtypes = ([p_] * 7 + [i32] * 8 + [p_] if name == "sym_spmm"
                       else [p_] * 5 + [i32] * 9 + [p_])
        fn.restype = i32
        fns[name] = fn
    return fns


def time_ms(fn, reps=10):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cases(dev):
    """(name, library, launcher factory, plain level sums) at the
    flagship shapes."""
    import torch

    from diaglib_tpu_torch.ops import bsr_sliced as bs
    from diaglib_tpu_torch.ops import bsr_sliced_sym as sym
    from diaglib_tpu_torch.ops.bsr import random_bsr_spd
    from diaglib_tpu_torch.problems import bsr_nonsym_similarity

    m = random_bsr_spd(N, BLOCK, 8, seed=0, dtype=torch.float32, device=dev)
    store = sym.slice_bsr_sym(m)
    general = bs.slice_bsr(m)
    band = bsr_nonsym_similarity(N, BLOCK, 8, seed=0, device=dev)[0][1]
    del m
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(6)
    out = []
    for tier, dt in (("f64", torch.float64), ("f32", torch.float32)):
        nx, na_used, nlev = bs._tier_params(8, dt, None, None)
        for tag, st, k in (("general", general, 15), ("band", band, 10)):
            x = torch.randn((k, N), generator=g, dtype=torch.float64,
                            device=dev)
            xs, _ = bs._slice_x(x.to(dt), nx)
            acc = torch.empty((nlev * k, N), dtype=torch.int32, device=dev)

            def k5(fn, xs=xs, st=st, k=k, nx=nx, na=na_used, nlev=nlev,
                   acc=acc):
                def run():
                    err = fn(xs.data_ptr(), st.slices.data_ptr(),
                             st.cols.data_ptr(), st.row_start.data_ptr(),
                             acc.data_ptr(), st.nnzb, k, N, N, BLOCK,
                             st.slices.shape[2] // BLOCK, nx, na, nlev,
                             stream)
                    if err:
                        raise RuntimeError(f"sliced_spmm: error {err}")
                    return acc
                return run
            want = bs.sliced_spmm_plain(xs, st.slices, st.rows, st.cols,
                                        st.row_start, nx=nx, na=na_used,
                                        nlev=nlev)
            out.append((f"K5 {tag} {tier}", "sliced_spmm", k5, want))
        k = 15
        x = torch.randn((k, N), generator=g, dtype=torch.float64, device=dev)
        xs, _ = bs._slice_x((x * store.u_scale).to(dt), nx)
        buckets = []
        for rows, cols, sl, off in ((store.rows, store.cols, store.slices, 0),
                                    (store.rows1, store.cols1, store.slices1,
                                     1)):
            na = min(na_used - off, sl.shape[-1] // BLOCK)
            buckets.append((rows, cols, sl, na, off,
                            *sym.sym_worklist(rows, cols, N // BLOCK)))
        want = torch.zeros((nlev * k, N), dtype=torch.int32, device=dev)
        for rows, cols, sl, na, off, _, _ in buckets:
            sym.sym_spmm_plain(xs, sl, rows, cols, want, nx=nx, na=na,
                               nlev=nlev, plane_off=off)
        acc = torch.empty_like(want)

        def k1(fn, xs=xs, buckets=buckets, k=k, nx=nx, nlev=nlev, acc=acc):
            def run():
                acc.zero_()
                for rows, cols, sl, na, off, items, start in buckets:
                    err = fn(xs.data_ptr(), sl.data_ptr(), rows.data_ptr(),
                             cols.data_ptr(), items.data_ptr(),
                             start.data_ptr(), acc.data_ptr(), k, N, BLOCK,
                             sl.shape[2] // BLOCK, nx, na, nlev, off, stream)
                    if err:
                        raise RuntimeError(f"sym_spmm: error {err}")
                return acc
            return run
        out.append((f"K1 {tier}", "sym_spmm", k1, want))
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("ablate_sliced.py needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    chosen = sys.argv[1:] or list(VARIANTS)
    todo = [(tag, VARIANTS[tag]) for tag in chosen]
    work = cases(dev)
    for tag, subs in todo:
        t0 = time.perf_counter()
        fns = build(tag, subs)
        line = []
        for name, lib, factory, want in work:
            run = factory(fns[lib])
            got = run()
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            if not same and not tag.endswith("*"):
                raise AssertionError(f"{tag}: {name} differs from plain")
            line.append(f"{name} {time_ms(run):.4f} ms"
                        + ("" if same else " (differs)"))
        print(f"[ablate {tag}] " + "; ".join(line)
              + f" (built and run in {time.perf_counter() - t0:.1f} s, "
              f"{card})", flush=True)


if __name__ == "__main__":
    main()
