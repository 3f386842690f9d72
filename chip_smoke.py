#!/usr/bin/env python3
"""Drive diaglib_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: a CUDA card is required; prints its name and power limit
   (nvidia-smi) and turns TF32 off for float32 matmuls and convolutions;
2. build: compiles the CUDA kernels of diaglib_tpu_torch/csrc with nvcc;
3. operator: random_bsr_spd(65536, 512, 8) on the card, sliced into the
   symmetric int8 store (the configuration bench.py headlines);
4. kernels: each kernel against its plain torch version on the card at the
   shapes the main path gives it — the peel (K2) at (15, 65536) and the
   symmetric SpMM (K1) on the store, both precision tiers, bit for bit —
   with median times of kernel and plain version, plus the float64 matvec
   against a dense float64 oracle at n = 2048 (1e-14 max|y|);
5. main path: the float32 -> float64 Davidson ladder (10 roots, n_max 15,
   tol 1e-10, zero guess from a seeded generator), once to warm up and once
   with every kernel's launch count set to 0 just before and read just
   after; the 10 returned pairs' residuals are recomputed with a plain
   float64 BSR product of the original blocks (rms < 1e-10, max < 1e-9);
6. kernel usage: a JSON ``kernels`` line; every kernel must have run in 5.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N, BLOCK, BPR = 65536, 512, 8
N_TARG, N_MAX = 10, 15


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps):
    """Median milliseconds of ``fn`` on the card (CUDA events), after one
    warm-up call."""
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


def plain_bsr_matvec(m, x, chunk=64):
    """y = x @ A^T from the BSR blocks in float64 (an oracle independent of
    the slice store)."""
    import torch

    B = m.block
    nbr = m.n // B
    xb = x.reshape(x.shape[0], nbr, B)
    y = torch.zeros((nbr, x.shape[0], B), dtype=torch.float64,
                    device=x.device)
    for s in range(0, m.nnzb, chunk):
        blk = m.blocks_t[s:s + chunk].to(torch.float64)
        xc = xb[:, m.cols[s:s + chunk].long(), :].permute(1, 0, 2)
        y.index_add_(0, m.rows[s:s + chunk].long(), xc @ blk)
    return y.permute(1, 0, 2).reshape(x.shape[0], m.n)


def main():
    import torch

    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device")
    if not (ROOT / "diaglib_tpu_torch" / "csrc").is_dir():
        raise RuntimeError("chip_smoke.py must run from a checkout of the "
                           "repository (diaglib_tpu_torch/ is missing)")
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}  torch {torch.__version__} cuda "
        f"{torch.version.cuda}  matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")

    from diaglib_tpu_torch import SolverOptions, davidson_ladder
    from diaglib_tpu_torch.ops import _build, slicing
    from diaglib_tpu_torch.ops import bsr_sliced_sym as sym
    from diaglib_tpu_torch.ops.bsr import bsr_to_dense, random_bsr_spd
    from diaglib_tpu_torch.ops.bsr_sliced import _slice_x
    from diaglib_tpu_torch.problems import diag_precnd

    # ---- 2. build ----
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
        f"{_build.build_all():.1f} s")

    # ---- 3. operator ----
    t0 = time.perf_counter()
    m = random_bsr_spd(N, BLOCK, BPR, seed=0, dtype=torch.float32,
                       device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    store = sym.slice_bsr_sym(m)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"[operator] n={N} B={BLOCK} bpr={BPR}: nnzb={m.nnzb} "
        f"({t1 - t0:.2f} s); symmetric store: {store.slices.shape[0]} + "
        f"{store.slices1.shape[0]} entries, {store.nbytes / 2**30:.3f} GiB "
        f"({t2 - t1:.2f} s)")

    # ---- 4. kernels against their plain versions ----
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((N_MAX, N), generator=g, dtype=torch.float64,
                    device=dev)
    x = x * 2.0 ** torch.randint(-8, 8, (N_MAX, 1), generator=g, device=dev)
    tiers = {"f64": (torch.float64, 8, 9, store.na),
             "f32": (torch.float32, 4, 4, min(store.na, 4))}
    stats = {"peel_rows": {}, "sym_spmm": {}}
    max_err = {"peel_rows": 0.0, "sym_spmm": 0.0}
    for tier, (dt, nx, nlev, na_used) in tiers.items():
        xu = (x * store.u_scale).to(dt)
        sx = 2.0 * slicing.pow2_grid(xu.abs().amax(dim=1, keepdim=True))
        mant, _ = torch.frexp(sx)
        if not bool((mant == 0.5).all()):
            raise AssertionError("pow2_grid is not a power of two on the card")
        t = (xu.double() / sx).to(dt)
        got = slicing.peel_rows(t, nx, 7)
        want = slicing.peel_rows_plain(t, nx, 7)
        torch.cuda.synchronize()
        err = float((got.int() - want.int()).abs().max())
        max_err["peel_rows"] = max(max_err["peel_rows"], err)
        if not torch.equal(got, want):
            raise AssertionError(f"peel kernel != plain ({tier}), max {err}")
        stats["peel_rows"][tier] = (
            time_ms(lambda: slicing.peel_rows(t, nx, 7), 50),
            time_ms(lambda: slicing.peel_rows_plain(t, nx, 7), 20))

        xs, _ = _slice_x(xu, nx)
        k = N_MAX
        buckets = []
        for rows, cols, sl, off in ((store.rows, store.cols, store.slices, 0),
                                    (store.rows1, store.cols1,
                                     store.slices1, 1)):
            na = min(na_used - off, sl.shape[-1] // BLOCK)
            if rows.shape[0] and na > 0:
                buckets.append((rows, cols, sl, na, off))

        def levels(fn):
            acc = torch.zeros((nlev * k, N), dtype=torch.int32, device=dev)
            for rows, cols, sl, na, off in buckets:
                fn(xs, sl, rows, cols, acc, nx=nx, na=na, nlev=nlev,
                   plane_off=off)
            return acc

        got = levels(sym.sym_spmm)
        want = levels(sym.sym_spmm_plain)
        torch.cuda.synchronize()
        err = float((got.long() - want.long()).abs().max())
        max_err["sym_spmm"] = max(max_err["sym_spmm"], err)
        if not torch.equal(got, want):
            raise AssertionError(f"sym_spmm kernel != plain ({tier}), "
                                 f"max {err}")
        stats["sym_spmm"][tier] = (
            time_ms(lambda: levels(sym.sym_spmm), 10),
            time_ms(lambda: levels(sym.sym_spmm_plain), 3))
        for name in stats:
            ms, plain = stats[name][tier]
            log(f"[kernels] {name} {tier}: kernel == plain, kernel "
                f"{ms:.4f} ms, plain {plain:.4f} ms (median, {card})")

    small = random_bsr_spd(2048, 256, 4, seed=1, dtype=torch.float32,
                           device=dev)
    small_store = sym.slice_bsr_sym(small)
    xs_small = torch.randn((N_MAX, 2048), generator=g, dtype=torch.float64,
                           device=dev)
    y = sym.sym_sliced_matvec(small_store)(xs_small)
    ref = xs_small @ bsr_to_dense(small).double().T
    rel = float((y - ref).abs().max() / ref.abs().max())
    log(f"[kernels] f64 matvec n=2048 B=256 vs dense f64: max err "
        f"{rel:.3e} of max|y|")
    if not rel <= 1e-14:
        raise AssertionError(f"f64 matvec error {rel:.3e} > 1e-14")

    # ---- 5. the main path ----
    opts = SolverOptions(n_targ=N_TARG, n_max=N_MAX, max_iter=150,
                         tol=1e-10, max_dav=10)
    mv_lo = sym.sym_sliced_matvec(store, dtype=torch.float32)
    mv_hi = sym.sym_sliced_matvec(store)
    pc_lo = diag_precnd(store.diagonal.to(torch.float32))
    pc_hi = diag_precnd(store.diagonal)
    guess = torch.zeros((N_MAX, N), dtype=torch.float64, device=dev)

    def ladder():
        gen = torch.Generator(device=dev).manual_seed(1)
        res = davidson_ladder(mv_lo, pc_lo, mv_hi, pc_hi, guess, opts,
                              lo_tol=2e-6, lo_iter=35, generator=gen)
        torch.cuda.synchronize()
        return res

    t0 = time.perf_counter()
    ladder()
    warm_s = time.perf_counter() - t0
    slicing.peel_rows.launches = 0
    sym.sym_spmm.launches = 0
    t0 = time.perf_counter()
    res = ladder()
    wall_s = time.perf_counter() - t0
    launches = {"peel_rows": slicing.peel_rows.launches,
                "sym_spmm": sym.sym_spmm.launches}
    f64_iters = int(torch.isfinite(res.rms_history[:, 0]).sum())
    log(f"[ladder] ok={res.ok} ortho_ok={res.ortho_ok} iterations="
        f"{res.n_iter} (f64 stage {f64_iters}) n_matvec={res.n_matvec} "
        f"wall {wall_s:.3f} s (first run {warm_s:.3f} s) store "
        f"{store.nbytes} bytes ({card})")
    if not res.ok:
        raise AssertionError("the ladder did not converge")
    ev = res.evec[:N_TARG]
    r = plain_bsr_matvec(m, ev) - res.eig[:N_TARG, None] * ev
    rms = float((r.norm(dim=1) / N ** 0.5).max())
    rmax = float(r.abs().max())
    log(f"[ladder] eig[:3]={res.eig[:3].tolist()} plain-matvec residuals: "
        f"max rms {rms:.3e}, max |r| {rmax:.3e}")
    if not (rms < 1e-10 and rmax < 1e-9 and bool(torch.isfinite(
            res.eig).all()) and tuple(res.evec.shape) == (N_MAX, N)):
        raise AssertionError("residuals of the returned pairs above tol")

    # ---- 6. kernel usage ----
    sources = {"peel_rows": ("diaglib_tpu_torch/csrc/peel.cu",
                             "diaglib_tpu/ops/slicing.py:268"),
               "sym_spmm": ("diaglib_tpu_torch/csrc/sym_spmm.cu",
                            "diaglib_tpu/ops/bsr_sliced_sym.py:220")}
    kernels = []
    for name, (src, replaces) in sources.items():
        (ms, plain), (ms32, plain32) = (stats[name]["f64"],
                                        stats[name]["f32"])
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max_err[name], "ms": ms,
                        "plain_ms": plain, "ms_f32": ms32,
                        "plain_ms_f32": plain32})
    log(json.dumps({"kernels": kernels}))
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
