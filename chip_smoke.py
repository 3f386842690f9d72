#!/usr/bin/env python3
"""Drive diaglib_tpu_torch's ported paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py               # phases 1-6 on one card
    python3 chip_smoke.py --ranks 4     # phase (j) on four cards

Phases (any failure raises and the script exits non-zero):

1. device: a CUDA card is required; prints its name and power limit
   (nvidia-smi) and turns TF32 off for float32 matmuls and convolutions;
2. build: compiles the CUDA kernels of diaglib_tpu_torch/csrc with nvcc,
   one process per source, in parallel;
3. operators: random_bsr_spd(65536, 512, 8) on the card (the configuration
   bench.py headlines and the README's plain-BSR operator), its symmetric
   int8 store, its general int8 store (slice_bsr, 4 GB, for the K5 check),
   a float64 copy of its blocks, bsr_gen_problem(65536, 512, 8), the
   generalized flagship's (A, B) pair of stores,
   bsr_nonsym_similarity(65536, 512, 8), the nonsymmetric flagship's S, T
   and T^T stores (its S is the operator above), and
   bsr_casida_tdscf(65536, 512, 4), the Casida flagship's A+B and A-B
   symmetric stores, with the two float32 BSR matrices they slice (the
   same random_bsr_spd calls) kept as their residual oracle;
4. kernels: each kernel against its plain torch version on the card at the
   shapes the paths give it, with median times of kernel and plain version
   and the least time the card could take for the same work (bound):
   the peel (K2) at (15, 65536) and the symmetric SpMM (K1) on the store,
   both precision tiers, bit for bit, one device kernel a bucket and no
   other (torch.profiler), with the floor of reading each entry's planes
   once a direction; K2's fused entry, the x side of the sliced matvec
   from x to planes and row scales, at the symmetric store's (15, 65536)
   with its column grid and at (10, 65536) without, both tiers, bit for
   bit, one device kernel a call and no other, with its device time
   (torch.profiler), the host time of its wrapper and of the wrapper's
   parts, and, in the same call, the unfused chain it replaced, and the
   device kernels of one warm symmetric matvec a tier; the wide-rotation product (K3) at
   (15, 165) @ (165, 65536) in the mm and mTm layouts and at ortho_cd's
   Cholesky step (15, 15) @ (15, 65536), bit for bit, two device kernels a
   call and no other (torch.profiler), and against cuBLAS float64 (1e-14
   max|y|, its time too); the plain BSR
   SpMM (K4) on the float32 operator at k = 15 (1e-5 max|y|, its GB/s and
   fraction of the HBM peak), beside a torch.sparse_bsr_tensor product;
   the general sliced SpMM (K5) bit for
   bit, both tiers, on the general store at k = 15 (15 entries a block
   row) and on the T band store at k = 10 (one entry a row, the
   nonsymmetric ladder's shape), one device kernel a call and no other;
   the distributed group SpMM (K6) bit for
   bit, both tiers, at k = 15 on every group of every rank of the 4-way
   partition of the general store and of a small irregular store at
   B = 512 with padding entries and uncovered rows, and checked and timed
   at the main path's shape (one rank, one group of 1920 entries), one
   device kernel a call and no other; each with its share of the bound; and
   the
   float64 symmetric and general sliced matvecs against a dense float64
   oracle at n = 2048 (1e-14 max|y|);
5. ladders at full width (10 roots, tol 1e-10, max_dav 10, zero guess from
   a seeded generator), each run once to warm up and once with every
   kernel's launch count set to 0 just before and read just after:
   (a) lobpcg_ladder on the symmetric store (n_max 15, lo_iter 70);
   (b) gen_david_ladder on the generalized pair through sliced_matvec_any,
       float32 and float64 tiers of both A and B (n_max 15, lo_iter 60);
   (c) davidson_ladder over bsr_matvec of the float32 and float64 blocks
       (n_max 15, lo_iter 35); two calls of the float64 bsr_matvec at
       (15, 65536) bit-equal;
   (d) davidson_ladder on the symmetric store (n_max 15, lo_iter 35)
       under wide_mm="auto" and once more under "never": eigenvalues within
       1e-10, iterations within 2;
   (a), (b), (d) "auto", (e), (f), (g)'s two ladders and (h3)'s sharded
       ladder again on the captured
       route (the default: each iteration's steps replayed as CUDA
       graphs) and on the uncaptured one (the same steps called directly,
       through the solvers' private switch): every returned tensor bit for
       bit, the same counts and K2 / K1 launches (K5 too for (e), whose
       T band it carries), the host's reads of the device an
       iteration (torch.cuda's sync debug mode, at most 3 between two
       flag reads where no step was run again; (e) reads its Gram matrix
       for the host dgeev besides), the rare-branch reruns,
       graph capture time and pool memory, and the most passes the
       uncaptured route's eager ortho loops took;
   (e) nonsym_ladder, side "c", on R = E_- S E_+ (n_max 10, max_iter 150,
       lo_tol 2e-6, lo_iter 60);
   (f) under a one-rank NCCL process group (parallel.multihost.initialize,
       an explicit tcp:// rendezvous on the loopback), davidson_ladder with
       sharding= over dist_sliced_matvec of the general store, both tiers
       (K6 under every matvec; n_max 15, lo_iter 35), on the captured
       route (each step's all-reduces inside its graph) and held against
       the uncaptured one as (a)-(e) are, then the unsharded
       davidson_ladder over sliced_bsr_matvec of the same store (K5): the
       same iteration and matvec counts, eigenvalues within 1e-12; under
       the group, two calls of dist_bsr_matvec (float64 x) bit-equal and
       within 1e-14 max|y| of the plain product;
   (g) caslr_eff_ladder over casida_tdscf_ops of the Casida pair (prec
       "eff") and caslr_ladder with algorithm 0 (prec "std"), n_max 15,
       lo_iter 60, a zero (15, 131072) paired guess: each pair's residuals
       rp = (A+B) p - w m, rm = (A-B) m - w p, p = (Y+Z)/2, m = (Y-Z)/2,
       recomputed by plain products in each solver's own norm, and the
       two ladders' eigenvalues within rtol 1e-9 of each other.
   (h) the options the reference accepts beyond the main routes:
       (h2, after (d)) sliced_mmT at the Gram shape (15, 65536) .
       (165, 65536)^T on the card, bit for bit against the same call on
       CPU copies, its median time beside float64 a @ b.T; (h1) (d)'s
       davidson_ladder under reduced_solver "host", "jacobi" (eager
       sweeps on the card, run once, without a warm-up) and sliced_mm
       "always" (every float64 Gram product through sliced_mmT at
       K = 65536): eigenvalues within 1e-10 of (d)'s "auto" run, and for
       "always" iterations within 2 of it (the host route solves the
       float32 stage's reduced problems in float64, as the reference's
       does, and the Jacobi route to an adaptive target, so their counts
       are logged beside (d)'s, not held), walls beside it, and the
       median time of one
       reduced solve at L = 150 (a Rayleigh quotient of the store) by
       jacobi_eigh, torch.linalg.eigh and the host route; (h3, inside (e),
       on its stores) nonsym_ladder with driver "device" (the Eberlein
       reduced solve on the card, run once) and with sharding= under a
       one-rank NCCL group: (e)'s checks, eigenvalues within 1e-9 of
       (e)'s, the sharded run with (e)'s iteration and matvec counts
       exactly (captured, and held against its uncaptured route), and the
       median time of one reduced solve at L = 100 (the
       ladder's largest) by eberlein_eig on the card and by host dgeev.
       No route falls back to another: a failure raises.
   Each returned set of 10 pairs must be ok, with residuals recomputed by
   plain float64 BSR products of the original blocks: rms < 1e-10, max <
   1e-9 (A x - lambda B x for (b), whose vectors must also be B-orthonormal
   to 1e-10; both R x - lambda x and R^T y - lambda y for (e), whose
   vectors must be biorthonormal to 1e-10 and whose eigenvalues must lie
   within 1e-7 of (d)'s, R being similar to S);
   (i) the user's surface on the card (after (g); (i6) inside (f)):
       (i1) the five demo subcommands (python -m diaglib_tpu_torch.demo) at
       the demo's defaults (n 1000, n_want 10, tol 1e-8), one process
       each, all at once: exit 0, the reference's result files, every
       iterative file's eigenvalues within 2e-6 of its lapack.txt, nonsym's
       printed max |eig - dense| below 1e-6; (i2) on (d)'s store, the
       float64 davidson of the ladder's second stage from the zero guess,
       interrupted at 6 iterations, checkpoint.save and load(like=) (every
       field bit-equal, on the card), resumed: check_pairs' bounds, ok in
       fewer iterations than the same solve from the zero guess,
       eigenvalues within 1e-10 of (d)'s; (i3) profiling.trace around one
       warm (d) ladder, then one warm (a) ladder (and, inside (e), one warm
       (e) ladder): the Chrome trace names
       the scopes matvec, rayleigh-ritz and expand-ortho and the kernels
       K1, K2 and K3 (the ladder on its captured route, each step replayed
       under its scope);
       the device-busy share of the window, device kernels an iteration, the
       host time under each scope and the device time of the kernels
       launched under it, the same under each of the step loop's leaf
       spans (profiling.LEAF_SPANS) with the device's idle time by leaf
       span, each stage's record from profiling.solve_log (its iterations
       summing to the ladder's), and the kernels with the most device
       time; (i4)
       profiling.phase_timings of the float64 symmetric sliced matvec at
       (15, 65536) beside phase 4's K1 time, profiling.wall of one (d)
       ladder beside (d)'s; (i5) the ELL operator of tests/test_ell.py's
       generator at n = 65536 (built on the host, ell_from_coo onto the
       card): ell_matvec at k = 15 within 1e-14 max|y| of scipy's CSR
       product, davidson over it (4 roots, n_max 8, tol 1e-9, max_iter
       300) ok with host residuals below tol; (i6) profiling.collective_inventory of one
       sharded davidson iteration over dist_sliced_matvec (K6) under (f)'s
       one-rank NCCL group on the captured, unrolled and eager routes, and
       of one warm iteration (torch_fleet.flag_window, the captured steps
       replayed): the captured route's counts the unrolled route's;
6. kernel usage: a JSON ``kernels`` line with the launch counts summed over
   the timed runs of 5, (h) and (i) included, and each kernel's times and
   bound; every kernel (six) must have run there.

``--ranks R`` (R = 4) runs phase (j) instead of phases 2-6, the multi-card
path with one NCCL rank a card, through ``parallel.mh_dryrun.run_fleet``:
it builds the kernels once, needs R cards (else it exits non-zero), and
   (j1) runs each fleet job but the flagship's (mh_dryrun's dryrun;
       dist_sliced, sharded_solvers, checkpoint, inventory and routes of
       tests/torch_fleet.py) on one set of inputs (torch_fleet.job_inputs,
       the sizes of its CPU test) under gloo on R
       CPU ranks and under NCCL on the R cards, and holds the two:
       integer stages (K6's planes, row scales and levels on the received
       shards) bit for bit, float64 eigenvalues within 1e-10, iterations
       and matvecs within +-2 (matvecs in blocks) but for the solve whose
       guess is drawn from a generator (the CPU and the card draw other
       streams), every rank's reduced results bit-identical, each NCCL
       rank on its own card, MH_DRYRUN_OK from every rank; the sharded
       solves run captured on the cards (every step replayed, its
       collectives and ring permutes inside), and job routes holds every
       sharded solver captured (unrolled under gloo) against eager, bit
       for bit on every rank, forced reruns included, with one flag
       history on every rank;
   (j2) the flagship over R cards: random_bsr_spd(65536, 512, 8) built on
       every rank, each keeping its rows of the general store; the sharded
       davidson_ladder (lo_iter 35) and lobpcg_ladder (lo_iter 70) over
       dist_sliced_matvec (K2, K6, and K3 in the rotations) on the captured
       route, run once to warm up and once counted, then captured against
       uncaptured on every rank (torch_fleet.route_pair: the same bits
       and counts, host reads, capture cost, one flag digest on every
       rank); rank 0's unsharded ladders over
       sliced_bsr_matvec (K5) on the whole store; every pair's residuals by
       dist_bsr_matvec of the float64 products of the original blocks (rms
       < 1e-10, max < 1e-9); eigenvalues within 1e-10 of rank 0's K5
       ladder, the counts printed beside its (not held: the float32 tier
       of the distributed operator slices each received shard on its own
       grid, so the float32 stage ends elsewhere and the float64 stage
       with it, PERF.md §7.7); K6 bit-equal to its plain version on
       every rank's received planes, both tiers; the ring permutes posted
       in one order on every rank; the collectives of one warm float64
       sharded Davidson iteration on rank 0 by kind, their NCCL kernels'
       device ms and the device-busy share (torch.profiler), captured and
       eager;
   (j3) random_bsr_spd(R * 65536, 512, 8) over R cards, a flagship-sized
       share a card: the sharded davidson_ladder, captured and against
       uncaptured, the same residual gate, each card's peak memory (under
       60 GB);
   (j4) K2, K3, K5 and K6 on cuda:0 at the shapes of the R-rank path, bit
       for bit against their plain versions and timed; then a ``kernels``
       line with their launches in (j2) summed over the ranks.
The last line is ``{"ok": true, "device": {...}}`` (under ``--ranks``,
``count`` is the number of cards the run used).
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# the benchmark's trace arithmetic: kernels' short names, and device and
# host time by the scope that launched them
from benchmark.tracing import (
    SCOPES,
    idle_by_scope,
    scope_breakdown,
    short_names,
)
# the fleet jobs, the checks of their outputs and the route comparison
from tests import torch_fleet

ROOT = Path(__file__).resolve().parent

N, BLOCK, BPR = 65536, 512, 8
N_TARG, N_MAX = 10, 15
NS_MAX = 10                        # the nonsymmetric ladder's n_max
CASIDA_BPR = 4                     # the Casida pair's blocks a row
K3_M, K3_K = N_MAX, 11 * N_MAX     # the f64 Davidson rotation: lda_pad = 165
# the card's published peaks (H100 SXM data sheet, dense), for the bounds
HBM_BPS, INT8_OPS, F32_FLOPS = 3.35e12, 1.979e15, 67e12


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


def bound(nbytes, ops, rate):
    """(bound_ms, bound_by): the larger of moving ``nbytes`` at the memory
    rate and doing ``ops`` at ``rate``."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def n_pairs(nx, na, nlev, plane_off=0):
    """Plane pairs (x plane ix, stored plane i) whose level is below nlev."""
    return sum(1 for i in range(na) for ix in range(nx)
               if plane_off + i + ix < nlev)


def plain_bsr_matvec(m, x):
    """y = x @ A^T from the BSR blocks in float64 (an oracle independent of
    the slice store and of the kernels)."""
    import torch

    from diaglib_tpu_torch.ops.bsr import bsr_spmm_plain

    # each block row's products summed in entry order: the same bits on
    # every call
    return bsr_spmm_plain(m, x.to(torch.float64))


def plain_bsr_twice(m64, dev, card):
    """(c): two calls of the float64 plain-BSR matvec (bsr_matvec of the
    float64 blocks) at (15, n) give the same bits."""
    import torch

    from diaglib_tpu_torch import bsr_matvec

    x = torch.randn((N_MAX, N), dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(11))
    mv = bsr_matvec(m64)
    y1, y2 = mv(x), mv(x)
    same = torch.equal(y1, y2)
    log(f"[bsr float64] bsr_matvec (15, {N}) twice: bit-equal {same} "
        f"({card})")
    if not same:
        raise AssertionError("the float64 plain-BSR matvec is not "
                             "deterministic")


def dist_bsr_twice(m, sh, card):
    """(f): two calls of the distributed-BSR matvec (dist_bsr_matvec of the
    float32 blocks on float64 x, one rank) give the same bits, within
    1e-14 max|y| of the plain product."""
    import torch

    from diaglib_tpu_torch.ops.dist_bsr import distribute_bsr, dist_bsr_matvec

    dm = distribute_bsr(m, 1, rank=sh.rank)
    x = torch.randn((N_MAX, N), dtype=torch.float64, device=m.rows.device,
                    generator=torch.Generator(device=m.rows.device)
                    .manual_seed(12))
    mv = dist_bsr_matvec(dm, sh)
    y1, y2 = mv(x), mv(x)
    same = torch.equal(y1, y2)
    ref = plain_bsr_matvec(m, x)
    err = float((y1 - ref).abs().max() / ref.abs().max())
    log(f"[dist_bsr float64] dist_bsr_matvec (15, {N}) twice: bit-equal "
        f"{same}, {err:.2e} of max|y| from the plain product ({card})")
    if not (same and err <= 1e-14):
        raise AssertionError("the float64 distributed-BSR matvec is off")
    del dm


def check_kernels_k1_k2(store, dev, card, stats, max_err):
    """K2 and K1 against their plain versions, both tiers, bit for bit."""
    import torch

    from diaglib_tpu_torch.ops import bsr_sliced_sym as sym
    from diaglib_tpu_torch.ops import slicing
    from diaglib_tpu_torch.ops.bsr_sliced import _slice_x

    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((N_MAX, N), generator=g, dtype=torch.float64,
                    device=dev)
    x = x * 2.0 ** torch.randint(-8, 8, (N_MAX, 1), generator=g, device=dev)
    tiers = {"f64": (torch.float64, 8, 9, store.na),
             "f32": (torch.float32, 4, 4, min(store.na, 4))}
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
        numel = t.numel()
        stats["peel_rows"][f"prescaled device {tier}"] = device_ms(
            lambda: slicing.peel_rows(t, nx, 7), "peel_kernel")
        stats["peel_rows"][f"prescaled {tier}"] = (
            time_ms(lambda: slicing.peel_rows(t, nx, 7), 50),
            time_ms(lambda: slicing.peel_rows_plain(t, nx, 7), 20),
            *bound(numel * t.element_size() + nx * numel, 4 * nx * numel,
                   F32_FLOPS))

        xs, _ = _slice_x(xu, nx)
        k = N_MAX
        buckets = []
        for rows, cols, sl, off in ((store.rows, store.cols, store.slices, 0),
                                    (store.rows1, store.cols1,
                                     store.slices1, 1)):
            na = min(na_used - off, sl.shape[-1] // BLOCK)
            if rows.shape[0] and na > 0:
                items, start = sym.sym_worklist(rows, cols, N // BLOCK)
                buckets.append((rows, cols, sl, na, off, items, start))

        def levels(fn, acc=None):
            if acc is None:
                acc = torch.zeros((nlev * k, N), dtype=torch.int32,
                                  device=dev)
            for rows, cols, sl, na, off, items, start in buckets:
                fn(xs, sl, rows, cols, acc, nx=nx, na=na, nlev=nlev,
                   plane_off=off, items=items, item_start=start)
            return acc

        got = levels(sym.sym_spmm)
        want = levels(sym.sym_spmm_plain)
        torch.cuda.synchronize()
        err = float((got.long() - want.long()).abs().max())
        max_err["sym_spmm"] = max(max_err["sym_spmm"], err)
        if not torch.equal(got, want):
            raise AssertionError(f"sym_spmm kernel != plain ({tier}), "
                                 f"max {err}")
        names = device_kernels(lambda: levels(sym.sym_spmm, got),
                               len(buckets))
        expect_kernels("sym_spmm", names, ["sym_spmm_kernel"] * len(buckets))
        # bound: the used planes once, x's planes once, the accumulator
        # read and written once; products of both directions off the
        # diagonal.  The kernel's floor reads each entry's planes once a
        # direction.
        nbytes = xs.numel() + 2 * nlev * k * N * 4
        twice = nbytes
        ops = 0
        for rows, cols, sl, na, off, _, _ in buckets:
            nbytes += rows.shape[0] * BLOCK * na * BLOCK
            dirs = rows.shape[0] + int((rows != cols).sum())
            twice += dirs * BLOCK * na * BLOCK
            ops += 2 * n_pairs(nx, na, nlev, off) * dirs * k * BLOCK * BLOCK
        stats["sym_spmm"][tier] = (
            time_ms(lambda: levels(sym.sym_spmm), 10),
            time_ms(lambda: levels(sym.sym_spmm_plain), 3),
            *bound(nbytes, ops, INT8_OPS))
        for name, key in (("peel_rows", f"prescaled {tier}"),
                          ("sym_spmm", tier)):
            ms, plain, b_ms, b_by = stats[name][key]
            log(f"[kernels] {name} {tier}: kernel == plain, kernel "
                f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), {b_ms / ms:.1%} of the bound (median, {card})")
        ms = stats["sym_spmm"][tier][0]
        log(f"[kernels] sym_spmm {tier}: device kernels a matvec "
            f"{short_names(names)}; read-twice floor {twice / 1e9:.3f} GB, "
            f"{twice / HBM_BPS * 1e3:.4f} ms, kernel at "
            f"{twice / HBM_BPS * 1e3 / ms:.1%} of it ({card})")


def device_ms(fn, name, reps=50):
    """Median device time in ms of the kernel ``name`` (a short name) over
    ``reps`` calls of ``fn``, from torch.profiler's records (None if the
    profiler sees no such kernel); ``name`` None: the mean device time a
    call of all its kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and (name is None or short_names([e.name]) == [name])]
    if name is None:
        return sum(times) / reps if times else None
    return statistics.median(times) if times else None


def check_kernel_k2_front_end(store, dev, card, stats, max_err):
    """K2's fused entry, the x side of the sliced matvec in one launch, as
    the matvecs drive it: the symmetric store's (15, 65536) with its column
    grid u and the general store's (10, 65536) without, both tiers (float32
    x on the float32 tier).  Each bit for bit against its plain version
    (planes and row scales), one device kernel a call and no other
    (torch.profiler), timed on the card (profiler) and with its wrapper
    (CUDA events), beside the unfused chain it replaces (the fold, the grid
    in torch and the pre-scaled peel), with the host time of the wrapper
    and of its parts (:func:`wrapper_host_us`)."""
    import torch

    from diaglib_tpu_torch.ops import bsr_sliced_sym as sym
    from diaglib_tpu_torch.ops import slicing

    g = torch.Generator(device=dev).manual_seed(4)
    f64, f32 = torch.float64, torch.float32
    x = torch.randn((N_MAX, N), generator=g, dtype=f64, device=dev)
    x = x * 2.0 ** torch.randint(-8, 8, (N_MAX, 1), generator=g, device=dev)
    # the symmetric matvec hands K2 its column grid in the accumulation type
    cases = {"sym f64": (x, 8, store.u_scale, f64),
             "sym f32": (x.float(), 4, store.u_scale.float(), f32),
             "k10 f64": (x[:NS_MAX].contiguous(), 8, None, f64),
             "k10 f32": (x[:NS_MAX].float(), 4, None, f32)}
    for tag, (xc, nx, u, acc) in cases.items():
        kw = dict(col_scale=u, acc_dtype=acc,
                  work_dtype=f64 if nx > 4 else acc)

        def fused():
            return slicing.slice_rows(xc, nx, **kw)

        def unfused():      # the chain before K2 took it whole
            work = xc.to(acc) if u is None else xc.to(acc) * u
            t, sx = slicing._row_grid(work.to(kw["work_dtype"]), 7)
            return slicing.peel_rows(t, nx, 7), sx.to(acc)

        got, got_sx = fused()
        want, want_sx = slicing.slice_rows_plain(xc, nx, **kw)
        chain, chain_sx = unfused()
        torch.cuda.synchronize()
        err = float((got.int() - want.int()).abs().max())
        max_err["peel_rows"] = max(max_err["peel_rows"], err)
        if not (torch.equal(got, want) and torch.equal(got_sx, want_sx)
                and torch.equal(chain, want)
                and torch.equal(chain_sx, want_sx)):
            raise AssertionError(f"slice_rows kernel != plain ({tag}), "
                                 f"max {err}")
        names = device_kernels(fused, 1)
        expect_kernels(f"slice_rows {tag}", names, ["slice_rows_kernel"])
        chain_names = device_kernels(unfused, 2)
        numel = xc.numel()
        nbytes = (numel * xc.element_size() + nx * numel
                  + xc.shape[0] * got_sx.element_size()
                  + (0 if u is None else u.numel() * u.element_size()))
        b_ms, b_by = bound(nbytes, 4 * nx * numel, F32_FLOPS)
        entry = dict(
            ms=time_ms(fused, 50), plain_ms=time_ms(
                lambda: slicing.slice_rows_plain(xc, nx, **kw), 20),
            bound_ms=b_ms, bound_by=b_by,
            device_ms=device_ms(fused, "slice_rows_kernel"),
            unfused_ms=time_ms(unfused, 50),
            unfused_kernels=len(chain_names),
            host_us=wrapper_host_us(xc, nx, kw),
            # a floor of the card for as many bytes: one elementwise
            # torch op that reads x and writes as much
            stream_device_ms=device_ms(lambda: xc * 2.0, None))
        stats["peel_rows"][tag] = entry
        dev_ms = entry["device_ms"]
        share = "" if dev_ms is None else f"{b_ms / dev_ms:.1%} of the bound, "
        log(f"[kernels] slice_rows {tag} {tuple(xc.shape)} nx={nx}"
            f"{' u' if u is not None else ''}: kernel == plain, "
            f"device kernels a call {short_names(names)}; device "
            f"{dev_ms if dev_ms is None else round(dev_ms, 4)} ms, {share}"
            f"wrapper included {entry['ms']:.4f} ms, unfused chain "
            f"{entry['unfused_ms']:.4f} ms in {len(chain_names)} device "
            f"kernels, plain {entry['plain_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}); x * 2.0 on the card "
            f"{entry['stream_device_ms']} ms (median, {card})")
        log(f"[kernels] slice_rows {tag} wrapper, host us a call: "
            + ", ".join(f"{k} {v:.2f}" for k, v in entry["host_us"].items())
            + f" (median, {card})")
    # the device kernels of one warm symmetric matvec a tier: the front end
    # is one of them (the parent's chain was the unfused count above)
    for tier, dt in (("f64", f64), ("f32", f32)):
        mv = sym.sym_sliced_matvec(store, dtype=dt)
        xm = x.to(dt)
        mv(xm)
        names = device_kernels(lambda: mv(xm), 3)
        stats["peel_rows"][f"sym {tier}"]["matvec_kernels"] = len(names)
        log(f"[kernels] sym_sliced_matvec {tier}: {len(names)} device "
            f"kernels a warm call: {short_names(names)}")


def wrapper_host_us(x, nx, kw, reps=200, rounds=7):
    """Host microseconds a call of K2's fused wrapper ``slice_rows`` takes,
    and of its parts: ``wrapper`` the whole call; ``launch`` the ctypes
    call into the library with its arguments made beforehand (argument
    conversion and the cluster launch); ``ctypes`` the same call on zero
    rows, which returns before the launch; ``args`` making those
    arguments (``_peel_lib``, the raw stream handle, data pointers and
    strides); ``empty`` the two ``torch.empty`` of planes and scales; and
    ``checks``, the rest: the wrapper's argument checks and Python calls.

    Each is the median over ``rounds`` of ``reps`` calls timed on the host
    clock without a synchronisation inside (fewer launches than the
    launch queue holds, so the host never waits for the card)."""
    import torch

    from diaglib_tpu_torch.ops import slicing

    f32 = torch.float32
    u, acc, work = kw["col_scale"], kw["acc_dtype"], kw["work_dtype"]
    k, n = x.shape
    planes = torch.empty((nx, k, n), dtype=torch.int8, device=x.device)
    sx = torch.empty((k, 1), dtype=acc, device=x.device)

    def args(rows=k):
        lib = slicing._peel_lib()
        stream = torch._C._cuda_getCurrentRawStream(x.device.index)
        return lib, (x.data_ptr(), x.dtype == f32, x.stride(0), x.stride(1),
                     None if u is None else u.data_ptr(), rows, n, nx,
                     acc == f32, work == f32, acc == f32, planes.data_ptr(),
                     sx.data_ptr(), stream)

    lib, full = args()
    _, empty_rows = args(0)
    if lib.slice_rows(*full) or lib.slice_rows(*empty_rows):
        raise AssertionError("slice_rows: the raw launch failed")

    def empty():
        torch.empty((nx, k, n), dtype=torch.int8, device=x.device)
        torch.empty((k, 1), dtype=acc, device=x.device)

    parts = {"wrapper": lambda: slicing.slice_rows(x, nx, **kw),
             "launch": lambda: lib.slice_rows(*full),
             "ctypes": lambda: lib.slice_rows(*empty_rows),
             "args": args, "empty": empty}
    out = {}
    for name, fn in parts.items():
        times = []
        for _ in range(rounds):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            times.append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
        out[name] = statistics.median(times)
    out["checks"] = out["wrapper"] - out["launch"] - out["args"] - out["empty"]
    return out


def device_kernels(fn, count):
    """Names of the device kernels one call of ``fn`` runs, as
    torch.profiler sees them (empty if it sees no device activity).

    The call runs 10 ms inside the profiler's window on each side: the
    profiler can drop the record of a kernel that starts right at the
    window's edge.  A list shorter than ``count``, the kernels a call
    launches, is taken again, three times in all; a longer one is
    returned at once."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if not names or len(names) >= count:
            break
        log(f"[kernels] torch.profiler saw {short_names(names)} of a call "
            f"that launches {count} kernels; profiling it again")
    return names


def expect_kernels(tag, names, want):
    """Fail unless the profiler saw exactly the kernels ``want`` (in any
    order); an empty list (no device activity seen) only logs."""
    got = short_names(names)
    if not got:
        log(f"[kernels] {tag}: torch.profiler saw no device kernels")
    elif sorted(got) != sorted(want):
        raise AssertionError(f"{tag} ran {got} on the card, not {want}")


def check_kernel_k3(dev, card, stats, max_err):
    """K3 at the f64 Davidson stage's two shapes: the rotation and the
    projections of ortho_vs_x, (15, 165) @ (165, 65536), in the mm and mTm
    layouts, and ortho_cd's Cholesky step, (15, 15) @ (15, 65536); each bit
    for bit against its plain version, within 1e-14 max|y| of cuBLAS
    float64, and timed beside cuBLAS.  One call counts one launch of the
    wrapper and runs two device kernels, K3's a-side and main launches, and
    nothing else: no pass over b outside the kernel."""
    import torch

    from diaglib_tpu_torch.ops import slicing

    g = torch.Generator(device=dev).manual_seed(3)
    c = torch.linalg.qr(torch.randn((K3_K, K3_M), generator=g,
                                    dtype=torch.float64, device=dev))[0]
    b = torch.randn((K3_K, N), generator=g, dtype=torch.float64, device=dev)
    linv = torch.linalg.inv(torch.linalg.cholesky(
        c.T @ c + torch.eye(K3_M, dtype=torch.float64, device=dev)))
    bc = b[:K3_M]
    for tag, a, bb in (("mm", c.T.contiguous(), b), ("mTm", c.T, b),
                       ("cholesky", linv, bc)):
        before = slicing.sliced_wide_mm.launches
        got = slicing.sliced_wide_mm(a, bb)
        calls = slicing.sliced_wide_mm.launches - before
        want = slicing.sliced_wide_mm_plain(a, bb)
        ref = a @ bb
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err["sliced_wide_mm"] = max(max_err["sliced_wide_mm"], err)
        rel = float((got - ref).abs().max() / ref.abs().max())
        names = device_kernels(lambda: slicing.sliced_wide_mm(a, bb), 2)
        log(f"[kernels] sliced_wide_mm {tag} {tuple(a.shape)} @ "
            f"{tuple(bb.shape)}: kernel == plain {torch.equal(got, want)}, "
            f"vs cuBLAS f64 {rel:.3e} of max|y|, {calls} counted launch a "
            f"call, device kernels a call {short_names(names)}")
        if not torch.equal(got, want):
            raise AssertionError(f"wide_mm kernel != plain ({tag})")
        if not rel <= 1e-14:
            raise AssertionError(f"wide_mm vs cuBLAS {rel:.3e} > 1e-14")
        if calls != 1:
            raise AssertionError(f"wide_mm counted {calls} launches a call")
        if names and (len(names) != 2
                      or not all("wide_" in n for n in names)):
            raise AssertionError(f"wide_mm ran {names} on the card")
    # bound: a, b and the product once; 43 int8 plane pairs of products
    for tag, a, bb in (("rotation", c.T.contiguous(), b),
                       ("cholesky", linv, bc)):
        m, kdim = a.shape
        stats["sliced_wide_mm"][tag] = (
            time_ms(lambda: slicing.sliced_wide_mm(a, bb), 50),
            time_ms(lambda: slicing.sliced_wide_mm_plain(a, bb), 5),
            *bound(8 * (m * kdim + kdim * N + m * N),
                   2 * n_pairs(8, 8, 9) * m * kdim * N, INT8_OPS),
            time_ms(lambda: a @ bb, 50))
        ms, plain, b_ms, b_by, cublas = stats["sliced_wide_mm"][tag]
        log(f"[kernels] sliced_wide_mm {tag} ({m}, {kdim}) @ ({kdim}, {N}): "
            f"kernel {ms:.4f} ms (wrapper included), plain "
            f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), cuBLAS f64 "
            f"{cublas:.4f} ms, kernel / cuBLAS {ms / cublas:.2f} (median, "
            f"{card})")


def check_kernel_k4(m32, dev, card, stats, max_err):
    """K4 on the float32 operator at k = 15 against its plain version, and
    the same product as one torch.sparse_bsr_tensor call."""
    import torch

    from diaglib_tpu_torch.ops import bsr

    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((N_MAX, N), generator=g, dtype=torch.float32, device=dev)
    got = bsr.bsr_spmm(m32, x)
    want = bsr.bsr_spmm_plain(m32, x)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    max_err["bsr_spmm"] = max(max_err["bsr_spmm"], err)
    library = None
    try:
        nbr = N // BLOCK
        crow = torch.searchsorted(m32.rows.long(), torch.arange(
            nbr + 1, device=dev)).to(torch.int32)
        a = torch.sparse_bsr_tensor(
            crow, m32.cols, m32.blocks_t.transpose(1, 2).contiguous(),
            size=(N, N), dtype=torch.float32, device=dev)
        xt = x.T.contiguous()
        lib_y = (a @ xt).T
        torch.cuda.synchronize()
        lib_rel = float((lib_y - want).abs().max()) / float(want.abs().max())
        library = time_ms(lambda: a @ xt, 20)
        log(f"[kernels] bsr_spmm library: torch.sparse_bsr_tensor @ dense "
            f"{library:.4f} ms, vs plain {lib_rel:.3e} of max|y| (median, "
            f"{card})")
        del a
    except Exception as exc:    # the product is a yardstick, not a phase
        log(f"[kernels] bsr_spmm library: torch.sparse_bsr_tensor product "
            f"could not run: {type(exc).__name__}: {exc}")
    stats["bsr_spmm"] = (
        time_ms(lambda: bsr.bsr_spmm(m32, x), 20),
        time_ms(lambda: bsr.bsr_spmm_plain(m32, x), 5),
        *bound(m32.nnzb * BLOCK * BLOCK * 4 + 2 * N_MAX * N * 4,
               2 * N_MAX * m32.nnzb * BLOCK * BLOCK, F32_FLOPS),
        library)
    ms, plain, b_ms, b_by, _ = stats["bsr_spmm"]
    gbps = m32.nnzb * BLOCK * BLOCK * 4 / ms / 1e6
    log(f"[kernels] bsr_spmm f32 k={N_MAX}: vs plain {rel:.3e} of max|y|, "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}) (median, {card}); blocks {m32.nnzb} x "
        f"{BLOCK * BLOCK * 4} B = {m32.nnzb * BLOCK * BLOCK * 4 / 1e9:.3f} "
        f"GB, {gbps:.1f} GB/s, {gbps * 1e9 / HBM_BPS:.1%} of "
        f"{HBM_BPS / 1e12:.2f} TB/s")
    if not rel <= 1e-5:
        raise AssertionError(f"bsr_spmm vs plain {rel:.3e} > 1e-5")


def check_kernel_k5(stores, dev, card, stats, max_err):
    """K5 against its plain version, bit for bit, both tiers, on each
    ``(tag, store, k)``: the multi-entry general store and the T band."""
    import torch

    from diaglib_tpu_torch.ops import bsr_sliced as bs

    for tag, st, k in stores:
        g = torch.Generator(device=dev).manual_seed(6)
        x = torch.randn((k, N), generator=g, dtype=torch.float64, device=dev)
        for tier, dt in (("f64", torch.float64), ("f32", torch.float32)):
            nx, na, nlev = bs._tier_params(st.na, dt, None, None)
            xs, _ = bs._slice_x(x.to(dt), nx)
            args = (xs, st.slices, st.rows, st.cols, st.row_start)
            got = bs.sliced_spmm(*args, nx=nx, na=na, nlev=nlev)
            want = bs.sliced_spmm_plain(*args, nx=nx, na=na, nlev=nlev)
            torch.cuda.synchronize()
            err = float((got.long() - want.long()).abs().max())
            max_err["sliced_spmm"] = max(max_err["sliced_spmm"], err)
            if not (torch.equal(got, want) and bool(want.ne(0).any())):
                raise AssertionError(f"sliced_spmm kernel != plain ({tag} "
                                     f"{tier}), max {err}")
            names = device_kernels(lambda: bs.sliced_spmm(
                *args, nx=nx, na=na, nlev=nlev), 1)
            expect_kernels(f"sliced_spmm {tag}", names, ["level_sums_kernel"])
            # bound: the used planes, x's planes and the levels once each
            stats["sliced_spmm"][(tag, tier)] = (
                time_ms(lambda: bs.sliced_spmm(*args, nx=nx, na=na,
                                               nlev=nlev), 10),
                time_ms(lambda: bs.sliced_spmm_plain(*args, nx=nx, na=na,
                                                     nlev=nlev), 3),
                *bound(st.nnzb * BLOCK * na * BLOCK + xs.numel()
                       + nlev * k * N * 4,
                       2 * n_pairs(nx, na, nlev) * st.nnzb * k * BLOCK
                       * BLOCK, INT8_OPS))
            ms, plain, b_ms, b_by = stats["sliced_spmm"][(tag, tier)]
            log(f"[kernels] sliced_spmm {tag} ({st.nnzb} entries, "
                f"{st.max_bpr}/row) k={k} {tier}: kernel == plain, kernel "
                f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), {b_ms / ms:.1%} of the bound, device kernels a "
                f"call {short_names(names)} (median, {card})")


def _irregular_store(dev):
    """A general store at B = 512 (n = 8192) whose 4-way partition has
    ring-offset groups of uneven counts: padding entries and rows a group
    does not cover (the reference's padded pattern, scaled up)."""
    import torch

    from diaglib_tpu_torch.ops import bsr_sliced as bs
    from diaglib_tpu_torch.ops.bsr import BSRMatrix

    nbr = 16
    pattern = sorted({(r, r) for r in range(nbr)} | {
        (0, 4), (1, 5), (8, 12), (2, 15), (13, 0), (6, 14), (7, 9)})
    rows = torch.tensor([p[0] for p in pattern], dtype=torch.int32,
                        device=dev)
    g = torch.Generator(device=dev).manual_seed(12)
    blocks = torch.randn((len(pattern), BLOCK, BLOCK), generator=g,
                         device=dev)
    m = BSRMatrix(blocks, rows, torch.tensor([p[1] for p in pattern],
                                             dtype=torch.int32, device=dev),
                  torch.searchsorted(rows, torch.arange(
                      nbr, dtype=torch.int32, device=dev)).to(torch.int32),
                  nbr * BLOCK, BLOCK)
    return bs.slice_bsr(m)


def check_kernel_k6(general, dev, card, stats, max_err):
    """K6 against its plain version, bit for bit, both tiers, at k = 15 on
    every group of every rank of the 4-way partitions of the general store
    and of the irregular store; then, bit for bit and timed, at the main
    path's shape."""
    import torch

    from diaglib_tpu_torch.ops import bsr_sliced as bs
    from diaglib_tpu_torch.ops import dist_sliced as dsl

    k = N_MAX
    for tag, st in (("general", general), ("irregular", _irregular_store(
            dev))):
        t0 = time.perf_counter()
        part = dsl.distribute_sliced_bsr(st, 4)
        torch.cuda.synchronize()
        nbr_loc, n_loc = part.nbr_loc, part.n_local
        counts = [int((lr < nbr_loc).sum(dim=1).max()) for lr in
                  part.loc_rows]
        padded = sum(int((lr == nbr_loc).sum()) for lr in part.loc_rows)
        uncovered = sum(int((torch.bincount(lr[r][lr[r] < nbr_loc].long(),
                                            minlength=nbr_loc) == 0).sum())
                        for lr in part.loc_rows for r in range(4))
        log(f"[kernels] group_spmm {tag} 4-way partition ("
            f"{time.perf_counter() - t0:.2f} s): steps {list(part.steps)}, "
            f"entries a rank {[lr.shape[1] for lr in part.loc_rows]} (most "
            f"real {counts}), {padded} padding entries, {uncovered} "
            f"uncovered (rank, group, row)")
        if tag == "irregular" and not (padded and uncovered):
            raise AssertionError("the irregular partition lost its padding "
                                 "entries or its uncovered rows")
        g = torch.Generator(device=dev).manual_seed(8)
        x = torch.randn((k, st.n), generator=g, dtype=torch.float64,
                        device=dev)
        for tier, dt in (("f64", torch.float64), ("f32", torch.float32)):
            nx, na, nlev = bs._tier_params(st.na, dt, None, None)
            for i, s in enumerate(part.steps):
                for r in range(4):
                    src = (r + s) % 4
                    xs, _ = bs._slice_x(x[:, src * n_loc:(src + 1) * n_loc]
                                        .to(dt), nx)
                    args = (xs, part.slices[i][r], part.loc_rows[i][r],
                            part.loc_cols[i][r])
                    kw = dict(nx=nx, na=na, nlev=nlev, nbr_loc=nbr_loc)
                    got = dsl.group_spmm(*args, **kw)
                    want = dsl.group_spmm_plain(*args, **kw)
                    torch.cuda.synchronize()
                    err = float((got.long() - want.long()).abs().max())
                    max_err["group_spmm"] = max(max_err["group_spmm"], err)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"group_spmm kernel != plain ({tag} {tier}, "
                            f"rank {r}, s={s}), max {err}")
            log(f"[kernels] group_spmm {tag} {tier}: kernel == plain on all "
                f"{4 * len(part.steps)} groups")
        del part

    # the main path's shape: one rank, one group of every entry
    one = dsl.distribute_sliced_bsr(general, 1, rank=0)
    sl, lr, lc = one.slices[0], one.loc_rows[0], one.loc_cols[0]
    row_start = dsl.group_row_start(lr, one.nbr_loc)
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((k, N), generator=g, dtype=torch.float64, device=dev)
    for tier, dt in (("f64", torch.float64), ("f32", torch.float32)):
        nx, na, nlev = bs._tier_params(general.na, dt, None, None)
        xs, _ = bs._slice_x(x.to(dt), nx)
        kw = dict(nx=nx, na=na, nlev=nlev, nbr_loc=one.nbr_loc)
        got = dsl.group_spmm(xs, sl, lr, lc, **kw, row_start=row_start)
        want = dsl.group_spmm_plain(xs, sl, lr, lc, **kw)
        torch.cuda.synchronize()
        err = float((got.long() - want.long()).abs().max())
        max_err["group_spmm"] = max(max_err["group_spmm"], err)
        if not (torch.equal(got, want) and bool(want.ne(0).any())):
            raise AssertionError(f"group_spmm kernel != plain (main path "
                                 f"{tier}), max {err}")
        del got, want
        names = device_kernels(lambda: dsl.group_spmm(
            xs, sl, lr, lc, **kw, row_start=row_start), 1)
        expect_kernels("group_spmm", names, ["level_sums_kernel"])
        p = sl.shape[0]
        # bound: the used planes, x's planes and the levels (padding row
        # included) once each
        stats["group_spmm"][tier] = (
            time_ms(lambda: dsl.group_spmm(xs, sl, lr, lc, **kw,
                                           row_start=row_start), 10),
            time_ms(lambda: dsl.group_spmm_plain(xs, sl, lr, lc, **kw), 3),
            *bound(p * BLOCK * na * BLOCK + xs.numel()
                   + nlev * k * (one.nbr_loc + 1) * BLOCK * 4,
                   2 * n_pairs(nx, na, nlev) * p * k * BLOCK * BLOCK,
                   INT8_OPS))
        ms, plain, b_ms, b_by = stats["group_spmm"][tier]
        log(f"[kernels] group_spmm main path (1 rank, {p} entries, "
            f"nbr_loc {one.nbr_loc}) k={k} {tier}: kernel == plain, kernel "
            f"{ms:.4f} ms, "
            f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{b_ms / ms:.1%} of the bound, device kernels a call "
            f"{short_names(names)} (median, {card})")


def check_small_matvecs(dev):
    """The float64 symmetric and general sliced matvecs against a dense
    float64 oracle at n = 2048."""
    import torch

    from diaglib_tpu_torch.ops import bsr_sliced as bs
    from diaglib_tpu_torch.ops import bsr_sliced_sym as sym
    from diaglib_tpu_torch.ops.bsr import bsr_to_dense, random_bsr_spd

    small = random_bsr_spd(2048, 256, 4, seed=1, dtype=torch.float32,
                           device=dev)
    dense = bsr_to_dense(small).double()
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((N_MAX, 2048), generator=g, dtype=torch.float64,
                    device=dev)
    ref = x @ dense.T
    for tag, mv in (("symmetric", sym.sym_sliced_matvec(
            sym.slice_bsr_sym(small))), ("general", bs.sliced_bsr_matvec(
                bs.slice_bsr(small)))):
        rel = float((mv(x) - ref).abs().max() / ref.abs().max())
        log(f"[kernels] f64 {tag} sliced matvec n=2048 B=256 vs dense f64: "
            f"max err {rel:.3e} of max|y|")
        if not rel <= 1e-14:
            raise AssertionError(f"f64 {tag} matvec error {rel:.3e} > 1e-14")


def check_pairs(tag, res, a_bsr, b_bsr=None):
    """ok, and the returned pairs' residuals by a plain float64 product."""
    import torch

    if not res.ok:
        raise AssertionError(f"{tag}: the ladder did not converge")
    ev = res.evec[:N_TARG]
    bev = plain_bsr_matvec(b_bsr, ev) if b_bsr is not None else ev
    r = plain_bsr_matvec(a_bsr, ev) - res.eig[:N_TARG, None] * bev
    rms = float((r.norm(dim=1) / N ** 0.5).max())
    rmax = float(r.abs().max())
    extra = ""
    if b_bsr is not None:
        gram = ev @ bev.T
        dev_b = float((gram - torch.eye(N_TARG, dtype=gram.dtype,
                                        device=gram.device)).abs().max())
        extra = f", B-orthonormality {dev_b:.3e}"
        if not dev_b < 1e-10:
            raise AssertionError(f"{tag}: vectors not B-orthonormal")
    log(f"[{tag}] eig[:3]={res.eig[:3].tolist()} plain-product residuals: "
        f"max rms {rms:.3e}, max |r| {rmax:.3e}{extra}")
    if not (rms < 1e-10 and rmax < 1e-9 and bool(torch.isfinite(
            res.eig).all()) and tuple(res.evec.shape) == (N_MAX, N)):
        raise AssertionError(f"{tag}: residuals of the returned pairs above "
                             "tol")


def check_nonsym_pairs(tag, res, s_bsr, t_bsr, tt_bsr, eig_sym):
    """The nonsymmetric ladder's pairs against plain float64 BSR products
    of S, T and T^T (the 4-term series): right and left residuals,
    biorthonormality, and the eigenvalues against the symmetric ladder's
    on S."""
    import torch

    def series(bsr_t, x, sign):
        term, acc = x, x
        for j in range(1, 5):
            term = plain_bsr_matvec(bsr_t, term) * (sign / j)
            acc = acc + term
        return acc

    def r_mv(x):
        return series(t_bsr, plain_bsr_matvec(s_bsr, series(t_bsr, x, 1.0)),
                      -1.0)

    def rt_mv(x):
        return series(tt_bsr, plain_bsr_matvec(s_bsr, series(tt_bsr, x,
                                                             -1.0)), 1.0)

    if not res.ok:
        raise AssertionError(f"{tag}: the ladder did not converge")
    lam = res.eig[:N_TARG, None]
    out = {}
    for side, mv, ev in (("right", r_mv, res.evec_r[:N_TARG]),
                         ("left", rt_mv, res.evec_l[:N_TARG])):
        r = mv(ev) - lam * ev
        out[side] = (float((r.norm(dim=1) / N ** 0.5).max()),
                     float(r.abs().max()))
    biortho = float((res.evec_l[:N_TARG] @ res.evec_r[:N_TARG].T
                     - torch.eye(N_TARG, dtype=torch.float64,
                                 device=lam.device)).abs().max())
    d_eig = float((res.eig[:N_TARG] - eig_sym[:N_TARG]).abs().max())
    log(f"[{tag}] eig[:3]={res.eig[:3].tolist()} plain-product residuals: "
        f"right max rms {out['right'][0]:.3e} max |r| {out['right'][1]:.3e}, "
        f"left max rms {out['left'][0]:.3e} max |r| {out['left'][1]:.3e}; "
        f"biorthonormality {biortho:.3e}; vs symmetric ladder on S "
        f"{d_eig:.3e}")
    if not (all(rms < 1e-10 and rmax < 1e-9 for rms, rmax in out.values())
            and biortho < 1e-10 and d_eig < 1e-7
            and bool(torch.isfinite(res.eig).all())
            and tuple(res.evec_r.shape) == (NS_MAX, N)):
        raise AssertionError(f"{tag}: the returned pairs fail the checks")


def check_casida_pairs(tag, res, apb_bsr, amb_bsr, eff):
    """ok, and the returned paired rows' residuals by plain float64
    products of the float32 blocks, in the solver's own norm: caslr's
    (||rp|| + ||rm||) / sqrt(n); caslr_eff's residuals are the same ones
    scaled by 1/w and normed over sqrt(2)/w, so sqrt(2) more here."""
    import torch

    if not res.ok:
        raise AssertionError(f"{tag}: the ladder did not converge")
    y, z = res.evec[:N_TARG, :N], res.evec[:N_TARG, N:]
    p, q = 0.5 * (y + z), 0.5 * (y - z)
    w = res.eig[:N_TARG, None]
    rp = plain_bsr_matvec(apb_bsr, p) - w * q
    rm = plain_bsr_matvec(amb_bsr, q) - w * p
    scale = 2.0 ** 0.5 if eff else 1.0
    rms = float(((rp.norm(dim=1) + rm.norm(dim=1)) / (scale * N ** 0.5))
                .max())
    rmax = float(((rp.abs().amax(dim=1) + rm.abs().amax(dim=1)) / scale)
                 .max())
    log(f"[{tag}] eig[:3]={res.eig[:3].tolist()} plain-product residuals: "
        f"max rms {rms:.3e}, max |r| {rmax:.3e}")
    if not (rms < 1e-10 and rmax < 1e-9 and bool(torch.isfinite(
            res.eig).all()) and tuple(res.evec.shape) == (N_MAX, 2 * N)):
        raise AssertionError(f"{tag}: residuals of the returned pairs above "
                             "tol")


def casida_ladders(casida, timed, card):
    """Phase 5(g): the two Casida ladders on the (A+B, A-B) pair, checked
    by plain products, and against each other; each captured against
    uncaptured."""
    import torch

    from diaglib_tpu_torch import (
        SolverOptions,
        caslr_eff_ladder,
        caslr_ladder,
    )
    from diaglib_tpu_torch.problems import casida_tdscf_ops

    apb, amb, apb_bsr, amb_bsr = casida
    guess = torch.zeros((N_MAX, 2 * N), dtype=torch.float64,
                        device=apb.diagonal.device)
    ladder_kw = dict(lo_tol=2e-6, lo_iter=60)
    opts = SolverOptions(n_targ=N_TARG, n_max=N_MAX, max_iter=150,
                         tol=1e-10, max_dav=10)
    eff_tiers = casida_tdscf_ops(apb, amb)
    std_tiers = casida_tdscf_ops(apb, amb, prec="std")
    def run_eff(gen):
        return caslr_eff_ladder(*eff_tiers, guess, opts, generator=gen,
                                **ladder_kw)

    def run_std(gen):
        return caslr_ladder(*std_tiers, guess, opts, algorithm=0,
                            generator=gen, **ladder_kw)

    dev = guess.device
    re, we = timed("caslr_eff_ladder", run_eff)
    check_casida_pairs("caslr_eff_ladder", re, apb_bsr, amb_bsr, eff=True)
    captured_vs_uncaptured("caslr_eff_ladder", run_eff, dev, card)
    rs, ws = timed("caslr_ladder algorithm=0", run_std)
    check_casida_pairs("caslr_ladder algorithm=0", rs, apb_bsr, amb_bsr,
                       eff=False)
    captured_vs_uncaptured("caslr_ladder algorithm=0", run_std, dev, card)
    rel = float(((re.eig[:N_TARG] - rs.eig[:N_TARG]).abs()
                 / rs.eig[:N_TARG].abs()).max())
    log(f"[casida] caslr_eff_ladder vs caslr_ladder: eigenvalues {rel:.3e} "
        f"apart (relative), iterations {re.n_iter} vs {rs.n_iter}, matvecs "
        f"{re.n_matvec} vs {rs.n_matvec}, wall {we:.3f} vs {ws:.3f} s "
        f"({card})")
    if not rel <= 1e-9:
        raise AssertionError("the two Casida ladders disagree")


def sharded_vs_unsharded(general, m, timed, guess, opts, card, dev,
                         backend=None, inside=None):
    """Phase 5(f): davidson_ladder with ``sharding=`` over
    dist_sliced_matvec under a one-rank process group (NCCL on the card;
    the captured route, each step's all-reduces inside its graph), held
    against its uncaptured route (captured_vs_uncaptured), then the
    unsharded ladder over sliced_bsr_matvec (K5) on the same store: both
    checked by plain products, with the same counts and eigenvalues
    within 1e-12.  ``inside(one, sh, pc_hi)`` runs under the group, after
    the sharded ladder."""
    import torch
    import torch.distributed as dist

    from diaglib_tpu_torch import davidson_ladder
    from diaglib_tpu_torch.ops import bsr_sliced as bs
    from diaglib_tpu_torch.ops import dist_sliced as dsl
    from diaglib_tpu_torch.parallel import multihost
    from diaglib_tpu_torch.problems import diag_precnd

    f32 = torch.float32
    multihost.initialize(f"tcp://127.0.0.1:{multihost.free_port()}", 1, 0,
                         backend=backend)
    try:
        sh = multihost.global_sharding(general.n)
        log(f"[sharded] {sh} on {dist.get_backend()} "
            f"{multihost.rank_device()}")
        one = dsl.distribute_sliced_bsr(general, 1, rank=sh.rank)
        d_lo = diag_precnd(one.diagonal.to(f32))
        d_hi = diag_precnd(one.diagonal)
        def run_f(gen):
            return davidson_ladder(
                dsl.dist_sliced_matvec(one, sh, dtype=f32), d_lo,
                dsl.dist_sliced_matvec(one, sh), d_hi, guess, opts,
                lo_tol=2e-6, lo_iter=35, generator=gen, sharding=sh)

        rs, ws = timed("sharded davidson_ladder", run_f)
        check_pairs("sharded davidson_ladder", rs, m)
        captured_vs_uncaptured("sharded davidson_ladder", run_f, dev, card,
                               matvec_kernels=("peel_rows", "group_spmm"))
        dist_bsr_twice(m, sh, card)
        if inside is not None:
            inside(one, sh, d_hi)
    finally:
        dist.destroy_process_group()
    ru, wu = timed("K5 davidson_ladder", lambda gen: davidson_ladder(
        bs.sliced_bsr_matvec(general, dtype=f32), d_lo,
        bs.sliced_bsr_matvec(general), d_hi, guess, opts, lo_tol=2e-6,
        lo_iter=35, generator=gen))
    check_pairs("K5 davidson_ladder", ru, m)
    d_eig = float((rs.eig[:N_TARG] - ru.eig[:N_TARG]).abs().max())
    log(f"[sharded] one-rank sharded vs unsharded: eigenvalues {d_eig:.3e} "
        f"apart, iterations {rs.n_iter} vs {ru.n_iter}, matvecs "
        f"{rs.n_matvec} vs {ru.n_matvec}, wall {ws:.3f} vs {wu:.3f} s "
        f"({card})")
    if not (d_eig <= 1e-12 and rs.n_iter == ru.n_iter
            and rs.n_matvec == ru.n_matvec):
        raise AssertionError("the one-rank sharded ladder and the unsharded "
                             "one disagree")


def sharded_inventory(one, sh, pc, guess, opts, dev, counted, card):
    """Phase (i6): profiling.collective_inventory of one iteration of the
    sharded float64 Davidson over dist_sliced_matvec (K6), under (f)'s
    one-rank group, on the captured route (each step's first call runs
    uncaptured and counts, its capture counts nothing), on the unrolled
    route (the captured route's passes, called directly) and on the eager
    one; then the collectives of one warm iteration (from the second flag
    read to the third, torch_fleet.flag_window) of a three-iteration solve
    on each route, where every captured step is a replay that counts the
    collectives its capture recorded.  The captured route's counts must
    be the unrolled route's, both times (the eager loops may stop after
    fewer ortho passes)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from diaglib_tpu_torch import davidson, profiling
    from diaglib_tpu_torch.ops import dist_sliced as dsl
    from diaglib_tpu_torch.utils import graphs

    def solve(max_iter):
        return davidson(dsl.dist_sliced_matvec(one, sh), pc, guess,
                        dataclasses.replace(opts, max_iter=max_iter),
                        generator=torch.Generator(device=dev).manual_seed(1),
                        sharding=sh)

    inv, warm = {}, {}
    for route in ("graphs", "unrolled", "eager"):
        with graphs._recording(None if route == "graphs" else route), \
                profiling.solve_log() as solves:
            inv[route] = counted(
                f"sharded davidson iteration {route}",
                lambda: profiling.collective_inventory(solve, 1))
            with torch_fleet.flag_window(2) as w:
                solve(3)
        if {s["route"] for s in solves.records} != {route} or \
                not w["closed"]:
            raise AssertionError(f"(i6): the {route} solves ran elsewhere")
        warm[route] = w["inventory"]
    log(f"[inventory] one sharded davidson iteration over dist_sliced_matvec"
        f" on a one-rank {dist.get_backend()} group, captured / unrolled / "
        f"eager: " + " / ".join(json.dumps(inv[k]) for k in inv)
        + "; one warm iteration (flag read 2 to 3, the captured steps "
        "replayed): " + " / ".join(json.dumps(warm[k]) for k in warm)
        + f" ({card})")
    if not inv["graphs"].get("all-reduce", {}).get("count"):
        raise AssertionError("the sharded iteration recorded no all-reduce")
    if inv["graphs"] != inv["unrolled"] or \
            warm["graphs"] != warm["unrolled"]:
        raise AssertionError("the captured sharded iteration's collectives "
                             "differ from the unrolled route's")


def sliced_gram_on_card(dev, card):
    """Phase 5(h2): the exact sliced Gram product of sliced_mm="always" at
    the flagship shape, on the card against CPU copies, bit for bit."""
    import torch

    from diaglib_tpu_torch.ops import slicing

    g = torch.Generator(device=dev).manual_seed(7)
    a = torch.randn((N_MAX, N), generator=g, dtype=torch.float64, device=dev)
    b = torch.randn((K3_K, N), generator=g, dtype=torch.float64, device=dev)
    got = slicing.sliced_mmT(a, b)
    same = torch.equal(got.cpu(), slicing.sliced_mmT(a.cpu(), b.cpu()))
    exact = a @ b.T
    rel = float((got - exact).abs().max() / exact.abs().max())
    ms = time_ms(lambda: slicing.sliced_mmT(a, b), 20)
    ref_ms = time_ms(lambda: a @ b.T, 20)
    log(f"[sliced_mm] sliced_mmT ({N_MAX}, {N}) . ({K3_K}, {N})^T: card == "
        f"CPU bit for bit {same}, vs float64 a @ b.T {rel:.3e} of max; "
        f"{ms:.4f} ms, a @ b.T {ref_ms:.4f} ms ({card})")
    if not (same and rel < 1e-14):
        raise AssertionError("sliced_mmT on the card differs from the CPU")


def f64_iters(res):
    """Iterations of a ladder's float64 stage (its history rows)."""
    import torch

    return int(torch.isfinite(res.rms_history[:, 0]).sum())


def rayleigh_quotient(mv, rows, L, dev, seed):
    """An L x L reduced matrix Q A Q^T of the operator ``mv`` (row
    vectors), Q orthonormal rows spanning ``rows`` and seeded random
    rows, applied in blocks of len(rows)."""
    import torch

    k = rows.shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.cat([rows, torch.randn((L - k, rows.shape[1]), generator=g,
                                     dtype=torch.float64, device=dev)])
    q = torch.linalg.qr(x.T)[0].T.contiguous()
    aq = torch.cat([mv(q[i:i + k]) for i in range(0, L, k)])
    return q @ aq.T


def captured_vs_uncaptured(tag, run, dev, card,
                           matvec_kernels=("peel_rows", "sym_spmm")):
    """(a), (b), (d), (e), (f), (g) and (h3): the ladder on its default
    route, its steps captured and replayed as CUDA graphs, and on the
    uncaptured route (the same steps called directly), by
    torch_fleet.route_pair: every returned tensor bit for bit, the same
    counts, the same launches of the ``matvec_kernels`` (K3's differ: a
    replay runs every unrolled ortho pass); the host's reads an iteration
    (torch_fleet.host_reads) on each; the rare-branch reruns, graph
    capture seconds and pool memory of each stage, and the most passes
    each stage's eager ortho loops took on the uncaptured route.  Returns
    route_pair's dict."""
    cmp = torch_fleet.route_pair(run, dev)
    rc, ru = cmp["solves"]["graphs"], cmp["solves"]["eager"]
    counts = [cmp["counts"][k] for k in ("graphs", "eager")]

    def reads_line(route):
        r = cmp["reads"][route]
        per = r["between"]
        return (f"{r['total']} reads in {r['iterations']} iterations "
                f"({r['total'] / r['iterations']:.2f} an iteration; between "
                f"flag reads median {statistics.median(per)}, max "
                f"{max(per)})")

    stages = "; ".join(
        f"{s['solver']} {s['dtype']} {s['iterations']} iterations, reruns "
        f"{s['reruns']}, {s['warmups']} warm-ups {s['warmup_ms']:.1f} ms, "
        f"{s['captures']} captures {s['capture_ms']:.1f} ms, pool "
        f"{s['pool_bytes'] / 2**20:.1f} MiB, replays {s['replays']}, "
        f"{s['reduced']} reduced solves {s['reduced_ms']:.1f} ms, eager "
        f"ortho passes at most {u['passes']} (uncaptured)"
        for s, u in zip(rc, ru))
    log(f"[{tag} captured] {stages} ({card})")
    log(f"[{tag} captured vs uncaptured] bit-identical eig, evec, done, "
        f"histories: {cmp['same']}; counts {counts[0]} vs {counts[1]}; "
        f"launches {json.dumps(cmp['launches']['graphs'])} vs "
        f"{json.dumps(cmp['launches']['eager'])} ({card})")
    log(f"[{tag} host reads] captured: {reads_line('graphs')}; uncaptured "
        f"(the eager loop's shape): {reads_line('eager')} ({card})")
    torch_fleet.check_routes(tag, cmp, matvec_kernels)
    return cmp


def davidson_routes(run_d, ra, wa, m, timed, card, dev, mv_hi):
    """Phase 5(h1): (d)'s sliced Davidson ladder under the host and Jacobi
    reduced routes and the sliced Gram route, against (d)'s "auto" run;
    then one reduced solve at L = 150 by each route."""
    import torch

    from diaglib_tpu_torch import SolverOptions
    from diaglib_tpu_torch.utils import reduced
    from diaglib_tpu_torch.utils.jacobi import jacobi_eigh

    for tag, kw in (("reduced_solver=host", dict(reduced_solver="host")),
                    ("reduced_solver=jacobi", dict(reduced_solver="jacobi")),
                    ("sliced_mm=always", dict(sliced_mm="always"))):
        o = SolverOptions(n_targ=N_TARG, n_max=N_MAX, max_iter=150,
                          tol=1e-10, max_dav=10, **kw)
        res, wall = timed(f"davidson_ladder {tag}",
                          lambda gen, o=o: run_d(o, gen),
                          warm=tag != "reduced_solver=jacobi")
        check_pairs(f"davidson_ladder {tag}", res, m)
        d_eig = float((res.eig[:N_TARG] - ra.eig[:N_TARG]).abs().max())
        hi, hi_a = f64_iters(res), f64_iters(ra)
        log(f"[davidson_ladder] {tag} vs auto: eigenvalues {d_eig:.3e} "
            f"apart, iterations {res.n_iter} vs {ra.n_iter} (f64 stage {hi} "
            f"vs {hi_a}), matvecs {res.n_matvec} vs {ra.n_matvec}, wall "
            f"{wall:.3f} vs {wa:.3f} s ({card})")
        # counts are held where the arithmetic is "auto"'s: the sliced
        # products are exact.  The host route solves the float32 stage's
        # reduced problems in float64 (as the reference's callback does)
        # and the Jacobi route to an adaptive target, so their float32
        # stages end elsewhere and the float64 stages start elsewhere
        same_path = tag == "sliced_mm=always"
        if not (d_eig <= 1e-10
                and (not same_path or abs(res.n_iter - ra.n_iter) <= 2)):
            raise AssertionError(f"davidson_ladder {tag} and auto disagree")
    L = 10 * N_MAX                      # the f64 stage's largest ldu
    red = rayleigh_quotient(mv_hi, ra.evec, L, dev, 11)
    red = 0.5 * (red + red.T)
    w_ref = torch.linalg.eigh(red)[0]
    w_j = jacobi_eigh(red)[0]
    err = float((w_j - w_ref).abs().max() / w_ref.abs().max().clamp(min=1))
    ms_j = time_ms(lambda: jacobi_eigh(red), 5)
    ms_d = time_ms(lambda: torch.linalg.eigh(red), 20)
    ms_h = time_ms(lambda: reduced.eigh(red, "host"), 20)
    log(f"[reduced] L={L} symmetric: jacobi_eigh {ms_j:.3f} ms (off_tol 0, "
        f"eigenvalues {err:.3e} of max from eigh), torch.linalg.eigh "
        f"{ms_d:.3f} ms, host scipy eigh {ms_h:.3f} ms ({card})")
    if not err < 1e-11:
        raise AssertionError("jacobi_eigh on the card is off")


def nonsym_routes(run_e, re_, we, m, t_bsr, tt_bsr, eig_sym, timed, card,
                  dev, mv_hi, backend=None):
    """Phase 5(h3): (e)'s nonsymmetric ladder with the Eberlein reduced
    solve on the card, and under a one-rank process group with sharding=
    (captured, and held against its uncaptured route); then one reduced
    solve at the ladder's largest L by each route."""
    import scipy.linalg
    import torch
    import torch.distributed as dist

    from diaglib_tpu_torch.parallel import multihost
    from diaglib_tpu_torch.utils.eberlein import eberlein_eig

    rd, wd = timed("nonsym_ladder driver=device",
                   lambda gen: run_e(gen, driver="device"), warm=False)
    check_nonsym_pairs("nonsym_ladder driver=device", rd, m, t_bsr, tt_bsr,
                       eig_sym)
    multihost.initialize(f"tcp://127.0.0.1:{multihost.free_port()}", 1, 0,
                         backend=backend)
    try:
        sh = multihost.global_sharding(N)
        log(f"[sharded] {sh} on {dist.get_backend()} "
            f"{multihost.rank_device()}")
        rs, ws = timed("sharded nonsym_ladder",
                       lambda gen: run_e(gen, sharding=sh))
        check_nonsym_pairs("sharded nonsym_ladder", rs, m, t_bsr, tt_bsr,
                           eig_sym)
        captured_vs_uncaptured("sharded nonsym_ladder",
                               lambda gen: run_e(gen, sharding=sh), dev,
                               card, matvec_kernels=("peel_rows", "sym_spmm",
                                                     "sliced_spmm"))
    finally:
        dist.destroy_process_group()
    d_dev = float((rd.eig[:N_TARG] - re_.eig[:N_TARG]).abs().max())
    d_sh = float((rs.eig[:N_TARG] - re_.eig[:N_TARG]).abs().max())
    log(f"[nonsym_ladder] device driver vs host: eigenvalues {d_dev:.3e} "
        f"apart, iterations {rd.n_iter} vs {re_.n_iter}, matvecs "
        f"{rd.n_matvec} vs {re_.n_matvec}, wall {wd:.3f} vs {we:.3f} s; "
        f"one-rank sharded vs unsharded: eigenvalues {d_sh:.3e} apart, "
        f"iterations {rs.n_iter} vs {re_.n_iter}, matvecs {rs.n_matvec} vs "
        f"{re_.n_matvec}, wall {ws:.3f} vs {we:.3f} s ({card})")
    if not (d_dev <= 1e-9 and d_sh <= 1e-9 and rs.n_iter == re_.n_iter
            and rs.n_matvec == re_.n_matvec):
        raise AssertionError("the device-driver or sharded nonsymmetric "
                             "ladder disagrees with (e)")
    L = 10 * NS_MAX                     # dim_dav * n_max: the largest ldu
    red = rayleigh_quotient(mv_hi, rd.evec_r, L, dev, 13)
    w_e = eberlein_eig(red)[0]

    def host():
        out = scipy.linalg.lapack.dgeev(red.cpu().numpy(), 1, 1)
        return [torch.from_numpy(x).to(dev) for x in out[:4]]

    wr, wi = host()[:2]
    real = wi == 0.0
    w_ref = wr[real].sort().values
    err = float((w_e[:w_ref.shape[0]] - w_ref).abs().max()
                / w_ref.abs().max().clamp(min=1))
    ms_e = time_ms(lambda: eberlein_eig(red), 5)
    ms_h = time_ms(host, 20)
    log(f"[reduced] L={L} nonsymmetric: eberlein_eig on the card "
        f"{ms_e:.3f} ms (off_tol 0; eigenvalues {err:.3e} of max(1, "
        f"max|w|) from dgeev's), "
        f"host dgeev with the copies {ms_h:.3f} ms ({card})")
    if not (bool(real.all()) and err < 1e-11):
        raise AssertionError("eberlein_eig on the card is off")


# ---- phase (j): the multi-card path (--ranks 4) ----

def print_profile(profs, card):
    """One warm float64 sharded Davidson iteration on rank 0 on each route
    (captured, its steps replayed, and eager): its collectives by kind,
    with their NCCL kernels' device ms, and the device's busy share of the
    window; the two routes' collectives the same kinds."""
    for route, prof in profs.items():
        inv, nccl = prof["inventory"], prof["nccl"]
        parts = []
        for kind in sorted(set(inv) | set(nccl)):
            rec, dev_ = inv.get(kind, {}), nccl.get(kind, {})
            parts.append(f"{kind} {rec.get('count', 0)} calls "
                         f"{rec.get('bytes', 0)} B, {dev_.get('kernels', 0)}"
                         f" NCCL kernels {dev_.get('device_ms', 0.0):.4f} ms")
        share = (f"{100 * prof['busy_ms'] / prof['window_ms']:.1f} %"
                 if prof["window_ms"] else "not measured")
        log(f"[multicard] profile, one warm f64 sharded davidson iteration "
            f"on rank 0, {route}: {'; '.join(parts)}; device busy "
            f"{prof['busy_ms']:.3f} ms of the {prof['window_ms']:.3f} ms "
            f"window ({share}; host clock {prof['host_ms']:.3f} ms), "
            f"{prof['device_kernels']} device kernels ({card})")
        if not inv.get("all-reduce", {}).get("count"):
            raise AssertionError(f"the profiled {route} iteration made no "
                                 "all-reduce")
        if not nccl:
            log(f"[multicard] torch.profiler saw no NCCL kernel ({route})")
    if set(profs["graphs"]["inventory"]) != set(profs["eager"]["inventory"]):
        raise AssertionError("the captured and eager iterations post other "
                             "kinds of collective")


def four_way_kernels(ranks, card, max_err):
    """K2, K3, K5 and K6 at the shapes the ``ranks``-rank path gives them,
    on cuda:0 after the fleets: each against its plain version (bit for
    bit) and timed with it, with the bound and, for K3, cuBLAS float64.
    K6 at rank 0's largest group of the partition of the flagship's
    general store, K2 on a (15, 65536 / ranks) shard, K3 at the rotation
    (15, 165) @ (165, 65536 / ranks), K5 on the whole store (rank 0's
    unsharded ladder)."""
    import torch

    from diaglib_tpu_torch.ops import bsr_sliced as bs
    from diaglib_tpu_torch.ops import dist_sliced as dsl
    from diaglib_tpu_torch.ops import slicing
    from diaglib_tpu_torch.ops.bsr import random_bsr_spd

    dev = torch.device("cuda:0")
    general = bs.slice_bsr(random_bsr_spd(N, BLOCK, BPR, seed=0,
                                          dtype=torch.float32, device=dev))
    part = dsl.distribute_sliced_bsr(general, ranks, rank=0)
    n_loc, k = part.n_local, N_MAX
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((k, n_loc), generator=g, dtype=torch.float64, device=dev)
    stats = {}
    nx, na, nlev = bs._tier_params(general.na, torch.float64, None, None)
    xs, _ = bs._slice_x(x, nx)
    want_xs, _ = slicing.slice_rows_plain(x, nx, acc_dtype=torch.float64,
                                          work_dtype=torch.float64)
    max_err["peel_rows"] = float((xs.int() - want_xs.reshape(xs.shape).int())
                                 .abs().max())
    if max_err["peel_rows"]:
        raise AssertionError("K2 != its plain version on a shard")
    stats["peel_rows"] = (
        time_ms(lambda: bs._slice_x(x, nx), 50),
        time_ms(lambda: slicing.slice_rows_plain(
            x, nx, acc_dtype=torch.float64, work_dtype=torch.float64), 20),
        *bound(x.numel() * 8 + xs.numel() + k * 8, 4 * nx * x.numel(),
               F32_FLOPS), None)
    i = max(range(len(part.steps)), key=lambda j: part.slices[j].shape[0])
    args = (xs, part.slices[i], part.loc_rows[i], part.loc_cols[i])
    kw = dict(nx=nx, na=na, nlev=nlev, nbr_loc=part.nbr_loc)
    rs = dsl.group_row_start(part.loc_rows[i], part.nbr_loc)
    got, want = dsl.group_spmm(*args, **kw, row_start=rs), \
        dsl.group_spmm_plain(*args, **kw)
    max_err["group_spmm"] = float((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError("K6 != its plain version at rank 0's group")
    p = part.slices[i].shape[0]
    stats["group_spmm"] = (
        time_ms(lambda: dsl.group_spmm(*args, **kw, row_start=rs), 20),
        time_ms(lambda: dsl.group_spmm_plain(*args, **kw), 3),
        *bound(p * BLOCK * na * BLOCK + xs.numel()
               + nlev * k * (part.nbr_loc + 1) * BLOCK * 4,
               2 * n_pairs(nx, na, nlev) * p * k * BLOCK * BLOCK, INT8_OPS),
        None)
    c = torch.randn((K3_M, K3_K), generator=g, dtype=torch.float64,
                    device=dev)
    b = torch.randn((K3_K, n_loc), generator=g, dtype=torch.float64,
                    device=dev)
    got = slicing.sliced_wide_mm(c, b)
    max_err["sliced_wide_mm"] = float((got - slicing.sliced_wide_mm_plain(
        c, b)).abs().max())
    if max_err["sliced_wide_mm"]:
        raise AssertionError("K3 != its plain version on a shard")
    stats["sliced_wide_mm"] = (
        time_ms(lambda: slicing.sliced_wide_mm(c, b), 50),
        time_ms(lambda: slicing.sliced_wide_mm_plain(c, b), 5),
        *bound(8 * (K3_M * K3_K + K3_K * n_loc + K3_M * n_loc),
               2 * n_pairs(8, 8, 9) * K3_M * K3_K * n_loc, INT8_OPS),
        time_ms(lambda: c @ b, 50))
    xf = torch.randn((k, N), generator=g, dtype=torch.float64, device=dev)
    xs5, _ = bs._slice_x(xf, nx)
    a5 = (xs5, general.slices, general.rows, general.cols, general.row_start)
    got = bs.sliced_spmm(*a5, nx=nx, na=na, nlev=nlev)
    want = bs.sliced_spmm_plain(*a5, nx=nx, na=na, nlev=nlev)
    max_err["sliced_spmm"] = float((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError("K5 != its plain version on the whole store")
    del got, want
    stats["sliced_spmm"] = (
        time_ms(lambda: bs.sliced_spmm(*a5, nx=nx, na=na, nlev=nlev), 10),
        time_ms(lambda: bs.sliced_spmm_plain(*a5, nx=nx, na=na, nlev=nlev),
                3),
        *bound(general.nnzb * BLOCK * na * BLOCK + xs5.numel()
               + nlev * k * N * 4,
               2 * n_pairs(nx, na, nlev) * general.nnzb * k * BLOCK * BLOCK,
               INT8_OPS), None)
    shapes = {"peel_rows": f"x shard ({k}, {n_loc}) f64",
              "group_spmm": f"rank 0's group s={part.steps[i]}, {p} entries",
              "sliced_wide_mm": f"({K3_M}, {K3_K}) @ ({K3_K}, {n_loc})",
              "sliced_spmm": f"whole store, {general.nnzb} entries, k={k}"}
    for name, (ms, plain, b_ms, b_by, lib) in stats.items():
        log(f"[kernels] {ranks}-rank shapes, {name} {shapes[name]} f64: "
            f"kernel == plain, kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of the bound"
            + ("" if lib is None else f", cuBLAS f64 {lib:.4f} ms")
            + f" (median, {card})")
    return stats


def multicard(ranks, card):
    """Phase (j): the multi-card path over ``ranks`` cards, one NCCL rank a
    card (see the module docstring)."""
    import tempfile

    import torch

    from diaglib_tpu_torch.ops import _build
    from diaglib_tpu_torch.parallel import mh_dryrun

    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
        f"{_build.build_all():.1f} s, once, before any rank starts")
    count = torch.cuda.device_count()
    if count < ranks:
        raise SystemExit(f"chip_smoke.py --ranks {ranks}: this machine has "
                         f"{count} card(s)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    log(f"[multicard] cards: {'; '.join(smi.stdout.strip().splitlines())}")

    for job in torch_fleet.MC_JOBS:
        runs = []
        for backend, device in (("gloo", "cpu"), ("nccl", None)):
            with tempfile.TemporaryDirectory(prefix="diaglib_mc_") as tmp:
                inp = torch_fleet.job_inputs(job, ranks, workdir=tmp)
                t0 = time.perf_counter()
                runs.append(mh_dryrun.run_fleet(
                    torch_fleet.JOBS[job], inp, ranks, backend, device,
                    timeout=300 if backend == "gloo" else None))
                runs[-1] += (time.perf_counter() - t0,)
        lines = torch_fleet.compare_fleet(job, runs[0][:2], runs[1][:2])
        log(f"[multicard] job {job}: gloo on {ranks} CPU ranks "
            f"{runs[0][2]:.1f} s, NCCL on {ranks} cards {runs[1][2]:.1f} s "
            f"(fleet wall, start-up included)")
        for line in lines:
            log(f"[multicard] job {job}: {line}")

    t0 = time.perf_counter()
    _, outs = mh_dryrun.run_fleet(
        torch_fleet.JOBS["ladders"],
        torch_fleet.ladder_inputs(N, ("davidson", "lobpcg"), True, True),
        ranks)
    log(f"[multicard] flagship fleet wall {time.perf_counter() - t0:.1f} s")
    launches, k5_launches = torch_fleet.check_ladders("flagship", outs,
                                                      card, True)
    print_profile(outs[0]["profile"], card)

    t0 = time.perf_counter()
    _, weak = mh_dryrun.run_fleet(
        torch_fleet.JOBS["ladders"],
        torch_fleet.ladder_inputs(ranks * N, ("davidson",), False, False),
        ranks)
    log(f"[multicard] weak-scaling fleet wall "
        f"{time.perf_counter() - t0:.1f} s")
    torch_fleet.check_ladders("weak", weak, card, False)
    peak = max(o["peak_build_bytes"] for o in weak)
    if peak > 60e9:
        raise AssertionError(f"a card's peak memory {peak / 1e9:.1f} GB")

    max_err = {}
    stats = four_way_kernels(ranks, card, max_err)
    sources = {
        "peel_rows": ("diaglib_tpu_torch/csrc/peel.cu",
                      "diaglib_tpu/ops/slicing.py:268"),
        "sliced_wide_mm": ("diaglib_tpu_torch/csrc/wide_mm.cu",
                           "diaglib_tpu/ops/slicing.py:456"),
        "sliced_spmm": ("diaglib_tpu_torch/csrc/sliced_spmm.cu",
                        "diaglib_tpu/ops/bsr_sliced.py:167"),
        "group_spmm": ("diaglib_tpu_torch/csrc/group_spmm.cu",
                       "diaglib_tpu/ops/dist_sliced.py:135"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        ms, plain, b_ms, b_by, lib = stats[name]
        n = launches.get(name, 0) + k5_launches.get(name, 0)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": max_err[name], "ms": ms,
                        "plain_ms": plain, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib})
    log(json.dumps({"kernels": kernels}))
    missing = [k["name"] for k in kernels if k["launches"] <= 0]
    if missing or k5_launches.get("sliced_spmm", 0) <= 0:
        raise AssertionError(f"the four-rank path never launched {missing}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": ranks}}), flush=True)


# ---- phase (i): the user's surface on the card ----

DEMO_FILES = {"symm": ["davidson.txt", "lapack.txt", "lobpcg.txt"],
              "geneig": ["davidson.txt", "lapack.txt", "lobpcg.txt"],
              "caslr": ["cashp.txt", "caslr.txt", "caslr_eff.txt",
                        "lapack.txt"],
              "scflr": ["caslr.txt", "caslr_eff.txt", "lapack.txt"],
              "nonsym": ["nonsym.txt"]}


def _result_eigs(path):
    """The eigenvalues of a demo result file."""
    return [float(m.group(1)) for m in re.finditer(
        r"eigenvalue #\s+\d+:\s+(\S+)", path.read_text())]


def demo_runs(card, timeout=300.0):
    """Phase (i1): the five demo subcommands at the demo's defaults (n 1000,
    n_want 10, tol 1e-8) on the card, one process each, all at once, each
    in its own temporary directory: exit 0, the reference's files, every
    iterative file's eigenvalues within 2e-6 of its lapack.txt, and for
    nonsym the printed max |eig - dense| below 1e-6."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="diaglib_demo_") as tmp:
        procs = {}
        t0 = time.perf_counter()
        try:
            for cmd in DEMO_FILES:
                procs[cmd] = subprocess.Popen(
                    [sys.executable, "-m", "diaglib_tpu_torch.demo",
                     "--out-dir", str(Path(tmp) / cmd), cmd], cwd=ROOT,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
            outs = {}
            for cmd, p in procs.items():
                left = max(timeout - (time.perf_counter() - t0), 1.0)
                outs[cmd], _ = p.communicate(timeout=left)
                if p.returncode != 0:
                    raise AssertionError(f"demo {cmd} exited {p.returncode}:"
                                         f"\n{outs[cmd][-4000:]}")
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        secs = time.perf_counter() - t0
        for cmd, files in DEMO_FILES.items():
            out_dir = Path(tmp) / cmd
            if sorted(p.name for p in out_dir.iterdir()) != files:
                raise AssertionError(f"demo {cmd} wrote "
                                     f"{sorted(os.listdir(out_dir))}")
            walls = re.findall(r"timings for (\S+) \(wall\):\s+total:\s+(\S+)",
                               outs[cmd])
            if cmd == "nonsym":
                err = float(re.search(
                    r"max \|eig - dense\| over \d+ roots: (\S+)",
                    outs[cmd]).group(1))
                what = "printed max |eig - dense|"
            else:
                ref = _result_eigs(out_dir / "lapack.txt")
                err = max(max(abs(a - b) for a, b in zip(
                    _result_eigs(out_dir / f), ref))
                    for f in files if f != "lapack.txt")
                what = "result files' eigenvalues against lapack.txt"
            log(f"[demo {cmd}] exit 0, files {files}; {what} {err:.2e}; "
                f"walls {', '.join(f'{n} {w} s' for n, w in walls)} "
                f"(first calls) ({card})")
            bound_ = 1e-6 if cmd == "nonsym" else 2e-6
            if not err < bound_:
                raise AssertionError(f"demo {cmd}: {what} {err:.2e}")
    log(f"[demo] five subcommands in parallel processes: {secs:.1f} s")


def checkpoint_resume(mv_hi, pc_hi, ra, m, dev, counted, card):
    """Phase (i2): the float64 Davidson of the ladder's second stage on
    (d)'s store, interrupted at 6 iterations, saved and loaded back (every
    field bit-equal, on the card), resumed: ok, fewer iterations than the
    same solve from the zero guess, eigenvalues within 1e-10 of (d)'s and
    check_pairs' residual bounds."""
    import dataclasses
    import tempfile

    import torch

    from diaglib_tpu_torch import SolverOptions, checkpoint, davidson

    opts = SolverOptions(n_targ=N_TARG, n_max=N_MAX, max_iter=150,
                         tol=1e-10, max_dav=10)
    zero = torch.zeros((N_MAX, N), dtype=torch.float64, device=dev)

    def solve(guess, o=opts):
        return davidson(mv_hi, pc_hi, guess, o,
                        generator=torch.Generator(device=dev).manual_seed(1))

    part = counted("checkpoint interrupted",
                   lambda: solve(zero, dataclasses.replace(opts, max_iter=6)))
    if part.ok:
        raise AssertionError("checkpoint: the interrupted solve converged")
    with tempfile.TemporaryDirectory(prefix="diaglib_ckpt_") as tmp:
        t0 = time.perf_counter()
        checkpoint.save(tmp, part)
        t1 = time.perf_counter()
        back = checkpoint.load(tmp, like=part)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        nbytes = sum(p.stat().st_size for p in Path(tmp).iterdir())
    for f in dataclasses.fields(part):
        x, y = getattr(part, f.name), getattr(back, f.name)
        same = (torch.equal(x, y) and y.device == x.device
                if isinstance(x, torch.Tensor) else x == y)
        if not same:
            raise AssertionError(f"checkpoint: {f.name} did not round-trip")
    resumed = counted("checkpoint resumed", lambda: solve(back.evec))
    scratch = counted("checkpoint from the zero guess", lambda: solve(zero))
    check_pairs("checkpoint resumed", resumed, m)
    d_eig = float((resumed.eig[:N_TARG] - ra.eig[:N_TARG]).abs().max())
    log(f"[checkpoint] save {t1 - t0:.3f} s, load {t2 - t1:.3f} s, "
        f"{nbytes / 1e6:.1f} MB, every field bit-equal on {back.evec.device}"
        f"; resumed after {part.n_iter} iterations: ok, {resumed.n_iter} "
        f"iterations against {scratch.n_iter} from the zero guess, "
        f"eigenvalues {d_eig:.3e} from (d)'s ({card})")
    if not (resumed.n_iter < scratch.n_iter and d_eig <= 1e-10):
        raise AssertionError("checkpoint: the resumed solve is no better "
                             "than a solve from scratch")


# what the trace of a (d), (a) or (e) ladder must name: the phase scopes and
# K1-K3
TRACE_NAMES = ("matvec", "rayleigh-ritz", "expand-ortho", "sym_spmm_kernel",
               "slice_rows_kernel", "wide_mm_kernel")


def traced_ladder(tag, run, dev, counted, card):
    """Phase (i3): profiling.trace around one warm ladder ``run(gen)`` on
    its default route ((d)'s, (a)'s and (e)'s, captured), in a
    profiling.solve_log: the trace file names the three phase scopes and
    the kernels K1, K2 and K3; prints the device-busy share of the window,
    device kernels an iteration, the host and device time under each scope
    and under each of the step loop's leaf spans, the device's idle time
    by the leaf span the host was in, each stage's record, and the kernels
    that take the most device time."""
    import glob
    import tempfile

    import torch

    from diaglib_tpu_torch import profiling

    gen = torch.Generator(device=dev).manual_seed(1)
    with tempfile.TemporaryDirectory(prefix="diaglib_trace_") as tmp:
        with profiling.solve_log() as solves, profiling.trace(tmp):
            t0 = time.perf_counter()
            res = counted(f"traced {tag}", lambda: run(gen))
            wall_s = time.perf_counter() - t0
        files = glob.glob(str(Path(tmp) / "*.pt.trace.json"))
        if len(files) != 1:
            raise AssertionError(f"trace: {files}")
        size = Path(files[0]).stat().st_size
        with open(files[0]) as f:
            trace_events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in trace_events}
    missing = [w for w in TRACE_NAMES
               if not any(w == n or w in short_names([n]) for n in names)]
    if missing:
        raise AssertionError(f"trace names no {missing}")
    busy, n_kernels, host, outside, top = scope_breakdown(trace_events,
                                                          SCOPES)
    parts = ", ".join(f"{k} {c} x host {h:.1f} ms device {d:.1f} ms"
                      for k, (c, h, d) in host.items())
    tops = ", ".join(f"{n} {c} x {t:.1f} ms" for n, c, t in top[:8])
    log(f"[trace] {tag} under profiling.trace: ok={res.ok}, "
        f"{res.n_iter} iterations, wall {wall_s:.3f} s (profiled); trace "
        f"{size / 1e6:.1f} MB names {list(TRACE_NAMES)}; device busy "
        f"{busy:.1f} ms of the {wall_s * 1e3:.1f} ms wall "
        f"({100 * busy / (wall_s * 1e3):.1f} %); {n_kernels} device "
        f"kernels, {n_kernels / res.n_iter:.1f} an iteration ({card})")
    log(f"[trace] {tag} scopes (kernels by where they were launched): "
        f"{parts}; "
        f"launched outside them {outside:.1f} ms")
    log(f"[trace] {tag} device time by kernel: {tops}")
    _, _, leaf, _, _ = scope_breakdown(trace_events, profiling.LEAF_SPANS)
    # the ladder's window: its first scope's start to its last one's end
    marks = [(e["ts"], e["ts"] + e["dur"]) for e in trace_events
             if e.get("cat") == "user_annotation"
             and e.get("name") in SCOPES + profiling.LEAF_SPANS]
    idle = idle_by_scope(trace_events, profiling.LEAF_SPANS,
                         min(a for a, _ in marks), max(b for _, b in marks))
    log(f"[trace] {tag} leaf spans: " + ", ".join(
        f"{k} {c} x host {h:.1f} ms device {d:.1f} ms"
        for k, (c, h, d) in leaf.items())
        + "; device idle by leaf span: " + ", ".join(
            f"{k} {v * 1e3:.1f} ms" for k, v in idle))
    log(f"[trace] {tag} records: " + "; ".join(
        f"{s['dtype']} {s['iterations']} iterations, {s['warmups']} warm-ups "
        f"{s['warmup_ms']:.1f} ms, {s['captures']} captures "
        f"{s['capture_ms']:.1f} ms, reruns {s['reruns']}, {s['reduced']} "
        f"reduced solves {s['reduced_ms']:.1f} ms"
        for s in solves.records))
    if sum(s["iterations"] for s in solves.records) != res.n_iter:
        raise AssertionError("the stages' records miss iterations")
    if not res.ok:
        raise AssertionError("the traced ladder did not converge")


def host_timers(mv_hi, run_d, k1_ms, wa, dev, counted, card):
    """Phase (i4): profiling.phase_timings of the float64 symmetric sliced
    matvec at (15, 65536) beside phase 4's K1 time, and profiling.wall of
    one (d) ladder beside (d)'s wall."""
    import torch

    from diaglib_tpu_torch import SolverOptions, profiling

    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((N_MAX, N), generator=g, dtype=torch.float64, device=dev)
    s = counted("phase_timings", lambda: profiling.phase_timings(
        mv_hi, x, reps=20))
    opts = SolverOptions(n_targ=N_TARG, n_max=N_MAX, max_iter=150,
                         tol=1e-10, max_dav=10)
    res, secs = counted("wall", lambda: profiling.wall(
        run_d, opts, torch.Generator(device=dev).manual_seed(1)))
    log(f"[timers] phase_timings f64 symmetric sliced matvec (15, {N}): "
        f"{s * 1e3:.4f} ms a call on the host clock (the whole matvec), "
        f"phase 4's K1 alone {k1_ms:.4f} ms (CUDA events); wall of one "
        f"davidson_ladder {secs:.3f} s (ok={res.ok}, {res.n_iter} "
        f"iterations) beside (d)'s {wa:.3f} s ({card})")
    if not res.ok:
        raise AssertionError("the timed ladder did not converge")


def ell_operator(n, seed=7):
    """tests/test_ell.py's random sparse SPD at size n, built sparse on the
    host (scipy CSR): the same numpy draws in the same order, duplicates
    summed, symmetrized, the diagonal set to 2 + the row's absolute sum +
    a uniform draw."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    k = 4 * n
    r = rng.integers(0, n, k)
    c = rng.integers(0, n, k)
    v = rng.standard_normal(k) * 0.1
    a = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    a = (0.5 * (a + a.T)).tocsr()
    diag = 2.0 + np.asarray(abs(a).sum(axis=1)).ravel() + rng.random(n)
    a.setdiag(diag)
    a.eliminate_zeros()
    return a.tocsr()


def ell_phase(dev, counted, card):
    """Phase (i5): the ELL operator at n = 65536 on the card: its matvec at
    k = 15 within 1e-14 max|y| of a scipy CSR float64 product, and davidson
    over it with tests/test_ell.py's options (4 roots, n_max 8, tol 1e-9;
    max_iter 300, not 100) ok, with residuals recomputed on the host below
    tol."""
    import numpy as np
    import torch

    from diaglib_tpu_torch import SolverOptions, davidson
    from diaglib_tpu_torch.ops import ell_diagonal, ell_from_coo, ell_matvec
    from diaglib_tpu_torch.problems import diag_precnd

    t0 = time.perf_counter()
    a = ell_operator(N)
    coo = a.tocoo()
    m = ell_from_coo(coo.row, coo.col, coo.data, N, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    x = np.random.default_rng(8).standard_normal((N_MAX, N))
    xt = torch.as_tensor(x, device=dev)
    mv = ell_matvec(m)
    y = mv(xt).cpu().numpy()
    ref = (a @ x.T).T
    err = float(np.abs(y - ref).max() / np.abs(ref).max())
    mv_ms = time_ms(lambda: mv(xt), 20)
    # tests/test_ell.py's options, but for max_iter: the lowest diagonal
    # entries crowd at this n, and 100 iterations are not enough
    opts = SolverOptions(n_targ=4, n_max=8, max_iter=300, tol=1e-9)
    zero = torch.zeros((8, N), dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    res = counted("ell davidson", lambda: davidson(
        ell_matvec(m), diag_precnd(ell_diagonal(m)), zero, opts,
        generator=torch.Generator(device=dev).manual_seed(3)))
    solve_s = time.perf_counter() - t0
    ev = res.evec[:4].cpu().numpy()
    r = (a @ ev.T).T - res.eig[:4, None].cpu().numpy() * ev
    rms = float((np.linalg.norm(r, axis=1) / N ** 0.5).max())
    rmax = float(np.abs(r).max())
    log(f"[ell] n={N}: {m.slots} slots, {m.nnz} nonzeros, built on the host "
        f"and moved in {build_s:.2f} s; ell_matvec k={N_MAX}: {err:.2e} of "
        f"max|y| from scipy CSR, {mv_ms:.3f} ms; davidson (4 roots, n_max "
        f"8, tol 1e-9): ok={res.ok}, {res.n_iter} iterations, {solve_s:.3f} "
        f"s, host residuals max rms {rms:.2e}, max |r| {rmax:.2e} ({card})")
    if not (err <= 1e-14 and res.ok and rms < 1e-9 and rmax < 1e-8):
        raise AssertionError("ELL on the card is off")


def main(argv=None):
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ranks", type=int, default=1, choices=(1, 4),
                        help="1 (the default): phases 1-6 on one card; 4: "
                        "phase (j), the multi-card path, one NCCL rank a "
                        "card")
    args = parser.parse_args(argv)

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
    if args.ranks > 1:
        multicard(args.ranks, card)
        return

    from diaglib_tpu_torch import (
        SolverOptions,
        bsr_matvec,
        davidson_ladder,
        gen_david_ladder,
        lobpcg_ladder,
        nonsym_ladder,
    )
    from diaglib_tpu_torch.ops import _build, bsr
    from diaglib_tpu_torch.ops import bsr_sliced as bs
    from diaglib_tpu_torch.ops import bsr_sliced_sym as sym
    from diaglib_tpu_torch.ops.bsr import random_bsr_spd
    from diaglib_tpu_torch.utils.graphs import kernel_counters
    from diaglib_tpu_torch.problems import (
        _band_bsr,
        _bsr_transpose_band,
        bsr_casida_tdscf,
        bsr_gen_problem,
        bsr_nonsym_similarity,
        diag_precnd,
        nonsym_similarity_ops,
    )

    # ---- 2. build ----
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: "
        f"{_build.build_all():.1f} s")

    # ---- 3. operators ----
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
    general = bs.slice_bsr(m)
    torch.cuda.synchronize()
    log(f"[operator] general store: {general.nnzb} entries, "
        f"{general.max_bpr}/row, {general.nbytes / 1e9:.3f} GB "
        f"({time.perf_counter() - t2:.2f} s)")
    m64 = bsr.BSRMatrix(m.blocks_t.double(), m.rows, m.cols, m.row_start,
                        m.n, m.block)
    t0 = time.perf_counter()
    gen_a, gen_b = bsr_gen_problem(N, BLOCK, BPR, seed=0, device=dev)
    torch.cuda.synchronize()
    # the metric's BSR blocks for the residual oracle: the same builder
    # call bsr_gen_problem makes (seed + 1), so the same values
    b_bsr = random_bsr_spd(N, BLOCK, 4, seed=1, dtype=torch.float32,
                           off_scale=0.1, n_low_modes=0, device=dev)
    log(f"[operator] bsr_gen_problem({N}, {BLOCK}, {BPR}): A store "
        f"{gen_a.nbytes / 2**30:.3f} GiB, B store {gen_b.nbytes / 2**30:.3f}"
        f" GiB ({time.perf_counter() - t0:.2f} s)")
    if not (torch.equal(gen_b.diagonal, bsr.bsr_diagonal(b_bsr).double())
            and torch.equal(gen_a.diagonal, store.diagonal)):
        raise AssertionError("the residual oracles are not "
                             "bsr_gen_problem's (A, B)")
    t0 = time.perf_counter()
    ns_stores, ns_diag = bsr_nonsym_similarity(N, BLOCK, BPR, seed=0,
                                               device=dev)
    torch.cuda.synchronize()
    # the T oracle: the same _band_bsr call bsr_nonsym_similarity makes
    # (seed + 1)
    t_bsr = _band_bsr(N, BLOCK, 1, 0.01, device=dev)
    tt_bsr = _bsr_transpose_band(t_bsr)
    log(f"[operator] bsr_nonsym_similarity({N}, {BLOCK}, {BPR}): T and T^T "
        f"stores {ns_stores[1].nnzb} entries each, "
        f"{ns_stores[1].nbytes / 1e9:.3f} GB each "
        f"({time.perf_counter() - t0:.2f} s)")
    if not (torch.equal(ns_diag, store.diagonal)
            and torch.equal(ns_stores[0].slices, store.slices)
            and torch.equal(bs.slice_bsr(t_bsr).slices, ns_stores[1].slices)
            and torch.equal(bs.slice_bsr(tt_bsr).slices,
                            ns_stores[2].slices)):
        raise AssertionError("the residual oracles are not "
                             "bsr_nonsym_similarity's (S, T, T^T)")
    t0 = time.perf_counter()
    _, _, _, (c_apb, c_amb) = bsr_casida_tdscf(N, BLOCK, CASIDA_BPR, seed=0,
                                               device=dev)
    torch.cuda.synchronize()
    # the A+B and A-B oracles: the same random_bsr_spd calls
    # bsr_casida_tdscf makes (one seed, off_scale 0.3 and 0.15)
    c_bsr = [random_bsr_spd(N, BLOCK, CASIDA_BPR, seed=0,
                            dtype=torch.float32, off_scale=scale, device=dev)
             for scale in (0.3, 0.15)]
    log(f"[operator] bsr_casida_tdscf({N}, {BLOCK}, {CASIDA_BPR}): A+B and "
        f"A-B stores {c_apb.slices.shape[0]} + {c_apb.slices1.shape[0]} "
        f"entries, {c_apb.nbytes / 2**30:.3f} + {c_amb.nbytes / 2**30:.3f} "
        f"GiB; float32 oracles {c_bsr[0].nnzb} blocks, "
        f"{sum(b.blocks_t.numel() * 4 for b in c_bsr) / 2**30:.3f} GiB "
        f"({time.perf_counter() - t0:.2f} s)")
    if not (torch.equal(bsr.bsr_diagonal(c_bsr[0]).double(), c_apb.diagonal)
            and torch.equal(bsr.bsr_diagonal(c_bsr[1]).double(),
                            c_amb.diagonal)):
        raise AssertionError("the residual oracles are not "
                             "bsr_casida_tdscf's (A+B, A-B)")

    # ---- 4. kernels against their plain versions ----
    stats = {"peel_rows": {}, "sym_spmm": {}, "sliced_wide_mm": {},
             "sliced_spmm": {}, "group_spmm": {}}
    max_err = {"peel_rows": 0.0, "sym_spmm": 0.0, "sliced_wide_mm": 0.0,
               "bsr_spmm": 0.0, "sliced_spmm": 0.0, "group_spmm": 0.0}
    check_kernels_k1_k2(store, dev, card, stats, max_err)
    check_kernel_k2_front_end(store, dev, card, stats, max_err)
    check_kernel_k3(dev, card, stats, max_err)
    check_kernel_k4(m, dev, card, stats, max_err)
    check_kernel_k5((("T band", ns_stores[1], NS_MAX),
                     ("general", general, N_MAX)), dev, card, stats,
                    max_err)
    check_kernel_k6(general, dev, card, stats, max_err)
    check_small_matvecs(dev)

    # ---- 5. the ladders ----
    counters = kernel_counters()
    launches = dict.fromkeys(counters, 0)
    opts = SolverOptions(n_targ=N_TARG, n_max=N_MAX, max_iter=150,
                         tol=1e-10, max_dav=10)
    guess = torch.zeros((N_MAX, N), dtype=torch.float64, device=dev)
    f32 = torch.float32

    def timed(tag, run, warm=True):
        """Warm-up run (unless not ``warm``), then a run with every launch
        count at 0."""
        def once():
            res = run(torch.Generator(device=dev).manual_seed(1))
            torch.cuda.synchronize()
            return res
        warm_s = math.nan
        if warm:
            t0 = time.perf_counter()
            once()
            warm_s = time.perf_counter() - t0
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = once()
        wall_s = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in counters.items()}
        for k, v in counts.items():
            launches[k] += v
        if hasattr(res, "rms_history"):
            f64_iters = int(torch.isfinite(res.rms_history[:, 0]).sum())
            stages = f"f64 stage {f64_iters}"
        else:
            right, left = (int(torch.isfinite(h[:, 0]).sum()) for h in (
                res.rms_history_r, res.rms_history_l))
            stages = (f"f32 stage {res.n_iter - right - left}, f64 right "
                      f"{right}, f64 left {left}")
        log(f"[{tag}] ok={res.ok} ortho_ok={res.ortho_ok} iterations="
            f"{res.n_iter} ({stages}) n_matvec={res.n_matvec} "
            f"wall {wall_s:.3f} s (first run {warm_s:.3f} s) launches "
            f"{json.dumps(counts)} ({card})")
        return res, wall_s

    def counted(tag, fn):
        """``fn()`` with every launch count at 0 before it; its counts join
        the kernels line."""
        for f in counters.values():
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in counters.items()}
        for k, v in counts.items():
            launches[k] += v
        log(f"[{tag}] launches {json.dumps(counts)}")
        return out

    pc_lo = diag_precnd(store.diagonal.to(f32))
    pc_hi = diag_precnd(store.diagonal)
    mv_lo = sym.sym_sliced_matvec(store, dtype=f32)
    mv_hi = sym.sym_sliced_matvec(store)

    # (a) LOBPCG ladder on the symmetric store, captured and uncaptured
    def run_a(gen):
        return lobpcg_ladder(mv_lo, pc_lo, mv_hi, pc_hi, guess, opts,
                             lo_tol=2e-6, lo_iter=70, generator=gen)

    res, _ = timed("lobpcg_ladder", run_a)
    check_pairs("lobpcg_ladder", res, m)
    captured_vs_uncaptured("lobpcg_ladder", run_a, dev, card)

    # (b) generalized Davidson ladder on the (A, B) pair, captured and
    # uncaptured
    def run_b(gen):
        return gen_david_ladder(
            sym.sliced_matvec_any(gen_a, dtype=f32),
            diag_precnd(gen_a.diagonal.to(f32)),
            sym.sliced_matvec_any(gen_b, dtype=f32),
            sym.sliced_matvec_any(gen_a), diag_precnd(gen_a.diagonal),
            sym.sliced_matvec_any(gen_b), guess, opts, lo_tol=2e-6,
            lo_iter=60, generator=gen)

    res, _ = timed("gen_david_ladder", run_b)
    check_pairs("gen_david_ladder", res, m, b_bsr)
    captured_vs_uncaptured("gen_david_ladder", run_b, dev, card)
    del gen_a, gen_b, b_bsr

    # (c) the plain-BSR Davidson ladder (K4 in the float32 stage)
    d = bsr.bsr_diagonal(m64)
    res, _ = timed("bsr_davidson_ladder", lambda gen: davidson_ladder(
        bsr_matvec(m), diag_precnd(d.to(f32)), bsr_matvec(m64),
        diag_precnd(d), guess, opts, lo_tol=2e-6, lo_iter=35,
        generator=gen))
    check_pairs("bsr_davidson_ladder", res, m)
    plain_bsr_twice(m64, dev, card)
    del m64

    # (d) the sliced Davidson ladder, wide rotations on ("auto") and off
    runs, runs_opts = {}, {}
    for mode in ("auto", "never"):
        o = runs_opts[mode] = SolverOptions(n_targ=N_TARG, n_max=N_MAX,
                                            max_iter=150, tol=1e-10,
                                            max_dav=10, wide_mm=mode)
        runs[mode] = timed(f"davidson_ladder wide_mm={mode}",
                           lambda gen, o=o: davidson_ladder(
                               mv_lo, pc_lo, mv_hi, pc_hi, guess, o,
                               lo_tol=2e-6, lo_iter=35, generator=gen))
        check_pairs(f"davidson_ladder wide_mm={mode}", runs[mode][0], m)
    (ra, wa), (rn, wn) = runs["auto"], runs["never"]
    d_eig = float((ra.eig[:N_TARG] - rn.eig[:N_TARG]).abs().max())
    log(f"[davidson_ladder] auto vs never: eigenvalues {d_eig:.3e} apart, "
        f"iterations {ra.n_iter} vs {rn.n_iter}, wall {wa:.3f} vs "
        f"{wn:.3f} s ({card})")
    if not (d_eig <= 1e-10 and abs(ra.n_iter - rn.n_iter) <= 2):
        raise AssertionError("wide_mm='auto' and 'never' disagree")
    captured_vs_uncaptured("davidson_ladder wide_mm=auto", lambda gen:
                           davidson_ladder(mv_lo, pc_lo, mv_hi, pc_hi, guess,
                                           runs_opts["auto"], lo_tol=2e-6,
                                           lo_iter=35, generator=gen),
                           dev, card)

    # (h2) the sliced Gram product on the card; (h1) (d) under the host and
    # Jacobi reduced routes and the sliced Gram route
    def run_d(o, gen):
        return davidson_ladder(mv_lo, pc_lo, mv_hi, pc_hi, guess, o,
                               lo_tol=2e-6, lo_iter=35, generator=gen)

    sliced_gram_on_card(dev, card)
    davidson_routes(run_d, ra, wa, m, timed, card, dev, mv_hi)

    # (e) the two-sided nonsymmetric ladder on R = E_- S E_+
    ns_opts = SolverOptions(n_targ=N_TARG, n_max=NS_MAX, max_iter=150,
                            tol=1e-10, max_dav=10)
    ns_guess = torch.zeros((NS_MAX, N), dtype=torch.float64, device=dev)
    ns_lo = nonsym_similarity_ops(ns_stores, dtype=f32)
    ns_hi = nonsym_similarity_ops(ns_stores)

    def run_e(gen, **kw):
        return nonsym_ladder(
            *ns_lo, diag_precnd(ns_diag.to(f32)), *ns_hi,
            diag_precnd(ns_diag), ns_guess, ns_opts, side="c", lo_tol=2e-6,
            lo_iter=60, generator=gen, **kw)

    res, we = timed("nonsym_ladder", run_e)
    check_nonsym_pairs("nonsym_ladder", res, m, t_bsr, tt_bsr, ra.eig)
    captured_vs_uncaptured("nonsym_ladder", run_e, dev, card,
                           matvec_kernels=("peel_rows", "sym_spmm",
                                           "sliced_spmm"))
    # (i3) where the captured nonsymmetric ladder's time goes: the host
    # dgeev between the steps sits under the rayleigh-ritz scope
    traced_ladder("nonsym_ladder", run_e, dev, counted, card)
    # (h3) the device driver and the one-rank sharded ladder on (e)'s stores
    nonsym_routes(run_e, res, we, m, t_bsr, tt_bsr, ra.eig, timed, card,
                  dev, ns_hi[0])
    del ns_stores, ns_lo, ns_hi

    # (f) the sharded ladder over the distributed sliced operator (K6), and
    # (i6) the collectives of one sharded iteration under its group
    sharded_vs_unsharded(general, m, timed, guess, opts, card, dev,
                         inside=lambda one, sh, pc: sharded_inventory(
                             one, sh, pc, guess, opts, dev, counted, card))
    del general

    # (g) the Casida ladders on the (A+B, A-B) pair
    casida_ladders((c_apb, c_amb, *c_bsr), timed, card)
    del c_apb, c_amb, c_bsr

    # (i) the user's surface on the card: the demo, checkpoint and resume,
    # the trace and the timers on (d)'s store and ladder, ELL
    demo_runs(card)
    checkpoint_resume(mv_hi, pc_hi, ra, m, dev, counted, card)
    traced_ladder("davidson_ladder", lambda gen: run_d(opts, gen), dev,
                  counted, card)
    traced_ladder("lobpcg_ladder", run_a, dev, counted, card)
    host_timers(mv_hi, run_d, stats["sym_spmm"]["f64"][0], wa, dev, counted,
                card)
    ell_phase(dev, counted, card)

    # ---- 6. kernel usage ----
    sources = {
        "peel_rows": ("diaglib_tpu_torch/csrc/peel.cu",
                      "diaglib_tpu/ops/slicing.py:268"),
        "sym_spmm": ("diaglib_tpu_torch/csrc/sym_spmm.cu",
                     "diaglib_tpu/ops/bsr_sliced_sym.py:220"),
        "sliced_wide_mm": ("diaglib_tpu_torch/csrc/wide_mm.cu",
                           "diaglib_tpu/ops/slicing.py:456"),
        "bsr_spmm": ("diaglib_tpu_torch/csrc/bsr_spmm.cu",
                     "diaglib_tpu/ops/bsr.py:138"),
        "sliced_spmm": ("diaglib_tpu_torch/csrc/sliced_spmm.cu",
                        "diaglib_tpu/ops/bsr_sliced.py:167"),
        "group_spmm": ("diaglib_tpu_torch/csrc/group_spmm.cu",
                       "diaglib_tpu/ops/dist_sliced.py:135"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": max_err[name]}
        if name == "peel_rows":
            # the main path's shape: the fused entry on the symmetric
            # store's (15, 65536) with u, float64 tier; then the others and
            # the pre-scaled entry
            st = stats[name]
            entry.update(st["sym f64"], library_ms=None)
            for tag in ("sym f32", "k10 f64", "k10 f32"):
                key = tag.replace("sym ", "").replace(" ", "_")
                entry.update({f"{k}_{key}": v for k, v in st[tag].items()
                              if k != "bound_by"})
            for tier in ("f64", "f32"):
                ms_, plain_, b_, _ = st[f"prescaled {tier}"]
                entry.update({f"prescaled_ms_{tier}": ms_,
                              f"prescaled_device_ms_{tier}":
                                  st[f"prescaled device {tier}"],
                              f"prescaled_plain_ms_{tier}": plain_,
                              f"prescaled_bound_ms_{tier}": b_})
        elif name in ("sym_spmm", "group_spmm"):
            (ms, plain, b_ms, b_by), (ms32, plain32, b32, _) = (
                stats[name]["f64"], stats[name]["f32"])
            entry.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, ms_f32=ms32, plain_ms_f32=plain32,
                         bound_ms_f32=b32)
        elif name == "sliced_spmm":
            # the main path's shape: the T band store at k = 10
            ms, plain, b_ms, b_by = stats[name][("T band", "f64")]
            entry.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None)
            for (tag, tier), (ms_, plain_, b_, _) in stats[name].items():
                key = ("" if tag == "T band" else "general_") + tier
                if key != "f64":
                    entry.update({f"ms_{key}": ms_, f"plain_ms_{key}": plain_,
                                  f"bound_ms_{key}": b_})
        elif name == "sliced_wide_mm":
            # the rotation shape, then ortho_cd's Cholesky step
            (ms, plain, b_ms, b_by, library), (ms_c, plain_c, b_c, _, lib_c) = (
                stats[name]["rotation"], stats[name]["cholesky"])
            entry.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=library, ms_cholesky=ms_c,
                         plain_ms_cholesky=plain_c, bound_ms_cholesky=b_c,
                         library_ms_cholesky=lib_c)
        else:
            ms, plain, b_ms, b_by, library = stats[name]
            entry.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=library)
        kernels.append(entry)
    log(json.dumps({"kernels": kernels}))
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"the ladders never launched {missing}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
