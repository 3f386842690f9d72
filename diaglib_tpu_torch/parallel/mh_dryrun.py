"""Multi-process dry run and worker fleet over ``torch.distributed`` (port
of ``diaglib_tpu/parallel/mh_dryrun.py``).

:func:`launch` spawns one worker process per rank: by default NCCL, each
rank on its own card (NCCL takes one card a rank); the ranks run on the
CPU under gloo only when the caller asks (``backend="gloo",
device="cpu"``), as the tests do.
Every worker builds the same problems from seeds and runs the sharded
Davidson on

* a dense operator (each rank holds its rows; the matvec all-gathers x),
* the distributed BSR operator (``ops/dist_bsr.py``, ring permutes
  between processes),
* the distributed sliced operator (``ops/dist_sliced.py``, kernel K6's
  path; its matvec is also checked against a dense product),

and checks the eigenvalues against a dense float64 oracle, as the
reference's dry run does.  It prints ``MH_DRYRUN_OK`` on success.

:func:`run_fleet` is the general form: it runs named jobs of :data:`JOBS`
on every rank with inputs pickled from the caller (numpy arrays and plain
values) and returns each rank's outputs: the sharded operators and
solvers, a sharded checkpoint save, load and resume, the collective
inventory of a sharded Davidson iteration, the flagship's sharded ladders
(job ``ladders``), and the process-spanning names of ``multihost`` (job
``mesh``).  :func:`job_inputs` makes one set of inputs a
job, so that the same job runs under gloo on CPU ranks and under NCCL on
the cards and the two can be held together.  The workers import only this
package, never JAX.  One worker by hand::

    python -m diaglib_tpu_torch.parallel.mh_dryrun --rank 0 \\
        --world-size 2 --init-method tcp://127.0.0.1:PORT --jobs dryrun \\
        [--backend gloo --device cpu]
"""

from __future__ import annotations

import argparse
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
# seconds a fleet on the cards may take by default: four ranks reaching
# their cards, NCCL's setup and the flagship's stores and ladders
NCCL_TIMEOUT = 900.0
_FAIL_GRACE = 10.0    # seconds the other ranks get once one has failed


def _solve_opts(**kw):
    from ..types import SolverOptions
    return SolverOptions(**kw)


def _job_dryrun(dev, inp):
    """The reference's dry run: dense, distributed BSR and distributed
    sliced Davidson solves, each checked against a dense oracle (the BSR
    operator at B = 64, where the reference takes 8)."""
    import torch
    import torch.distributed as dist

    from ..ops.bsr import bsr_diagonal, bsr_to_dense, random_bsr_spd
    from ..ops.bsr_sliced import slice_bsr
    from ..ops.dist_bsr import dist_bsr_matvec, distribute_bsr
    from ..ops.dist_sliced import dist_sliced_matvec, distribute_sliced_bsr
    from ..problems import diag_precnd, symm_matrix
    from ..solvers import davidson
    from .sharding import VectorSharding

    D, r = dist.get_world_size(), dist.get_rank()
    n_want, n_eig = 2, 4
    opts = _solve_opts(n_targ=n_want, n_max=n_eig, max_iter=60, tol=1e-7)

    def solve(mv, diag, sh):
        guess = torch.zeros((n_eig, sh.n_local), dtype=torch.float64,
                            device=dev)
        res = davidson(mv, diag_precnd(sh.local_cols(diag)), guess, opts,
                       generator=torch.Generator(device=dev).manual_seed(1),
                       sharding=sh)
        return res

    # ---- dense operator: each rank holds its rows, x is all-gathered ----
    n = 32 * D
    sh = VectorSharding(n)
    a = symm_matrix(n, device=dev)
    a_loc = sh.local_cols(a.T).T
    res = solve(lambda x: sh.all_gather(x) @ a_loc.T, torch.diagonal(a), sh)
    w = np.linalg.eigvalsh(a.cpu().numpy())
    err_dense = float(np.max(np.abs(res.eig[:n_want].cpu().numpy()
                                    - w[:n_want])))
    assert res.ok, "multi-process dense Davidson did not converge"
    assert err_dense < 1e-6, f"multi-process dense eig err {err_dense}"

    # ---- distributed BSR: the ring permutes cross processes ----
    # B = 64, the narrowest block K6 takes on the card (the reference's 8
    # runs its sliced matvec in interpret mode); 4 block rows a rank
    B = 64
    nb = 4 * B * D
    m = random_bsr_spd(nb, B, 2, seed=7, dtype=torch.float64, n_low_modes=8,
                       device=dev)
    sh = VectorSharding(nb)
    dense = bsr_to_dense(m).cpu().numpy()
    wb = np.linalg.eigvalsh(dense)
    res = solve(dist_bsr_matvec(distribute_bsr(m, D, rank=r), sh),
                bsr_diagonal(m), sh)
    err_bsr = float(np.max(np.abs(res.eig[:n_want].cpu().numpy()
                                  - wb[:n_want])))
    assert res.ok, "multi-process BSR Davidson did not converge"
    assert err_bsr < 1e-6, f"multi-process BSR eig err {err_bsr}"

    # ---- distributed sliced operator: K6's path ----
    dms = distribute_sliced_bsr(slice_bsr(m), D, rank=r)
    mv = dist_sliced_matvec(dms, sh)
    x = np.random.default_rng(3).standard_normal((4, nb))
    y = sh.all_gather(mv(sh.local_cols(torch.as_tensor(x, device=dev))))
    oracle = x @ dense.T
    err_mv = float(np.max(np.abs(y.cpu().numpy() - oracle))
                   / np.max(np.abs(oracle)))
    assert err_mv < 1e-13, f"multi-process sliced matvec err {err_mv}"
    res = solve(mv, bsr_diagonal(m), sh)
    err_sliced = float(np.max(np.abs(res.eig[:n_want].cpu().numpy()
                                     - wb[:n_want])))
    assert res.ok, "multi-process sliced Davidson did not converge"
    assert err_sliced < 1e-6, f"multi-process sliced eig err {err_sliced}"
    print(f"MH_DRYRUN_OK rank {r}/{D} dense_err={err_dense:.2e} "
          f"bsr_err={err_bsr:.2e} sliced_mv_err={err_mv:.2e} "
          f"sliced_err={err_sliced:.2e}", flush=True)
    return {"dense_err": err_dense, "bsr_err": err_bsr, "mv_err": err_mv,
            "sliced_err": err_sliced}


def _gathered(sh, t):
    """Every rank's copy of the replicated tensor ``t``, stacked."""
    import torch
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(sh.size)]
    dist.all_gather(parts, t.contiguous(), group=sh.group)
    return torch.stack(parts).cpu().numpy()


def _result(prefix, res, sh):
    """A solver result as numpy: the eigenvalues, the rank's vectors, the
    counts, and the eigenvalue history of every rank (for the bit-identity
    check across ranks)."""
    hist = res.eig_history
    return {f"{prefix}_eig": res.eig.cpu().numpy(),
            f"{prefix}_evec": res.evec.cpu().numpy(),
            f"{prefix}_ok": bool(res.ok), f"{prefix}_iter": int(res.n_iter),
            f"{prefix}_matvec": int(res.n_matvec),
            f"{prefix}_rms0": res.rms_history[0].cpu().numpy(),
            f"{prefix}_eig_ranks": _gathered(sh, hist)}


def _job_dist_sliced(dev, inp):
    """Matvecs and sharded solves on a distributed sliced store carried as
    arrays (``inp["store"]``: the fields of a ``DistSlicedBSR``): both
    tiers of the matvec on ``x_f64``/``x_f32``, then ``davidson`` and
    ``davidson_ladder`` from ``guess`` under ``options`` (a dict of
    SolverOptions fields; the ladder takes ``lo_tol``/``lo_iter``).  First,
    the integer stages of every group on the shard received from the ring
    (:func:`_received_levels` of ``x_f64``, arrays kept)."""
    import torch

    from ..ops.dist_sliced import dist_sliced_from_arrays, dist_sliced_matvec
    from ..problems import diag_precnd
    from ..solvers import davidson, davidson_ladder
    from .sharding import VectorSharding

    store = inp["store"]
    sh = VectorSharding(int(store["n"]))
    dm = dist_sliced_from_arrays(store, sh.rank, dev)
    out = _received_levels(dm, sh, sh.local_cols(
        torch.as_tensor(inp["x_f64"], device=dev)), keep=True)
    for tag, dt in (("f64", torch.float64), ("f32", torch.float32)):
        x = sh.local_cols(torch.as_tensor(inp[f"x_{tag}"], device=dev))
        out[f"y_{tag}"] = dist_sliced_matvec(dm, sh, dtype=dt)(x).cpu() \
            .numpy()
    opts = _solve_opts(**inp["options"])
    guess = sh.local_cols(torch.as_tensor(inp["guess"], device=dev))
    f32 = torch.float32
    pc = diag_precnd(dm.diagonal)
    out.update(_result("david", davidson(
        dist_sliced_matvec(dm, sh), pc, guess, opts, sharding=sh), sh))
    out.update(_result("ladder", davidson_ladder(
        dist_sliced_matvec(dm, sh, dtype=f32),
        diag_precnd(dm.diagonal.to(f32)), dist_sliced_matvec(dm, sh), pc,
        guess, opts, lo_tol=inp["lo_tol"], lo_iter=inp["lo_iter"],
        sharding=sh), sh))
    return out


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counted(dev, fn):
    """``(fn(), seconds, launches)``: every launch count set to 0 just
    before the call and read just after it (a device barrier on both
    sides)."""
    from ..utils.graphs import kernel_counters

    counters = kernel_counters()
    _sync(dev)
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return (out, time.perf_counter() - t0,
            {k: f.launches for k, f in counters.items()})


def _received_levels(dm, sh, x, keep=False):
    """Kernel K6 on every group of this rank, at both tiers, on the x shard
    each group receives through the ring (``sh.permute`` of this rank's
    shard ``x``, as the matvec fetches it) and slices with K2: the launch
    against ``group_spmm_plain`` on the same planes, bit for bit.  Returns
    whether they were equal, the largest difference and a digest of the
    planes, row scales and levels a tier; with ``keep`` the arrays too (one
    list a tier, one entry a group)."""
    import hashlib

    import torch

    from ..ops import bsr_sliced as bs
    from ..ops.dist_bsr import _check_group
    from ..ops.dist_sliced import group_spmm, group_spmm_plain

    sd = _check_group(dm, sh)
    out = {}
    for tier, dt in (("f64", torch.float64), ("f32", torch.float32)):
        nx, na, nlev = bs._tier_params(sd.na, dt, None, None)
        acc = None if dt == torch.float64 else torch.float32
        digest = hashlib.sha1()
        equal, err, kept = True, 0, []
        for i, s in enumerate(sd.steps):
            xs, sx = bs._slice_x(sh.permute(x.to(dt), s), nx, acc_dtype=acc)
            args = (xs, sd.slices[i], sd.loc_rows[i], sd.loc_cols[i])
            kw = dict(nx=nx, na=na, nlev=nlev, nbr_loc=sd.nbr_loc)
            got = group_spmm(*args, **kw)
            want = group_spmm_plain(*args, **kw)
            equal = equal and torch.equal(got, want)
            err = max(err, int((got.long() - want.long()).abs().max()))
            host = [t.cpu().numpy() for t in (xs, sx, got)]
            for a in host:
                digest.update(a.tobytes())
            kept.append(host)
        out.update({f"k6_{tier}_equal": equal, f"k6_{tier}_max_err": err,
                    f"k6_{tier}_digest": digest.hexdigest()})
        if keep:
            out[f"k6_{tier}"] = kept
    return out


def _record_permutes(sh, calls):
    """Record every ring permute ``sh`` posts into ``calls``: (offset,
    the rank sent to, the rank received from, shape, dtype).  ``del
    sh.permute`` ends the recording."""
    real = sh.permute

    def permute(x, s, wait=True):
        s_ = s % sh.size
        if s_:
            calls.append((s_, sh._global((sh.rank - s_) % sh.size),
                          sh._global((sh.rank + s_) % sh.size),
                          tuple(x.shape), str(x.dtype)))
        return real(x, s, wait)

    sh.permute = permute


def _residuals(bsr_mv, sh, evec, eig):
    """Per root, the rms and the largest entry of ``A x - lambda x`` over
    the whole vector, A applied by the distributed float64 BSR product
    ``bsr_mv`` to this rank's shard ``evec`` (n_targ, n_local)."""
    import torch

    r = bsr_mv(evec) - eig[:, None] * evec
    rms = torch.sqrt(sh.sum((r * r).sum(dim=1)) / sh.n)
    return rms.cpu().numpy(), sh.max(r.abs().amax(dim=1)).cpu().numpy()


def _build_operator(dev, inp, rank, size, keep_whole):
    """This rank's distributed float64-product BSR operator and sliced
    store for :func:`_job_ladders`, the whole general store when
    ``keep_whole`` (else None), and a digest of the matrix's diagonal when
    this rank built the matrix (else None)."""
    import hashlib

    import torch

    from ..ops.bsr import bsr_diagonal, bsr_from_arrays, random_bsr_spd
    from ..ops.bsr_sliced import slice_bsr, sliced_store_from_arrays
    from ..ops.dist_bsr import distribute_bsr
    from ..ops.dist_sliced import (
        dist_sliced_from_arrays,
        distribute_sliced_bsr,
    )

    if "build" in inp:
        b = inp["build"]
        m = random_bsr_spd(b["n"], b["block"], b["bpr"], seed=b["seed"],
                           dtype=torch.float32, device=dev)
        digest = hashlib.sha1(
            bsr_diagonal(m).cpu().numpy().tobytes()).hexdigest()
        dmb = distribute_bsr(m, size, rank=rank)
        whole = slice_bsr(m)
        del m
        dm = distribute_sliced_bsr(whole, size, rank=rank)
    else:
        digest = None
        c = inp["carried"]
        dmb = distribute_bsr(bsr_from_arrays(c["bsr"], device=dev), size,
                             rank=rank)
        whole = (sliced_store_from_arrays(c["general"], device=dev)
                 if keep_whole else None)
        dm = dist_sliced_from_arrays(c["store"], rank, dev)
    return dmb, dm, (whole if keep_whole else None), digest


def _profile_iteration(dev, run):
    """``run()`` (a sharded solve of three or more iterations) under
    torch.profiler, its second iteration marked (``profiling.flag_window``:
    from the second flag read to the third, the steps of a captured solve
    replayed): that iteration's collectives by kind with their count,
    bytes and the device ms of their NCCL kernels, the device-busy ms (the
    union of every kernel, copy and fill that starts in the window), its
    device kernels, and the window's host ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..profiling import flag_window

    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with flag_window(2, prof) as win:
            run()
        _sync(dev)
    if not win["closed"]:
        raise RuntimeError("the profiled solve ran fewer than 2 iterations")
    events = prof.events()
    mark = next(e for e in events if e.name == "flag-window"
                and e.device_type == DeviceType.CPU)
    w_lo, w_hi = mark.time_range.start, mark.time_range.end
    kinds = {"AllReduce": "all-reduce", "AllGather": "all-gather",
             "SendRecv": "collective-permute", "Send": "collective-permute",
             "Recv": "collective-permute"}
    spans, nccl, n_kernels = [], {}, 0
    for e in events:
        # the device timeline also holds each record_function scope and
        # each collective's "nccl:..." annotation as a range: not work
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        lo, hi = e.time_range.start, e.time_range.end
        if not w_lo <= lo < w_hi:
            continue
        n_kernels += 1
        spans.append((lo, min(hi, w_hi)))
        if "nccl" in e.name.lower():
            kind = next((v for k, v in kinds.items() if k in e.name),
                        "other")
            rec = nccl.setdefault(kind, {"kernels": 0, "device_ms": 0.0})
            rec["kernels"] += 1
            rec["device_ms"] += (hi - lo) / 1e3
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return {"inventory": win["inventory"], "nccl": nccl,
            "device_kernels": n_kernels, "busy_ms": busy / 1e3,
            "window_ms": (w_hi - w_lo) / 1e3, "host_ms": win["host_ms"]}


def _job_ladders(dev, inp):
    """The flagship's sharded ladders over the distributed sliced operator
    (K2 and K6 under every matvec, K3 in the rotations).

    The operator is built on every rank from ``build`` (``n``, ``block``,
    ``bpr``, ``seed`` of ``random_bsr_spd``, float32 blocks, sliced by
    ``slice_bsr``; each rank keeps its rows) or carried from ``carried``
    (``bsr`` the blocks, ``store`` the distributed store's fields,
    ``general`` the whole store).  On it: the ring permutes of one matvec a
    tier and of one float64 BSR product, recorded; K6 against its plain
    version on the received planes (:func:`_received_levels`); then each
    ladder of ``ladders`` ("davidson", "lobpcg") under ``options`` with
    ``lo_tol`` and ``lo_iter[name]``, from ``guess`` (numpy (n_max, n)) or
    a zero guess filled from a generator seeded with 1, run once to warm
    up (unless ``warm`` is false) and once with the launch counts at 0, on
    the default route (captured under NCCL on the cards; its routes and
    the digest of its flag history are returned).  With ``compare`` (on
    the cards), each ladder once more captured against uncaptured
    (``profiling.compare_routes``, 5 warm walls of each).
    The returned pairs' residuals come from the float64 product of the
    original blocks, distributed (``dist_bsr_matvec``).  With
    ``unsharded``, rank 0 also runs each ladder over ``sliced_bsr_matvec``
    (K5) on the whole store, and its pairs' residuals are taken the same
    way.  With ``profile``, one warm float64 sharded Davidson iteration on
    each route, captured and eager, is profiled on rank 0
    (:func:`_profile_iteration`).  Each card's peak memory is read after
    the build and after the ladders."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from ..ops.bsr_sliced import sliced_bsr_matvec
    from ..ops.dist_bsr import dist_bsr_matvec
    from ..ops.dist_sliced import dist_sliced_matvec
    from .. import profiling
    from ..problems import diag_precnd
    from ..solvers import davidson, davidson_ladder, lobpcg_ladder
    from ..utils import graphs
    from ..utils.mm import mm_sharding, mmT
    from .sharding import VectorSharding

    cuda = dev.type == "cuda"
    D, r = dist.get_world_size(), dist.get_rank()
    unsharded = bool(inp.get("unsharded"))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    dmb, dm, whole, digest = _build_operator(dev, inp, r, D,
                                             unsharded and r == 0)
    _sync(dev)
    out = {"build_s": time.perf_counter() - t0, "n": dm.n,
           "build_digest": digest,
           "steps": list(dm.steps),
           "entries": [int(lr.shape[-1]) for lr in dm.loc_rows],
           "store_bytes": sum(t.numel() for t in dm.slices)}
    if cuda:
        out["device_name"] = torch.cuda.get_device_name(dev)
        out["peak_build_bytes"] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    sh = VectorSharding(dm.n)
    f32, f64 = torch.float32, torch.float64
    mv_lo = dist_sliced_matvec(dm, sh, dtype=f32)
    mv_hi = dist_sliced_matvec(dm, sh)
    pc_lo = diag_precnd(dm.diagonal.to(f32))
    pc_hi = diag_precnd(dm.diagonal)
    bsr_mv = dist_bsr_matvec(dmb, sh)

    x = sh.local_cols(torch.randn(
        (15, dm.n), generator=torch.Generator(device=dev).manual_seed(8),
        dtype=f64, device=dev))
    calls = []
    _record_permutes(sh, calls)
    mv_hi(x)
    mv_lo(x.to(f32))
    bsr_mv(x)
    del sh.permute
    out["permutes"] = calls
    out.update(_received_levels(dm, sh, x))
    del x

    opts = _solve_opts(**inp["options"])
    n_targ = opts.n_targ
    full = (torch.as_tensor(inp["guess"], device=dev) if "guess" in inp
            else torch.zeros((opts.n_max, dm.n), dtype=f64, device=dev))
    guess = sh.local_cols(full).contiguous()
    ladders = {"davidson": davidson_ladder, "lobpcg": lobpcg_ladder}

    def pairs(tag, res, wall, launches, evec, eig):
        rms, rmax = _residuals(bsr_mv, sh, evec, eig)
        out.update({f"{tag}_eig": res.eig.cpu().numpy(),
                    f"{tag}_ok": bool(res.ok),
                    f"{tag}_ortho_ok": bool(res.ortho_ok),
                    f"{tag}_iter": int(res.n_iter),
                    f"{tag}_matvec": int(res.n_matvec),
                    f"{tag}_f64_iter": int(torch.isfinite(
                        res.rms_history[:, 0]).sum()),
                    f"{tag}_wall": wall, f"{tag}_launches": launches,
                    f"{tag}_res_rms": rms, f"{tag}_res_max": rmax})

    for name in inp["ladders"]:
        lad, lo_iter = ladders[name], inp["lo_iter"][name]

        def run(lo, plo, hi, phi, g, sharding):
            return lad(lo, plo, hi, phi, g, opts, lo_tol=inp["lo_tol"],
                       lo_iter=lo_iter, sharding=sharding,
                       generator=torch.Generator(device=dev).manual_seed(1))

        args = (mv_lo, pc_lo, mv_hi, pc_hi, guess, sh)
        if inp.get("warm", True):
            _counted(dev, lambda: run(*args))
        with graphs._recording() as rec:
            res, wall, launches = _counted(dev, lambda: run(*args))
        pairs(name, res, wall, launches, res.evec[:n_targ].contiguous(),
              res.eig[:n_targ])
        out[f"{name}_routes"] = sorted({s["route"] for s in rec.solves})
        out[f"{name}_digest"] = profiling.flag_digest(rec.solves)
        out[f"{name}_eig_ranks"] = _gathered(sh, res.eig_history)
        with mm_sharding(sh):
            out[f"{name}_gram_ranks"] = _gathered(
                sh, mmT(res.evec, res.evec))
        if inp.get("compare") and cuda:
            cmp = profiling.compare_routes(
                lambda gen: lad(*args[:5], opts, lo_tol=inp["lo_tol"],
                                lo_iter=lo_iter, sharding=sh, generator=gen),
                dev)
            out[f"{name}_compare"] = cmp
        if not unsharded:
            continue
        # rank 0's unsharded ladder over K5; the others wait in the
        # broadcast of its pairs, whose residuals every rank then takes
        vec = torch.empty((n_targ, dm.n), dtype=f64, device=dev)
        lam = torch.empty((n_targ,), dtype=f64, device=dev)
        if r == 0:
            uargs = (sliced_bsr_matvec(whole, dtype=f32),
                     diag_precnd(whole.diagonal.to(f32)),
                     sliced_bsr_matvec(whole),
                     diag_precnd(whole.diagonal), full, None)
            if inp.get("warm", True):
                _counted(dev, lambda: run(*uargs))
            res_u, wall_u, launches_u = _counted(dev, lambda: run(*uargs))
            vec.copy_(res_u.evec[:n_targ])
            lam.copy_(res_u.eig[:n_targ])
        dist.broadcast(vec, 0)
        dist.broadcast(lam, 0)
        vec = sh.local_cols(vec).contiguous()
        if r == 0:
            pairs(f"{name}_k5", res_u, wall_u, launches_u, vec, lam)
        else:
            _residuals(bsr_mv, sh, vec, lam)
    if cuda:
        out["peak_ladder_bytes"] = torch.cuda.max_memory_allocated(dev)
    if inp.get("profile"):
        o3 = dataclasses.replace(opts, max_iter=3)

        def three():
            return davidson(mv_hi, pc_hi, guess, o3, sharding=sh,
                            generator=torch.Generator(
                                device=dev).manual_seed(1))

        # one warm iteration on each route: the third of a solve whose
        # steps were captured in its first two (a replay of each)
        out["profile"] = {}
        for route in ("graphs", "eager"):
            with graphs._recording(None if route == "graphs" else route):
                three()
                if r == 0:
                    out["profile"][route] = _profile_iteration(dev, three)
                else:
                    three()
    return out


def check_permute_order(outputs) -> None:
    """Raise ``AssertionError`` unless the ring permutes the ranks of a
    fleet recorded (``"permutes"`` of :func:`_job_ladders`' outputs, rank
    by rank) would match under NCCL, which ignores tags: every rank posts
    the same offsets in the same order, and for every ordered pair of ranks
    the sends of the one match the receives of the other, one for one, in
    order, with the same shapes and types."""
    calls = [out["permutes"] for out in outputs]
    if not calls[0]:
        raise AssertionError("no ring permute was posted")
    offsets = [[c[0] for c in rank] for rank in calls]
    if any(o != offsets[0] for o in offsets):
        raise AssertionError(f"the ranks post their offsets in other "
                             f"orders: {offsets}")
    for a in range(len(calls)):
        for b in range(len(calls)):
            sent = [c[3:] for c in calls[a] if c[1] == b]
            got = [c[3:] for c in calls[b] if c[2] == a]
            if sent != got:
                raise AssertionError(f"rank {a} sends {sent} to rank {b}, "
                                     f"which receives {got} from it")


def _paired_local(sh, full):
    """A rank's ``[Y_local | Z_local]`` block of (k, 2n) paired rows."""
    import torch

    return torch.cat([sh.local_cols(full[:, :sh.n]),
                      sh.local_cols(full[:, sh.n:])], dim=1)


def _job_sharded_solvers(dev, inp):
    """``davidson``, ``gen_david`` and ``lobpcg`` on the dense pair
    (``a``, ``s``) with each rank holding its rows, and ``dist_bsr_matvec``
    on the BSR arrays ``bsr`` (applied to ``x``, and under ``davidson``
    from ``bsr_guess``), sharded over the world;
    plus, under ``mm_sharding``, a Gram product gathered from every rank,
    the QR fallback of ``guess`` and the random guess of ``check_guess``;
    plus ``caslr`` (algorithm 0) and ``caslr_eff`` on the Casida blocks
    ``casida`` (a dict of numpy arrays: apb, amb, spd, smd and the
    preconditioner's diagonals aa, sigma) with each rank holding its rows,
    from the paired guess ``casida_guess`` (each rank passes its
    ``[Y_local | Z_local]``), and ``caslr`` once more from
    ``casida_zero_guess``, whose zero rows are filled from a generator
    seeded with 5; plus ``nonsym`` side "c" on the nonsymmetric matrix
    ``nonsym`` (each rank holding its rows of it and of its transpose)
    from ``nonsym_guess`` under ``nonsym_options``, with the host and the
    device drivers.
    """
    import torch

    from ..ops.bsr import bsr_diagonal, bsr_from_arrays
    from ..ops.dist_bsr import dist_bsr_matvec, distribute_bsr
    from ..problems import diag_precnd
    from ..ortho.core import ortho_qr
    from ..solvers import davidson, gen_david, lobpcg
    from ..utils.guess import check_guess
    from ..utils.mm import mm_sharding, mmT
    from .sharding import VectorSharding

    a = torch.as_tensor(inp["a"], device=dev)
    s = torch.as_tensor(inp["s"], device=dev)
    sh = VectorSharding(a.shape[0])
    a_loc = sh.local_cols(a.T).T
    s_loc = sh.local_cols(s.T).T

    def mv(x):
        return sh.all_gather(x) @ a_loc.T

    def bv(x):
        return sh.all_gather(x) @ s_loc.T

    pc = diag_precnd(sh.local_cols(torch.diagonal(a)))
    guess = sh.local_cols(torch.as_tensor(inp["guess"], device=dev))
    opts = _solve_opts(**inp["options"])
    out = {}
    out.update(_result("davidson", davidson(mv, pc, guess, opts,
                                            sharding=sh), sh))
    out.update(_result("gen_david", gen_david(mv, pc, bv, guess, opts,
                                              sharding=sh), sh))
    out.update(_result("lobpcg", lobpcg(mv, pc, guess, opts, sharding=sh),
                       sh))
    with mm_sharding(sh):
        gram = mmT(guess, mv(guess))
        out["qr"] = ortho_qr(guess).cpu().numpy()
        out["random_guess"] = check_guess(
            torch.zeros_like(guess),
            torch.Generator(device=dev).manual_seed(5)).cpu().numpy()
    out["gram_ranks"] = _gathered(sh, gram)
    m = bsr_from_arrays(inp["bsr"], device=dev)
    shb = VectorSharding(m.n)
    dm = distribute_bsr(m, shb.size, rank=shb.rank)
    x = shb.local_cols(torch.as_tensor(inp["x"], device=dev))
    out["bsr_y"] = dist_bsr_matvec(dm, shb)(x).cpu().numpy()
    out["bsr_steps"] = dm.steps
    out.update(_result("bsr_davidson", davidson(
        dist_bsr_matvec(dm, shb),
        diag_precnd(shb.local_cols(bsr_diagonal(m))),
        shb.local_cols(torch.as_tensor(inp["bsr_guess"], device=dev)), opts,
        sharding=shb), shb))
    out.update(_casida_solves(dev, inp, opts))
    out.update(_nonsym_solves(dev, inp))
    return out


# the sharded solves of job ``routes`` (on job sharded_solvers' inputs)
ROUTE_SOLVES = ("davidson", "gen_david", "lobpcg", "caslr0", "caslr1",
                "caslr_eff", "nonsym", "bsr_davidson", "davidson_ladder")
# the float32 target of the routes job's davidson_ladder: below the
# float32 noise floor of its matrix (~2e-6 rms), so that its float32 stage
# ends by its stall bit
ROUTE_LO_TOL = 1e-7


def _route_runs(dev, inp):
    """Each solve of :data:`ROUTE_SOLVES` as a call without arguments,
    sharded over the world on ``inp`` (:func:`job_inputs` of
    "sharded_solvers"): the dense operators with each rank holding its
    rows (the matvec all-gathers x), the Casida blocks likewise, nonsym
    side "c" with the host driver, davidson over ``dist_bsr_matvec``
    (ring permutes in the matvec step), and davidson_ladder on the dense
    operator and a float32 copy, its float32 stage ended by a stall
    (:data:`ROUTE_LO_TOL`)."""
    import torch

    from ..ops.bsr import bsr_diagonal, bsr_from_arrays
    from ..ops.dist_bsr import dist_bsr_matvec, distribute_bsr
    from ..problems import diag_precnd, lrprec_eff, lrprec_std
    from ..solvers import caslr, caslr_eff, davidson, davidson_ladder
    from ..solvers import gen_david, lobpcg, nonsym
    from .sharding import VectorSharding

    sh, a, mv = _dense_rows(dev, inp["a"])
    _, _, bv = _dense_rows(dev, inp["s"])
    _, _, mv32 = _dense_rows(dev, inp["a"].astype(np.float32))
    pc = diag_precnd(sh.local_cols(torch.diagonal(a)))
    pc32 = diag_precnd(sh.local_cols(torch.diagonal(a)).float())
    guess = sh.local_cols(torch.as_tensor(inp["guess"], device=dev))
    opts = _solve_opts(**inp["options"])

    blk = {k: torch.as_tensor(v, device=dev)
           for k, v in inp["casida"].items()}
    ops = {f"{k}mul": _dense_rows(dev, blk[k].cpu().numpy())[2]
           for k in ("apb", "amb", "spd", "smd")}
    aa, sg = sh.local_cols(blk["aa"]), sh.local_cols(blk["sigma"])
    cguess = _paired_local(sh, torch.as_tensor(inp["casida_guess"],
                                               device=dev))

    shn, ns, ns_mv = _dense_rows(dev, inp["nonsym"])
    _, _, ns_mvt = _dense_rows(dev, inp["nonsym"].T.copy())
    ns_pc = diag_precnd(shn.local_cols(torch.diagonal(ns)))
    ns_guess = shn.local_cols(torch.as_tensor(inp["nonsym_guess"],
                                              device=dev))
    ns_opts = _solve_opts(**inp["nonsym_options"])

    m = bsr_from_arrays(inp["bsr"], device=dev)
    shb = VectorSharding(m.n)
    bmv = dist_bsr_matvec(distribute_bsr(m, shb.size, rank=shb.rank), shb)
    bpc = diag_precnd(shb.local_cols(bsr_diagonal(m)))
    bguess = shb.local_cols(torch.as_tensor(inp["bsr_guess"], device=dev))

    def casida(run, prec, **kw):
        return lambda: run(lrprec=prec, evec_guess=cguess, options=opts,
                           sharding=sh, **kw, **ops)

    return sh, {
        "davidson": lambda: davidson(mv, pc, guess, opts, sharding=sh),
        "gen_david": lambda: gen_david(mv, pc, bv, guess, opts,
                                       sharding=sh),
        "lobpcg": lambda: lobpcg(mv, pc, guess, opts, sharding=sh),
        "caslr0": casida(caslr, lrprec_std(aa, sg), algorithm=0),
        "caslr1": casida(caslr, lrprec_std(aa, sg), algorithm=1),
        "caslr_eff": casida(caslr_eff, lrprec_eff(aa, sg)),
        "nonsym": lambda: nonsym(ns_mv, ns_mvt, ns_pc, ns_guess, ns_opts,
                                 side="c", sharding=shn, driver="host"),
        "bsr_davidson": lambda: davidson(bmv, bpc, bguess, opts,
                                         sharding=shb),
        "davidson_ladder": lambda: davidson_ladder(
            mv32, pc32, mv, pc, guess, opts, lo_tol=ROUTE_LO_TOL, lo_iter=35,
            sharding=sh),
    }


def _fields(res) -> dict:
    """Every field of a solver result, tensors as numpy arrays."""
    import dataclasses

    import torch

    return {f.name: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for f in dataclasses.fields(res)
            for v in (getattr(res, f.name),)}


def _job_routes(dev, inp):
    """Each sharded solve of :data:`ROUTE_SOLVES` on two routes of
    ``utils.graphs``: the captured route's logic first ("graphs", the
    steps captured and replayed, on an NCCL group of cards; "unrolled",
    the same fixed passes and reruns without capture, on a gloo group),
    then "eager"; then the solves of ``short`` once more on the first
    route with one-pass ortho budgets, which forces rare-branch reruns.
    Returns ``routes`` (the two route names) and, by
    ``"{route}:{solve}"`` (``"short:{solve}"`` for the forced reruns), a
    dict of every result field (numpy arrays), the solve records of its
    stages (``utils.graphs._recording``: flag history, reruns, replays)
    and the eigenvalue history of every rank (gathered); and the launch
    counts of each run; and what ``keep_alive`` kept of the ring permutes
    of offsets 0 to the world size, one each."""
    import torch
    import torch.distributed as dist

    from ..utils import graphs

    first = "graphs" if dist.get_backend() == "nccl" else "unrolled"
    sh, runs = _route_runs(dev, inp)
    names = inp.get("solves", ROUTE_SOLVES)
    out = {"routes": (first, "eager")}
    # the shards the ring permutes of offsets 0-4 keep alive
    kept = []
    x = sh.local_cols(torch.as_tensor(inp["guess"], device=dev))
    with sh.keep_alive(kept):
        for s in range(sh.size + 1):
            sh.permute(x, s)
    out["kept"] = [(tuple(t.shape), str(t.dtype)) for t in kept]
    out["kept_after"] = sh._kept
    plan = [(route, name, None) for route in (first, "eager")
            for name in names]
    plan += [("short", name, {"vs": 1, "cd": 1, "shift": 0})
             for name in inp.get("short", ())]
    for tag, name, budgets in plan:
        route = first if tag == "short" else tag
        with graphs._recording(route, budgets) as rec:
            res, wall, launches = _counted(dev, runs[name])
        rec_out = _fields(res)
        rec_out.update(solves=rec.solves, wall=wall, launches=launches,
                       eig_ranks=_gathered(sh, res.eig_history))
        out[f"{tag}:{name}"] = rec_out
    return out


def _nonsym_solves(dev, inp):
    import torch

    from ..problems import diag_precnd
    from ..solvers import nonsym
    from .sharding import VectorSharding

    a = torch.as_tensor(inp["nonsym"], device=dev)
    sh = VectorSharding(a.shape[0])
    a_loc, at_loc = sh.local_cols(a.T).T, sh.local_cols(a).T
    opts = _solve_opts(**inp["nonsym_options"])
    guess = sh.local_cols(torch.as_tensor(inp["nonsym_guess"], device=dev))
    out = {}
    for driver in ("host", "device"):
        res = nonsym(lambda x: sh.all_gather(x) @ a_loc.T,
                     lambda x: sh.all_gather(x) @ at_loc.T,
                     diag_precnd(sh.local_cols(torch.diagonal(a))), guess,
                     opts, side="c", sharding=sh, driver=driver)
        tag = f"nonsym_{driver}"
        out.update({f"{tag}_eig": res.eig.cpu().numpy(),
                    f"{tag}_evec_r": res.evec_r.cpu().numpy(),
                    f"{tag}_evec_l": res.evec_l.cpu().numpy(),
                    f"{tag}_ok": bool(res.ok), f"{tag}_iter": res.n_iter,
                    f"{tag}_matvec": res.n_matvec,
                    f"{tag}_eig_ranks": _gathered(sh, res.eig_history)})
    return out


def _casida_solves(dev, inp, opts):
    import torch

    from ..problems import lrprec_eff, lrprec_std
    from ..solvers import caslr, caslr_eff
    from .sharding import VectorSharding

    blk = {k: torch.as_tensor(v, device=dev)
           for k, v in inp["casida"].items()}
    sh = VectorSharding(blk["apb"].shape[0])

    def rows_op(name):
        loc = sh.local_cols(blk[name].T).T

        def mv(x):
            return sh.all_gather(x) @ loc.T

        return mv

    ops = {f"{k}mul": rows_op(k) for k in ("apb", "amb", "spd", "smd")}
    aa, sg = sh.local_cols(blk["aa"]), sh.local_cols(blk["sigma"])
    guess = _paired_local(sh, torch.as_tensor(inp["casida_guess"],
                                              device=dev))
    zero = _paired_local(sh, torch.as_tensor(inp["casida_zero_guess"],
                                             device=dev))
    out = {}
    out.update(_result("caslr", caslr(
        lrprec=lrprec_std(aa, sg), evec_guess=guess, options=opts,
        algorithm=0, sharding=sh, **ops), sh))
    out.update(_result("caslr_eff", caslr_eff(
        lrprec=lrprec_eff(aa, sg), evec_guess=guess, options=opts,
        sharding=sh, **ops), sh))
    out.update(_result("caslr_zero", caslr(
        lrprec=lrprec_std(aa, sg), evec_guess=zero, options=opts,
        algorithm=0, generator=torch.Generator(device=dev).manual_seed(5),
        sharding=sh, **ops), sh))
    return out


def _dense_rows(dev, a):
    """The sharding of the dense matrix ``a`` over the world, and its
    matvec with each rank holding its rows (x is all-gathered)."""
    import torch

    from .sharding import VectorSharding

    a = torch.as_tensor(a, device=dev)
    sh = VectorSharding(a.shape[0])
    a_loc = sh.local_cols(a.T).T
    return sh, a, lambda x: sh.all_gather(x) @ a_loc.T


def _job_checkpoint(dev, inp):
    """A sharded ``davidson`` on the dense matrix ``a`` from ``guess``,
    interrupted at ``partial_iter`` iterations and saved with
    ``checkpoint.save`` into ``dir`` (each rank its file), loaded back
    with ``like=`` the interrupted result (every field compared, bit for
    bit), then resumed from the loaded rows and, for comparison, solved
    from ``guess`` under the same ``options``."""
    import dataclasses

    import torch

    from .. import checkpoint
    from ..problems import diag_precnd
    from ..solvers import davidson

    sh, a, mv = _dense_rows(dev, inp["a"])
    pc = diag_precnd(sh.local_cols(torch.diagonal(a)))
    guess = sh.local_cols(torch.as_tensor(inp["guess"], device=dev))
    opts = _solve_opts(**inp["options"])
    part = davidson(mv, pc, guess, dataclasses.replace(
        opts, max_iter=inp["partial_iter"]), sharding=sh)
    checkpoint.save(inp["dir"], part)
    back = checkpoint.load(inp["dir"], like=part)
    same = all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(dataclasses.astuple(part),
                               dataclasses.astuple(back)))
    resumed = davidson(mv, pc, back.evec, opts, sharding=sh)
    scratch = davidson(mv, pc, guess, opts, sharding=sh)
    return {"part_ok": bool(part.ok), "part_evec": part.evec.cpu().numpy(),
            "loaded_equal": same, "resumed_ok": bool(resumed.ok),
            "resumed_iter": resumed.n_iter, "scratch_iter": scratch.n_iter,
            "resumed_eig": resumed.eig.cpu().numpy()}


def _job_inventory(dev, inp):
    """``profiling.collective_inventory`` of one iteration of a sharded
    ``davidson`` on the dense matrix ``a`` from ``guess`` under
    ``options``: on the eager route (``inventory``, the loops' own
    passes), and on the captured route's logic ("graphs" under NCCL on
    the cards, "unrolled" under gloo): one iteration (``captured``, each
    step's warm-up call counted, its capture not) and one warm iteration
    of a three-iteration solve (``warm``: from the second flag read to
    the third, ``profiling.flag_window``; a captured step's replay counts
    what its capture recorded)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from ..problems import diag_precnd
    from ..profiling import collective_inventory, flag_window
    from ..solvers import davidson
    from ..utils import graphs

    sh, a, mv = _dense_rows(dev, inp["a"])
    pc = diag_precnd(sh.local_cols(torch.diagonal(a)))
    guess = sh.local_cols(torch.as_tensor(inp["guess"], device=dev))
    opts = _solve_opts(**inp["options"])

    def solve(max_iter):
        return davidson(mv, pc, guess, dataclasses.replace(
            opts, max_iter=max_iter), sharding=sh)

    first = "graphs" if dist.get_backend() == "nccl" else "unrolled"
    out = {}
    with graphs._recording("eager"):
        out["inventory"] = collective_inventory(solve, 1)
    with graphs._recording(first):
        out["captured"] = collective_inventory(solve, 1)
        with flag_window(2) as w:
            solve(3)
    out["warm"] = w["inventory"]
    return out


def _job_mesh(dev, inp):
    """The process-spanning names of ``multihost`` on this rank: the mesh
    (and the refusal of an axis other than "n"), ``global_sharding`` of
    the length of ``x`` beside a ``VectorSharding`` of it, and ``x`` (held
    in full by every process) through ``make_replicated`` and
    ``make_global``."""
    import torch
    import torch.distributed as dist

    from .multihost import (
        global_mesh,
        global_sharding,
        make_global,
        make_replicated,
    )
    from .sharding import VectorSharding

    x = inp["x"]
    try:
        global_mesh("m")
        refused = False
    except ValueError:
        refused = True
    sh, ref = global_sharding(x.shape[1]), VectorSharding(x.shape[1])
    fields = ("group", "n", "size", "rank", "n_local", "lo")
    rep = make_replicated(x)
    part = make_global(x, sh)
    # every rank's copy, gathered: a full copy on each
    copies = [torch.empty_like(rep) for _ in range(dist.get_world_size())]
    dist.all_gather(copies, rep.contiguous())
    return {"mesh_is_world": global_mesh() is dist.group.WORLD,
            "other_axis_refused": refused,
            "sharding": {k: getattr(sh, k) for k in fields[1:]},
            "sharding_is_vector_sharding": type(sh) is VectorSharding and all(
                getattr(sh, k) == getattr(ref, k) for k in fields),
            "replicated": rep.cpu().numpy(), "replicated_device":
                str(rep.device),
            "copies_equal": all(torch.equal(c, rep) for c in copies),
            "shard": part.cpu().numpy()}


JOBS = {"dryrun": _job_dryrun, "dist_sliced": _job_dist_sliced,
        "sharded_solvers": _job_sharded_solvers,
        "checkpoint": _job_checkpoint, "inventory": _job_inventory,
        "ladders": _job_ladders, "mesh": _job_mesh, "routes": _job_routes}


def _store_arrays(dm) -> dict:
    """A stacked ``DistSlicedBSR``'s fields as numpy arrays and numbers,
    as :func:`~..ops.dist_sliced.dist_sliced_from_arrays` reads them."""
    out = {k: [a.cpu().numpy() for a in getattr(dm, k)]
           for k in ("slices", "loc_rows", "loc_cols")}
    out.update(col_scale=dm.col_scale.cpu().numpy(),
               diagonal=dm.diagonal.cpu().numpy(), steps=list(dm.steps),
               n=dm.n, block=dm.block, na=dm.na, ndev=dm.ndev)
    return out


def job_inputs(job: str, size: int = 4, workdir: str | None = None) -> dict:
    """The inputs of the ``JOBS`` entry ``job`` for a fleet of ``size``
    ranks, at the sizes of its CPU test (``tests/test_torch_
    {sharding,dist_sliced,checkpoint,profiling,multihost}.py``), made on the
    CPU from seeds: numpy's generator, and this package's problem
    generators (CPU ``torch.Generator`` streams where one draws), so that
    one dict runs the same job under gloo on CPU ranks and under NCCL on
    the cards.
    ``workdir`` is where the checkpoint job writes (required for it)."""
    import torch

    from ..ops.bsr import as_arrays, random_bsr_spd
    from ..ops.bsr_sliced import slice_bsr
    from ..ops.dist_sliced import distribute_sliced_bsr
    from ..problems import casida_blocks, nonsym_matrix, symm_matrix
    from ..utils.guess import guess_evec

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    if job == "dryrun":
        return {}
    if job == "dist_sliced":
        # B = 64, the narrowest block K6 takes on the card (the CPU test's
        # store has B = 32)
        n = 512
        ms = slice_bsr(random_bsr_spd(n, 64, 4, seed=11, dtype=torch.float64,
                                      device="cpu"))
        rng = np.random.default_rng(2)
        return dict(store=_store_arrays(distribute_sliced_bsr(ms, size)),
                    x_f64=rng.standard_normal((5, n)),
                    x_f32=rng.standard_normal((4, n)).astype(np.float32),
                    guess=rng.uniform(-0.5, 0.5, (8, n)),
                    options=dict(n_targ=4, n_max=8, max_iter=100, tol=1e-9,
                                 max_dav=10, wide_mm="never",
                                 sliced_mm="never"),
                    lo_tol=1e-4, lo_iter=35)
    if job == "routes":
        return dict(job_inputs("sharded_solvers", size),
                    short=("davidson", "bsr_davidson", "nonsym"))
    if job == "sharded_solvers":
        n = 256
        rng = np.random.default_rng(3)
        mm = rng.uniform(size=(n, n))
        blk = casida_blocks(n, gen(17), device="cpu")
        casida = {k: blk[k].numpy() for k in ("apb", "amb", "spd", "smd")}
        casida.update(aa=np.diagonal(blk["aa"].numpy()).copy(),
                      sigma=np.diagonal(blk["sigma"].numpy()).copy())
        casida_guess = rng.uniform(-0.5, 0.5, (8, 2 * n))
        zero = casida_guess.copy()
        zero[4:] = 0.0
        ns = nonsym_matrix(n, gen(1), variant=4, device="cpu")
        nonsym_opts = dict(n_targ=5, n_max=5, max_iter=200, tol=1e-8,
                           max_dav=10)
        ns_guess = guess_evec(6, gen(7), n, nonsym_opts["n_max"],
                              diagonal=torch.diagonal(ns), device="cpu")
        m = random_bsr_spd(2 * n, 32, 4, seed=11, dtype=torch.float64,
                           device="cpu")
        return dict(a=symm_matrix(n, device="cpu").numpy(), s=mm.T @ mm,
                    guess=rng.uniform(-0.5, 0.5, (8, n)),
                    options=dict(n_targ=4, n_max=8, max_iter=200, tol=1e-8,
                                 max_dav=10),
                    bsr=as_arrays(m), x=rng.standard_normal((5, 2 * n)),
                    bsr_guess=rng.uniform(-0.5, 0.5, (8, 2 * n)),
                    casida=casida, casida_guess=casida_guess,
                    casida_zero_guess=zero, nonsym=ns.numpy(),
                    nonsym_guess=ns_guess.numpy(),
                    nonsym_options=nonsym_opts)
    if job == "checkpoint":
        if workdir is None:
            raise ValueError("job_inputs('checkpoint') needs a workdir")
        return {"a": symm_matrix(64, device="cpu").numpy(),
                "guess": np.random.default_rng(3).uniform(-0.5, 0.5,
                                                          (6, 64)),
                "partial_iter": 4, "dir": str(Path(workdir) / "sharded"),
                "options": dict(n_targ=3, n_max=6, max_iter=100, tol=1e-10)}
    if job == "inventory":
        return {"a": symm_matrix(64, device="cpu").numpy(),
                "guess": np.random.default_rng(4).uniform(-0.5, 0.5,
                                                          (6, 64)),
                "options": dict(n_targ=3, n_max=6, max_iter=10, tol=1e-8)}
    if job == "mesh":
        return {"x": np.random.default_rng(6).standard_normal((3, 64))}
    raise ValueError(f"job_inputs: no inputs for job {job!r}")


def _worker(args) -> None:
    import torch
    import torch.distributed as dist

    from .multihost import initialize

    if args.device == "cpu":
        torch.set_num_threads(1)
    dev = initialize(args.init_method, args.world_size, args.rank,
                     backend=args.backend, device=args.device,
                     timeout=args.timeout)
    try:
        inp = {}
        if args.inputs:
            with open(args.inputs, "rb") as f:
                inp = pickle.load(f)
        out = {"rank_device": str(dev), "world": dist.get_world_size(),
               "backend": dist.get_backend()}
        if dev.type == "cuda":
            out["current_device"] = torch.cuda.current_device()
        for job in args.jobs.split(","):
            out.update(JOBS[job](dev, inp))
        if args.out:
            with open(args.out, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _build_kernels() -> None:
    from ..ops import _build

    _build.build_all()


def run_fleet(jobs, inputs=None, num_processes: int = 2,
              backend: str = "nccl", device: str | None = None,
              timeout: float | None = None):
    """Run the named ``jobs`` on ``num_processes`` ranks; returns
    ``(combined output, [outputs of rank 0, 1, ...])``.  ``backend`` and
    ``device`` are :func:`~.multihost.initialize`'s (NCCL on the ranks'
    cards by default).  Raises with the workers' output when one fails or
    the fleet outlasts ``timeout`` seconds (then every worker is killed;
    by default 120 s for CPU ranks and :data:`NCCL_TIMEOUT` for a fleet on
    the cards, whose first NCCL setup takes longer).

    A fleet on the cards takes one card a rank, rank r on ``cuda:r``
    (``LOCAL_RANK``): it raises ``RuntimeError`` before it starts a worker
    when the machine has no card or fewer cards than ranks, and it never
    runs on gloo instead.  It builds the kernels of ``csrc/`` once, here,
    before it starts the ranks, so that they do not all build them at
    once."""
    jobs = [jobs] if isinstance(jobs, str) else list(jobs)
    for job in jobs:
        if job not in JOBS:
            raise ValueError(f"unknown job {job!r}")
    on_cards = backend == "nccl"
    if timeout is None:
        timeout = NCCL_TIMEOUT if on_cards else 120.0
    if on_cards:
        import torch

        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < num_processes:
            what = ("no CUDA device for the nccl backend" if not count else
                    f"{num_processes} NCCL ranks need as many cards, this "
                    f"machine has {count}")
            raise RuntimeError(f"run_fleet: {what}; pass backend='gloo', "
                               "device='cpu' to run the ranks on the CPU")
        _build_kernels()
    with tempfile.TemporaryDirectory(prefix="diaglib_fleet_") as tmp:
        tmp = Path(tmp)
        in_path = tmp / "inputs.pkl"
        with open(in_path, "wb") as f:
            pickle.dump(inputs or {}, f)
        env = dict(os.environ)
        env.setdefault("OMP_NUM_THREADS", "1")
        cmd = [sys.executable, "-m", "diaglib_tpu_torch.parallel.mh_dryrun",
               "--world-size", str(num_processes),
               "--init-method", f"file://{tmp / 'rendezvous'}",
               "--backend", backend, "--jobs", ",".join(jobs),
               "--inputs", str(in_path), "--timeout", str(timeout)]
        if device is not None:
            cmd += ["--device", str(device)]
        procs, logs = [], []
        for r in range(num_processes):
            if on_cards:
                env["LOCAL_RANK"] = str(r)
            logs.append(open(tmp / f"log{r}.txt", "w"))
            procs.append(subprocess.Popen(
                cmd + ["--rank", str(r), "--out", str(tmp / f"out{r}.pkl")],
                stdout=logs[-1], stderr=subprocess.STDOUT, env=dict(env),
                cwd=_ROOT))
        # a rank that fails leaves the others waiting in a collective: they
        # get a few seconds to print their side, then are killed with it
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if None not in codes:
                    break
                if failed:
                    deadline = min(deadline, time.monotonic() + _FAIL_GRACE)
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        combined = "".join((tmp / f"log{r}.txt").read_text(errors="replace")
                             for r in range(num_processes))
        hung = [r for r, c in enumerate(codes) if c is None]
        if failed or hung:
            raise RuntimeError(f"fleet ranks {failed} failed, ranks {hung} "
                               f"killed (timeout {timeout} s):\n{combined}")
        results = []
        for r in range(num_processes):
            with open(tmp / f"out{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return combined, results


def launch(num_processes: int = 2, backend: str = "nccl",
           device: str | None = None, timeout: float | None = None) -> str:
    """Spawn the dry-run fleet; returns the combined output, raises on
    failure (a rank that fails, hangs past ``timeout`` or prints no
    ``MH_DRYRUN_OK``)."""
    combined, _ = run_fleet("dryrun", None, num_processes, backend, device,
                            timeout)
    if combined.count("MH_DRYRUN_OK") != num_processes:
        raise RuntimeError(f"dry run incomplete:\n{combined}")
    return combined


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--init-method", required=True)
    p.add_argument("--backend", default="nccl")
    p.add_argument("--device", default=None)
    p.add_argument("--jobs", default="dryrun")
    p.add_argument("--inputs", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--timeout", type=float, default=300.0)
    _worker(p.parse_args(argv))


if __name__ == "__main__":
    main()
