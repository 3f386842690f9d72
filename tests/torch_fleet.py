"""The port's fleet jobs and route comparison, shared by the tests and
``chip_smoke.py`` (not a test file: pytest collects nothing here).

* Fleet jobs: each runs on every rank of
  ``diaglib_tpu_torch.parallel.mh_dryrun.run_fleet``, addressed by its
  ``"tests.torch_fleet:<function>"`` name (:data:`JOBS`), with inputs
  pickled from the caller (numpy arrays and plain values): the sharded
  operators and solvers, a sharded checkpoint save, load and resume, the
  collective inventory of a sharded Davidson iteration, the flagship's
  sharded ladders (job ``ladders``), each sharded solver on two routes
  (job ``routes``) and the process-spanning names of ``multihost`` (job
  ``mesh``).  :func:`job_inputs` makes one set of inputs a job, so that
  the same job runs under gloo on CPU ranks and under NCCL on the cards,
  and :func:`compare_fleet` and :func:`check_ladders` hold the outputs.
  The workers import this module and the port, never JAX::

      from diaglib_tpu_torch.parallel import mh_dryrun
      from tests import torch_fleet
      mh_dryrun.run_fleet(torch_fleet.JOBS["mesh"],
                          torch_fleet.job_inputs("mesh", 4), 4,
                          backend="gloo", device="cpu")

* The route comparison: :func:`route_pair` runs a solve on its captured
  route and on the uncaptured one (``utils.graphs._on_route``) and holds
  the two together (:func:`check_routes`): the same bits, the counts, the
  launches, the host's reads of the device an iteration
  (:class:`host_reads`).  :func:`flag_window` marks one iteration of a
  solve, from one flag read to the next, for a profile or an inventory of
  a warm iteration.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from diaglib_tpu_torch import checkpoint, profiling
from diaglib_tpu_torch.ops import bsr_sliced as bs
from diaglib_tpu_torch.ops.bsr import (
    as_arrays,
    bsr_diagonal,
    bsr_from_arrays,
    random_bsr_spd,
)
from diaglib_tpu_torch.ops.bsr_sliced import (
    slice_bsr,
    sliced_bsr_matvec,
    sliced_store_from_arrays,
)
from diaglib_tpu_torch.ops.dist_bsr import (
    _check_group,
    dist_bsr_matvec,
    distribute_bsr,
)
from diaglib_tpu_torch.ops.dist_sliced import (
    dist_sliced_from_arrays,
    dist_sliced_matvec,
    distribute_sliced_bsr,
    group_spmm,
    group_spmm_plain,
)
from diaglib_tpu_torch.ortho.core import ortho_qr
from diaglib_tpu_torch.parallel.multihost import (
    global_mesh,
    global_sharding,
    make_global,
    make_replicated,
)
from diaglib_tpu_torch.parallel.sharding import VectorSharding
from diaglib_tpu_torch.problems import (
    casida_blocks,
    diag_precnd,
    lrprec_eff,
    lrprec_std,
    nonsym_matrix,
    symm_matrix,
)
from diaglib_tpu_torch.profiling import collective_inventory
from diaglib_tpu_torch.solvers import (
    caslr,
    caslr_eff,
    davidson,
    davidson_ladder,
    gen_david,
    lobpcg,
    lobpcg_ladder,
    nonsym,
)
from diaglib_tpu_torch.types import SolverOptions
from diaglib_tpu_torch.utils import graphs
from diaglib_tpu_torch.utils.guess import check_guess, guess_evec
from diaglib_tpu_torch.utils.mm import mm_sharding, mmT

_log = functools.partial(print, flush=True)

# the flagship of the ladders job: random_bsr_spd(n, 512, 8), 10 roots of
# a search space of 15
BLOCK, BPR = 512, 8
N_TARG, N_MAX = 10, 15

# each job by its short name: the address run_fleet takes
JOBS = {"dryrun": "dryrun"} | {
    name: f"tests.torch_fleet:_job_{name}"
    for name in ("dist_sliced", "sharded_solvers", "checkpoint", "inventory",
                 "ladders", "mesh", "routes")}
# the jobs run under gloo on CPU ranks and under NCCL on the cards, on one
# set of inputs each (job_inputs), and held together (compare_fleet)
MC_JOBS = ("dryrun", "dist_sliced", "sharded_solvers", "checkpoint",
           "inventory", "routes")


# ---- the route comparison ----

class host_reads:
    """Counts the host's reads of the device: torch.cuda's sync debug mode
    warns at every synchronizing call (a copy to the host, ``.item()``, a
    library's error check), and each warning is kept.  ``marks`` holds the
    count at each flag read of the solvers' steps (``utils.graphs.
    _read_flags``), so :meth:`per_iteration` gives the reads between two
    of them."""

    def __enter__(self):
        self._catch = warnings.catch_warnings(record=True)
        self.log = self._catch.__enter__()
        warnings.simplefilter("always")
        self.marks = []
        graphs._read_flags.observer = lambda: self.marks.append(self.reads())
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        graphs._read_flags.observer = None
        self._catch.__exit__(*exc)
        return False

    def reads(self) -> int:
        return sum("synchroniz" in str(w.message) for w in self.log)

    def per_iteration(self, solves) -> list:
        """Reads between consecutive flag reads of one solve (an
        iteration's, from a solve's second on), given the solves' records
        (their ``flag_reads``, in order)."""
        out, at = [], 0
        for s in solves:
            marks = self.marks[at:at + s["flag_reads"]]
            out += [b - a for a, b in zip(marks, marks[1:])]
            at += s["flag_reads"]
        return out


@contextlib.contextmanager
def flag_window(start: int = 2, prof=None):
    """Mark one iteration of the solve run under it: from its ``start``-th
    flag read (``utils.graphs._read_flags``) to the next, the
    collectives are recorded (``inventory``, as
    ``profiling.collective_inventory`` records them: a replayed step counts
    what it runs) and, with a running ``torch.profiler`` ``prof``, the span
    is a ``record_function`` scope named "flag-window".  Yields a dict with
    ``inventory``, ``host_ms`` (the window on the host's clock, which
    starts and ends at a read of the device) and ``closed``."""
    out = {"inventory": {}, "host_ms": None, "closed": False}
    state = {"reads": 0, "open": []}

    def observe():
        state["reads"] += 1
        if state["reads"] == start:
            rec = profiling._recording(out["inventory"])
            rec.__enter__()
            state["open"].append(rec)
            if prof is not None:
                scope = profiling._span("flag-window")
                scope.__enter__()
                state["open"].append(scope)
            state["t0"] = time.perf_counter()
        elif state["reads"] == start + 1:
            out["host_ms"] = (time.perf_counter() - state["t0"]) * 1e3
            while state["open"]:
                state["open"].pop().__exit__(None, None, None)
            out["closed"] = True

    prev = graphs._read_flags.observer
    graphs._read_flags.observer = observe
    try:
        yield out
    finally:
        graphs._read_flags.observer = prev
        while state["open"]:
            state["open"].pop().__exit__(None, None, None)


def _equal(a, b) -> bool:
    """Every field of two solver results the same (tensors bit for bit)."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


def _reruns(solves) -> int:
    return sum(sum(s["reruns"].values()) for s in solves)


def _flag_digest(solves) -> str:
    """sha1 of the flags every solve of ``solves`` read, in order: the
    same on every rank of a sharded solve, whose ranks take the same
    branches."""
    return hashlib.sha1(repr([s["flag_history"] for s in solves])
                        .encode()).hexdigest()


def route_pair(run, device) -> dict:
    """``run(generator)`` (a solve or a ladder on CUDA tensors; a fresh
    generator seeded with 1 each time) on its default route, the steps
    captured and replayed as CUDA graphs, and on the uncaptured one (the
    same steps called directly), each through ``utils.graphs._on_route``,
    then once more on each under :class:`host_reads`.  Returns a dict:
    ``same`` (every field of the two results equal, tensors bit for bit),
    ``counts`` (n_iter, n_matvec, ok, ortho_ok of each), ``launches`` and
    ``solves`` (the records of each route's first run), ``reads`` (the
    host's reads of the device in the second run of each: ``total``,
    ``iterations``, the reads ``between`` two flag reads, and its
    ``reruns``), ``reruns`` of the captured run and the ``digest`` of its
    flag history.  Keys are "graphs" and "eager".  Where ``run`` calls a
    Davidson solver or ladder with the same replayable callables each time,
    the captured route's later runs replay the graphs its first run kept
    (``utils.graphs.StepCache``), as a caller's repeated solves do."""
    def once(route):
        return graphs._on_route(
            lambda: run(torch.Generator(device=device).manual_seed(1)),
            None if route == "graphs" else route)

    runs = {route: once(route) for route in ("graphs", "eager")}
    reads = {}
    for route in ("graphs", "eager"):
        with host_reads() as reader:
            _, solves, _ = once(route)
        reads[route] = {"total": reader.reads(),
                        "iterations": sum(s["iterations"] for s in solves),
                        "between": reader.per_iteration(solves),
                        "reruns": _reruns(solves)}
    (cap, rc, _), (unc, _, _) = runs["graphs"], runs["eager"]
    return {"same": _equal(cap, unc),
            "counts": {k: (r.n_iter, r.n_matvec, r.ok, r.ortho_ok)
                       for k, (r, _, _) in runs.items()},
            "launches": {k: v[2] for k, v in runs.items()},
            "solves": {k: v[1] for k, v in runs.items()},
            "reads": reads, "reruns": _reruns(rc),
            "digest": _flag_digest(rc)}


def check_routes(tag, cmp, matvec_kernels):
    """Raise unless :func:`route_pair`'s ``cmp`` holds: the same bits and
    counts, the same launches of ``matvec_kernels`` (but after a
    rare-branch rerun, which runs steps 1-2 again; the unrolled ortho
    passes of a replay launch K3 whether or not their loop has stopped),
    every stage on its route, and at most 3 host reads between two flag
    reads of the captured run where no step was run again (a nonsymmetric
    pass's Gram matrix, which the host dgeev reads, among them)."""
    lc, lu = cmp["launches"]["graphs"], cmp["launches"]["eager"]
    routes = {k: {s["route"] for s in cmp["solves"][k]}
              for k in ("graphs", "eager")}
    if not (cmp["same"] and cmp["counts"]["graphs"] == cmp["counts"]["eager"]
            and routes == {"graphs": {"graphs"}, "eager": {"eager"}}
            and (cmp["reruns"] or all(lc[k] == lu[k]
                                      for k in matvec_kernels))):
        raise AssertionError(f"{tag}: the captured and uncaptured ladders "
                             "differ")
    r = cmp["reads"]["graphs"]
    if not r["reruns"] and max(r["between"]) > 3:
        raise AssertionError(f"{tag}: more than 3 host reads an iteration "
                             "on the captured route")


# ---- the fleet jobs ----

def _gathered(sh, t):
    """Every rank's copy of the replicated tensor ``t``, stacked."""
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
    store = inp["store"]
    sh = VectorSharding(int(store["n"]))
    dm = dist_sliced_from_arrays(store, sh.rank, dev)
    out = _received_levels(dm, sh, sh.local_cols(
        torch.as_tensor(inp["x_f64"], device=dev)), keep=True)
    for tag, dt in (("f64", torch.float64), ("f32", torch.float32)):
        x = sh.local_cols(torch.as_tensor(inp[f"x_{tag}"], device=dev))
        out[f"y_{tag}"] = dist_sliced_matvec(dm, sh, dtype=dt)(x).cpu() \
            .numpy()
    opts = SolverOptions(**inp["options"])
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
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _received_levels(dm, sh, x, keep=False):
    """Kernel K6 on every group of this rank, at both tiers, on the x shard
    each group receives through the ring (``sh.permute`` of this rank's
    shard ``x``, as the matvec fetches it) and slices with K2: the launch
    against ``group_spmm_plain`` on the same planes, bit for bit.  Returns
    whether they were equal, the largest difference and a digest of the
    planes, row scales and levels a tier; with ``keep`` the arrays too (one
    list a tier, one entry a group)."""
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
    r = bsr_mv(evec) - eig[:, None] * evec
    rms = torch.sqrt(sh.sum((r * r).sum(dim=1)) / sh.n)
    return rms.cpu().numpy(), sh.max(r.abs().amax(dim=1)).cpu().numpy()


def _build_operator(dev, inp, rank, size, keep_whole):
    """This rank's distributed float64-product BSR operator and sliced
    store for :func:`_job_ladders`, the whole general store when
    ``keep_whole`` (else None), and a digest of the matrix's diagonal when
    this rank built the matrix (else None)."""
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
    torch.profiler, its second iteration marked (:func:`flag_window`:
    from the second flag read to the third, the steps of a captured solve
    replayed): that iteration's collectives by kind with their count,
    bytes and the device ms of their NCCL kernels, the device-busy ms (the
    union of every kernel, copy and fill that starts in the window), its
    device kernels, and the window's host ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    (:func:`route_pair`).
    The returned pairs' residuals come from the float64 product of the
    original blocks, distributed (``dist_bsr_matvec``).  With
    ``unsharded``, rank 0 also runs each ladder over ``sliced_bsr_matvec``
    (K5) on the whole store, and its pairs' residuals are taken the same
    way.  With ``profile``, one warm float64 sharded Davidson iteration on
    each route, captured and eager, is profiled on rank 0
    (:func:`_profile_iteration`).  Each card's peak memory is read after
    the build and after the ladders."""
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

    opts = SolverOptions(**inp["options"])
    n_targ = opts.n_targ
    full = (torch.as_tensor(inp["guess"], device=dev) if "guess" in inp
            else torch.zeros((opts.n_max, dm.n), dtype=f64, device=dev))
    guess = sh.local_cols(full).contiguous()
    ladders = {"davidson": davidson_ladder, "lobpcg": lobpcg_ladder}

    def pairs(tag, res, launches, evec, eig):
        rms, rmax = _residuals(bsr_mv, sh, evec, eig)
        out.update({f"{tag}_eig": res.eig.cpu().numpy(),
                    f"{tag}_ok": bool(res.ok),
                    f"{tag}_ortho_ok": bool(res.ortho_ok),
                    f"{tag}_iter": int(res.n_iter),
                    f"{tag}_matvec": int(res.n_matvec),
                    f"{tag}_f64_iter": int(torch.isfinite(
                        res.rms_history[:, 0]).sum()),
                    f"{tag}_launches": launches,
                    f"{tag}_res_rms": rms, f"{tag}_res_max": rmax})

    for name in inp["ladders"]:
        lad, lo_iter = ladders[name], inp["lo_iter"][name]

        def run(lo, plo, hi, phi, g, sharding):
            return lad(lo, plo, hi, phi, g, opts, lo_tol=inp["lo_tol"],
                       lo_iter=lo_iter, sharding=sharding,
                       generator=torch.Generator(device=dev).manual_seed(1))

        args = (mv_lo, pc_lo, mv_hi, pc_hi, guess, sh)
        if inp.get("warm", True):
            run(*args)
        res, solves, launches = graphs._on_route(lambda: run(*args))
        pairs(name, res, launches, res.evec[:n_targ].contiguous(),
              res.eig[:n_targ])
        out[f"{name}_routes"] = sorted({s["route"] for s in solves})
        out[f"{name}_digest"] = _flag_digest(solves)
        out[f"{name}_eig_ranks"] = _gathered(sh, res.eig_history)
        with mm_sharding(sh):
            out[f"{name}_gram_ranks"] = _gathered(
                sh, mmT(res.evec, res.evec))
        if inp.get("compare") and cuda:
            out[f"{name}_compare"] = route_pair(
                lambda gen: lad(*args[:5], opts, lo_tol=inp["lo_tol"],
                                lo_iter=lo_iter, sharding=sh, generator=gen),
                dev)
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
                run(*uargs)
            res_u, _, launches_u = graphs._on_route(lambda: run(*uargs))
            vec.copy_(res_u.evec[:n_targ])
            lam.copy_(res_u.eig[:n_targ])
        dist.broadcast(vec, 0)
        dist.broadcast(lam, 0)
        vec = sh.local_cols(vec).contiguous()
        if r == 0:
            pairs(f"{name}_k5", res_u, launches_u, vec, lam)
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
    opts = SolverOptions(**inp["options"])
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
    sh, a, mv = _dense_rows(dev, inp["a"])
    _, _, bv = _dense_rows(dev, inp["s"])
    _, _, mv32 = _dense_rows(dev, inp["a"].astype(np.float32))
    pc = diag_precnd(sh.local_cols(torch.diagonal(a)))
    pc32 = diag_precnd(sh.local_cols(torch.diagonal(a)).float())
    guess = sh.local_cols(torch.as_tensor(inp["guess"], device=dev))
    opts = SolverOptions(**inp["options"])

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
    ns_opts = SolverOptions(**inp["nonsym_options"])

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
    stages (``utils.graphs._on_route``: flag history, reruns, replays)
    and the eigenvalue history of every rank (gathered); and the launch
    counts of each run; and what ``keep_alive`` kept of the ring permutes
    of offsets 0 to the world size, one each."""
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
        res, solves, launches = graphs._on_route(runs[name], route, budgets)
        rec_out = _fields(res)
        rec_out.update(solves=solves, launches=launches,
                       eig_ranks=_gathered(sh, res.eig_history))
        out[f"{tag}:{name}"] = rec_out
    return out


def _nonsym_solves(dev, inp):
    a = torch.as_tensor(inp["nonsym"], device=dev)
    sh = VectorSharding(a.shape[0])
    a_loc, at_loc = sh.local_cols(a.T).T, sh.local_cols(a).T
    opts = SolverOptions(**inp["nonsym_options"])
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
    sh, a, mv = _dense_rows(dev, inp["a"])
    pc = diag_precnd(sh.local_cols(torch.diagonal(a)))
    guess = sh.local_cols(torch.as_tensor(inp["guess"], device=dev))
    opts = SolverOptions(**inp["options"])
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
    the third, :func:`flag_window`; a captured step's replay counts
    what its capture recorded)."""
    sh, a, mv = _dense_rows(dev, inp["a"])
    pc = diag_precnd(sh.local_cols(torch.diagonal(a)))
    guess = sh.local_cols(torch.as_tensor(inp["guess"], device=dev))
    opts = SolverOptions(**inp["options"])

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


# ---- the checks of the jobs' outputs ----

def ladder_inputs(n, ladders, unsharded, profile):
    """The ladders job's inputs: random_bsr_spd(n, 512, 8) built on every
    rank, the ladders of phase 5 at its options, a zero guess; each
    sharded ladder also captured against uncaptured."""
    return dict(build=dict(n=n, block=BLOCK, bpr=BPR, seed=0),
                ladders=list(ladders),
                options=dict(n_targ=N_TARG, n_max=N_MAX, max_iter=150,
                             tol=1e-10, max_dav=10),
                lo_tol=2e-6, lo_iter=dict(davidson=35, lobpcg=70),
                unsharded=unsharded, profile=profile, compare=True)


def eig_gap(a, b, n_targ):
    """max |a - b| over the first ``n_targ`` eigenvalues, and whether it is
    within 1e-10 * max(1, |b|)."""
    d = float(np.max(np.abs(np.asarray(a)[:n_targ] - np.asarray(b)[:n_targ])))
    return d, d <= 1e-10 * max(1.0, float(np.max(np.abs(b[:n_targ]))))


def solve_pair(tag, g, c, n_targ, n_max, counts=True):
    """One solve's result under gloo (``g``, a rank's output dict) and
    NCCL (``c``) at ``tag``: eigenvalues within 1e-10, iterations within
    +-2 and matvecs within +-2 blocks (``counts``), both ok."""
    d, close = eig_gap(c[f"{tag}_eig"], g[f"{tag}_eig"], n_targ)
    di = abs(c[f"{tag}_iter"] - g[f"{tag}_iter"])
    dm = abs(c[f"{tag}_matvec"] - g[f"{tag}_matvec"])
    ok = (close and g[f"{tag}_ok"] and c[f"{tag}_ok"]
          and (not counts or (di <= 2 and dm <= 2 * n_max)))
    line = (f"{tag} eigenvalues {d:.2e} apart, iterations "
            f"{g[f'{tag}_iter']} / {c[f'{tag}_iter']}, matvecs "
            f"{g[f'{tag}_matvec']} / {c[f'{tag}_matvec']}"
            + ("" if counts else " (counts not held: another random "
               "stream)"))
    if not ok:
        raise AssertionError(f"gloo and NCCL disagree: {line}")
    return line


def same_on_every_rank(outs, key):
    """Whether the array ``key`` every rank gathered from all ranks holds
    one bit pattern (each rank's copy of an all-reduced result)."""
    return all(np.array_equal(h, out[key][0]) for out in outs
               for h in out[key])


def compare_fleet(job, gloo, nccl):
    """Hold one job's NCCL run on the cards against its gloo run on CPU
    ranks (each ``(combined output, [rank outputs])``); returns the lines
    to print, raises AssertionError on a disagreement."""
    (g_text, g_outs), (c_text, c_outs) = gloo, nccl
    size = len(c_outs)
    lines = []
    for r, out in enumerate(c_outs):
        if not (out["backend"] == "nccl" and out["rank_device"] == f"cuda:{r}"
                and out["current_device"] == r):
            raise AssertionError(f"{job}: NCCL rank {r} ran on "
                                 f"{out['rank_device']} ({out['backend']})")
    if job == "dryrun":
        for text in (g_text, c_text):
            if text.count("MH_DRYRUN_OK") != size:
                raise AssertionError(f"dryrun incomplete:\n{text}")
        keys = ("dense_err", "bsr_err", "mv_err", "sliced_err")
        lines.append(f"MH_DRYRUN_OK from all {size} ranks on both; oracle "
                     "errors gloo / NCCL: " + ", ".join(
                         f"{k} {g_outs[0][k]:.2e} / {c_outs[0][k]:.2e}"
                         for k in keys))
    elif job == "dist_sliced":
        n_groups = 0
        for g, c in zip(g_outs, c_outs):
            for tier in ("f64", "f32"):
                if not c[f"k6_{tier}_equal"]:
                    raise AssertionError(f"K6 != its plain version ({tier})")
                for gg, cg in zip(g[f"k6_{tier}"], c[f"k6_{tier}"]):
                    n_groups += 1
                    if not all(np.array_equal(a, b) for a, b in zip(gg, cg)):
                        raise AssertionError(
                            f"K6's planes, scales or levels differ ({tier})")
            y, yc = g["y_f64"], c["y_f64"]
            e64 = float(np.max(np.abs(y - yc)) / np.max(np.abs(y)))
            y32, yc32 = g["y_f32"], c["y_f32"]
            e32 = float(np.max(np.abs(y32 - yc32)) / np.max(np.abs(y32)))
            if not (e64 <= 1e-14 and e32 <= 2.0 ** -20):
                raise AssertionError(f"dist_sliced matvec: {e64} / {e32}")
        lines.append(f"K6 on the received planes == its plain version on "
                     f"every rank; planes, row scales and levels bit-equal "
                     f"to gloo's on all {n_groups} (rank, tier, group); "
                     f"matvec f64 within {e64:.1e}, f32 {e32:.1e} of max|y|")
        for tag in ("david", "ladder"):
            lines.append(solve_pair(tag, g_outs[0], c_outs[0], 4, 8))
            if not all(same_on_every_rank(o, f"{tag}_eig_ranks")
                       for o in (g_outs, c_outs)):
                raise AssertionError(f"{tag}: reduced results differ "
                                     "across ranks")
    elif job == "sharded_solvers":
        g, c = g_outs[0], c_outs[0]
        for tag in ("davidson", "gen_david", "lobpcg", "bsr_davidson",
                    "caslr", "caslr_eff", "caslr_zero"):
            lines.append(solve_pair(tag, g, c, 4, 8,
                                    counts=tag != "caslr_zero"))
        for tag in ("nonsym_host", "nonsym_device"):
            lines.append(solve_pair(tag, g, c, 5, 5))
        keys = [k for k in c if k.endswith("_ranks")]
        if not all(same_on_every_rank(o, k) for o in (g_outs, c_outs)
                   for k in keys):
            raise AssertionError("a reduced result differs across ranks")
        lines.append(f"every rank's reduced results bit-identical within "
                     f"each run ({len(keys)} gathered: {', '.join(keys)})")
        e = max(float(np.max(np.abs(go[k] - co[k])) / np.max(np.abs(go[k])))
                for go, co in zip(g_outs, c_outs) for k in ("bsr_y", "qr"))
        if not (e <= 1e-12 and c["bsr_steps"] == g["bsr_steps"]):
            raise AssertionError(f"dist_bsr_matvec / ortho_qr: {e}")
        lines.append(f"dist_bsr_matvec and the sharded QR within {e:.1e} of "
                     f"max|y|; steps {list(c['bsr_steps'])}")
    elif job == "checkpoint":
        for g, c in zip(g_outs, c_outs):
            d, close = eig_gap(c["resumed_eig"], g["resumed_eig"], 3)
            if not (c["loaded_equal"] and c["resumed_ok"] and close
                    and abs(c["resumed_iter"] - g["resumed_iter"]) <= 2
                    and abs(c["scratch_iter"] - g["scratch_iter"]) <= 2
                    and c["resumed_iter"] < c["scratch_iter"]):
                raise AssertionError(f"checkpoint: {c} against {g}")
        lines.append(f"every field loaded bit-equal on every card; resumed "
                     f"{c_outs[0]['resumed_iter']} iterations against "
                     f"{c_outs[0]['scratch_iter']} from scratch (gloo "
                     f"{g_outs[0]['resumed_iter']} / "
                     f"{g_outs[0]['scratch_iter']}), eigenvalues {d:.2e} "
                     "apart")
    elif job == "routes":
        lines += routes_fleet(g_outs, c_outs)
    elif job == "inventory":
        for key, what in (("inventory", "eager"),
                          ("captured", "captured (unrolled under gloo)"),
                          ("warm", "one warm iteration, captured steps "
                                   "replayed (unrolled under gloo)")):
            inv = [o[key] for o in g_outs + c_outs]
            if any(i != inv[0] for i in inv):
                raise AssertionError(f"inventory {key}: {inv}")
            lines.append(f"one sharded iteration's collectives, {what}, "
                         f"equal on every rank of both: {json.dumps(inv[0])}")
    return lines


def _fields_equal(a, b):
    """Two result dicts of job ``routes`` equal field for field (arrays bit
    for bit; the records and launch counts aside)."""
    skip = ("solves", "launches")
    return a.keys() == b.keys() and all(
        np.array_equal(v, b[k]) if isinstance(v, np.ndarray) else v == b[k]
        for k, v in a.items() if k not in skip)


def routes_fleet(g_outs, c_outs):
    """Job ``routes`` under gloo ("unrolled" against "eager") and under
    NCCL on the cards ("graphs", each step captured and replayed with its
    collectives and ring permutes inside, against "eager"): on every rank
    of each, the two routes the same bits, every stage on its route, the
    forced reruns counted and the same bits as "eager", the flag history
    and the eigenvalue history the same on every rank; NCCL against gloo
    as the other jobs (eigenvalues within 1e-10, counts within +-2)."""
    lines = []
    for outs, want in ((g_outs, ("unrolled", "eager")),
                       (c_outs, ("graphs", "eager"))):
        first = want[0]
        if any(o["routes"] != want for o in outs):
            raise AssertionError(f"routes: not {want} on every rank")
        names = [k[6:] for k in outs[0] if k.startswith("eager:")]
        shorts = [k[6:] for k in outs[0] if k.startswith("short:")]
        pairs = ([(f"{first}:{n}", n, False) for n in names]
                 + [(f"short:{n}", n, True) for n in shorts])
        for tag, name, forced in pairs:
            for o in outs:
                got = o[tag]
                if not (_fields_equal(got, o[f"eager:{name}"])
                        and {s["route"] for s in got["solves"]} == {first}
                        and (_reruns(got["solves"]) or not forced)):
                    raise AssertionError(f"routes: {tag} differs from "
                                         "eager on a rank")
            hist = [[s["flag_history"] for s in o[tag]["solves"]]
                    for o in outs]
            if any(h != hist[0] for h in hist) or not same_on_every_rank(
                    [o[tag] for o in outs], "eig_ranks"):
                raise AssertionError(f"routes: {tag}: the ranks differ")
        reruns = {n: _reruns(outs[0][f"short:{n}"]["solves"])
                  for n in shorts}
        cap = {n: round(sum(s["capture_s"] for s in
                            outs[0][f"{first}:{n}"]["solves"]) * 1e3, 1)
               for n in names}
        lines.append(
            f"{first} == eager bit for bit on all {len(outs)} ranks for "
            f"{', '.join(names)}; one-pass budgets force reruns {reruns} "
            f"and stay bit-equal; flag and eigenvalue histories the same "
            f"on every rank; capture ms rank 0 {cap}")
    for k in c_outs[0]:
        if not k.startswith("eager:"):
            continue
        name = k[6:]
        g, c = g_outs[0][k], c_outs[0][f"graphs:{name}"]
        n_targ = 5 if name == "nonsym" else 4
        d, close = eig_gap(c["eig"], g["eig"], n_targ)
        if not (close and g["ok"] and c["ok"]
                and abs(c["n_iter"] - g["n_iter"]) <= 2
                and abs(c["n_matvec"] - g["n_matvec"]) <= 2 * 8):
            raise AssertionError(f"routes {name}: gloo and NCCL disagree")
        lines.append(f"{name} captured on the cards vs eager on gloo: "
                     f"eigenvalues {d:.2e} apart, iterations {g['n_iter']} "
                     f"/ {c['n_iter']}, matvecs {g['n_matvec']} / "
                     f"{c['n_matvec']}")
    return lines


def routes_lines(tag, name, outs, card):
    """A ladder's ``{name}_compare`` (:func:`route_pair`) on every
    rank of the ladders job: each captured equal to uncaptured (the same
    bits, counts and K2 / K6 launches, at most 3 host reads an iteration),
    the captured flag digest the same on every rank; prints one line a
    rank."""
    digests = {o[f"{name}_compare"]["digest"] for o in outs}
    if len(digests) != 1 or {o[f"{name}_digest"] for o in outs} \
            != digests:
        raise AssertionError(f"{tag} {name}: the ranks read other flags")
    for r, o in enumerate(outs):
        cmp = o[f"{name}_compare"]
        check_routes(f"{tag} rank {r} {name}_ladder", cmp,
                     ("peel_rows", "group_spmm"))
        rd = {k: cmp["reads"][k] for k in ("graphs", "eager")}
        stages = "; ".join(
            f"{s['dtype']} {s['iterations']} iterations, reruns "
            f"{s['reruns']}, capture {s['capture_s'] * 1e3:.1f} ms, pool "
            f"{s['pool_bytes'] / 2**20:.1f} MiB"
            for s in cmp["solves"]["graphs"])
        _log(f"[multicard] {tag} rank {r} sharded {name}_ladder captured vs "
             f"uncaptured: bit-identical {cmp['same']}, counts "
             f"{cmp['counts']['graphs']} vs {cmp['counts']['eager']}; "
             f"host reads "
             + ", ".join(f"{k} {v['total']} in {v['iterations']} iterations "
                         f"(max {max(v['between'])} between flag reads)"
                         for k, v in rd.items())
             + f"; {stages}; flag digest {cmp['digest'][:12]} ({card})")


def check_ladders(tag, outs, card, unsharded):
    """The ladders job's outputs: on every rank ok, its pairs' residuals by
    the distributed float64 BSR product within rms 1e-10 and max 1e-9, the
    same eigenvalues and counts, its reduced results bit-identical across
    the ranks, K6 on the received planes bit-equal to its plain version
    at both tiers, the ring permutes posted in one order; with
    ``unsharded``, rank 0's K5 ladder's pairs within the same residual
    bounds and the sharded eigenvalues within 1e-10 of them; the two
    ladders' counts are printed, not held (the float32 tier of the
    distributed operator slices each received shard on its own grid, so
    its float32 stage ends elsewhere: PERF.md §7.7).  Prints one
    [multicard] line a check; returns the launch counts of the sharded
    ladders, summed over the ranks, and of rank 0's K5 ladders."""
    first = outs[0]
    if len({o["build_digest"] for o in outs}) != 1:
        raise AssertionError(f"{tag}: the ranks built different matrices "
                             "from one seed")
    check_permute_order(outs)
    _log(f"[multicard] {tag}: n={first['n']} over {len(outs)} ranks, steps "
         f"{first['steps']}, entries a rank "
         f"{[o['entries'] for o in outs]}, store "
         f"{sum(o['store_bytes'] for o in outs) / 1e9:.3f} GB ("
         f"{first['store_bytes'] / 1e9:.3f} GB on rank 0); build "
         f"{max(o['build_s'] for o in outs):.1f} s, the same matrix on every "
         f"rank (diagonal sha1 {str(first['build_digest'])[:12]}); ring "
         f"permutes in one "
         f"order on every rank ({len(first['permutes'])} a rank: "
         f"{[c[0] for c in first['permutes']]})")
    if not all(o[f"k6_{t}_equal"] for o in outs for t in ("f64", "f32")):
        raise AssertionError(f"{tag}: K6 != its plain version on a rank")
    _log(f"[multicard] {tag}: K6 on every rank's received planes == "
         f"group_spmm_plain, both tiers, all {len(outs) * len(first['steps'])}"
         " (rank, group) a tier")
    _log(f"[multicard] {tag}: peak memory a card, GB: build "
         f"{[round(o['peak_build_bytes'] / 1e9, 3) for o in outs]}, ladders "
         f"{[round(o['peak_ladder_bytes'] / 1e9, 3) for o in outs]} ({card})")
    launches, k5_launches = {}, {}
    for name in ("davidson", "lobpcg"):
        if f"{name}_eig" not in first:
            continue
        # captured under NCCL; a gloo fleet (a rehearsal on CPU ranks) has
        # no capture
        if any(o[f"{name}_routes"] != (["graphs"] if o["backend"] == "nccl"
                                       else ["eager"]) for o in outs):
            raise AssertionError(f"{tag} {name}: a rank's sharded ladder "
                                 "ran on another route")
        if f"{name}_compare" in first:
            routes_lines(tag, name, outs, card)
        for o in outs:
            rms, rmax = np.max(o[f"{name}_res_rms"]), np.max(
                o[f"{name}_res_max"])
            if not (o[f"{name}_ok"] and rms < 1e-10 and rmax < 1e-9
                    and np.array_equal(o[f"{name}_eig"], first[f"{name}_eig"])
                    and o[f"{name}_iter"] == first[f"{name}_iter"]
                    and same_on_every_rank(outs, f"{name}_eig_ranks")
                    and same_on_every_rank(outs, f"{name}_gram_ranks")):
                raise AssertionError(f"{tag} {name}: a rank failed or "
                                     "disagrees")
        for o in outs:
            for k, v in o[f"{name}_launches"].items():
                launches[k] = launches.get(k, 0) + v
        _log(f"[multicard] {tag} sharded {name}_ladder: ok, "
             f"{first[f'{name}_iter']} iterations (f64 "
             f"{first[f'{name}_f64_iter']}), {first[f'{name}_matvec']} "
             f"matvecs; residuals by dist_bsr_matvec f64: rms "
             f"{np.max(first[f'{name}_res_rms']):.3e}, max "
             f"{np.max(first[f'{name}_res_max']):.3e}; eigenvalues, "
             f"counts and reduced matrices bit-identical on all ranks; "
             f"launches rank 0 {json.dumps(first[f'{name}_launches'])} "
             f"({card})")
        if not unsharded:
            continue
        k5 = f"{name}_k5"
        rms, rmax = np.max(first[f"{k5}_res_rms"]), np.max(
            first[f"{k5}_res_max"])
        d, close = eig_gap(first[f"{name}_eig"], first[f"{k5}_eig"], N_TARG)
        _log(f"[multicard] {tag} rank 0 unsharded {name}_ladder over K5: ok="
             f"{first[f'{k5}_ok']}, {first[f'{k5}_iter']} iterations (f64 "
             f"{first[f'{k5}_f64_iter']}), {first[f'{k5}_matvec']} matvecs, "
             f"residuals rms {rms:.3e}, max "
             f"{rmax:.3e}; sharded eigenvalues {d:.3e} apart, iterations "
             f"{first[f'{name}_iter']} vs {first[f'{k5}_iter']}, matvecs "
             f"{first[f'{name}_matvec']} vs {first[f'{k5}_matvec']} "
             f"(counts printed, not held) ({card})")
        if not (first[f"{k5}_ok"] and rms < 1e-10 and rmax < 1e-9 and close):
            raise AssertionError(f"{tag} {name}: the sharded and the "
                                 "unsharded ladders disagree")
        for k, v in first[f"{k5}_launches"].items():
            k5_launches[k] = k5_launches.get(k, 0) + v
    return launches, k5_launches
