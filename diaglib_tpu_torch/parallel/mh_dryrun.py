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
solvers, a sharded checkpoint save, load and resume, and the collective
inventory of a sharded Davidson iteration.  The workers import only this
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


def _solve_opts(**kw):
    from ..types import SolverOptions
    return SolverOptions(**kw)


def _job_dryrun(dev, inp):
    """The reference's dry run: dense, distributed BSR and distributed
    sliced Davidson solves, each checked against a dense oracle."""
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
    B = 8
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
    SolverOptions fields; the ladder takes ``lo_tol``/``lo_iter``)."""
    import torch

    from ..ops.dist_sliced import dist_sliced_from_arrays, dist_sliced_matvec
    from ..problems import diag_precnd
    from ..solvers import davidson, davidson_ladder
    from .sharding import VectorSharding

    store = inp["store"]
    sh = VectorSharding(int(store["n"]))
    dm = dist_sliced_from_arrays(store, sh.rank, dev)
    out = {}
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
    ``options``."""
    import dataclasses

    import torch

    from ..problems import diag_precnd
    from ..profiling import collective_inventory
    from ..solvers import davidson

    sh, a, mv = _dense_rows(dev, inp["a"])
    pc = diag_precnd(sh.local_cols(torch.diagonal(a)))
    guess = sh.local_cols(torch.as_tensor(inp["guess"], device=dev))
    opts = dataclasses.replace(_solve_opts(**inp["options"]), max_iter=1)
    return {"inventory": collective_inventory(davidson, mv, pc, guess, opts,
                                              sharding=sh)}


JOBS = {"dryrun": _job_dryrun, "dist_sliced": _job_dist_sliced,
        "sharded_solvers": _job_sharded_solvers,
        "checkpoint": _job_checkpoint, "inventory": _job_inventory}


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
        out = {}
        for job in args.jobs.split(","):
            out.update(JOBS[job](dev, inp))
        if args.out:
            with open(args.out, "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_fleet(jobs, inputs=None, num_processes: int = 2,
              backend: str = "nccl", device: str | None = None,
              timeout: float = 120.0):
    """Run the named ``jobs`` on ``num_processes`` ranks; returns
    ``(combined output, [outputs of rank 0, 1, ...])``.  ``backend`` and
    ``device`` are :func:`~.multihost.initialize`'s (NCCL on the ranks'
    cards by default).  Raises with the workers' output when one fails or
    the fleet outlasts ``timeout`` seconds (then every worker is
    killed)."""
    jobs = [jobs] if isinstance(jobs, str) else list(jobs)
    for job in jobs:
        if job not in JOBS:
            raise ValueError(f"unknown job {job!r}")
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
        procs = []
        for r in range(num_processes):
            procs.append(subprocess.Popen(
                cmd + ["--rank", str(r), "--out", str(tmp / f"out{r}.pkl")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=_ROOT))
        deadline = time.monotonic() + timeout
        outputs, failed = [], []
        try:
            for r, p in enumerate(procs):
                left = max(deadline - time.monotonic(), 0.1)
                try:
                    out, _ = p.communicate(timeout=left)
                except subprocess.TimeoutExpired:
                    raise RuntimeError(
                        f"fleet rank {r} outlasted {timeout} s") from None
                outputs.append(out)
                if p.returncode != 0:
                    failed.append(r)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        combined = "\n".join(outputs)
        if failed:
            raise RuntimeError(f"fleet ranks {failed} failed:\n{combined}")
        results = []
        for r in range(num_processes):
            with open(tmp / f"out{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return combined, results


def launch(num_processes: int = 2, backend: str = "nccl",
           device: str | None = None, timeout: float = 300.0) -> str:
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
