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

:func:`run_fleet` is the general form: it runs jobs on every rank with
inputs pickled from the caller (numpy arrays and plain values) and returns
each rank's outputs.  A job is ``"dryrun"`` (the dry run above) or the
importable name ``"module:function"`` of a function ``(device, inputs) ->
dict`` that each worker imports and calls.  The workers import no JAX
unless a job does.  One worker by hand::

    python -m diaglib_tpu_torch.parallel.mh_dryrun --rank 0 \\
        --world-size 2 --init-method tcp://127.0.0.1:PORT --jobs dryrun \\
        [--backend gloo --device cpu]
"""

from __future__ import annotations

import argparse
import importlib
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
    from ..types import SolverOptions
    from .sharding import VectorSharding

    D, r = dist.get_world_size(), dist.get_rank()
    n_want, n_eig = 2, 4
    opts = SolverOptions(n_targ=n_want, n_max=n_eig, max_iter=60, tol=1e-7)

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


def _job(name: str):
    """The job ``name``: the dry run, or the function an importable
    ``"module:function"`` names."""
    if name == "dryrun":
        return _job_dryrun
    module, sep, function = name.partition(":")
    if not sep:
        raise ValueError(f"unknown job {name!r}")
    return getattr(importlib.import_module(module), function)


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
            out.update(_job(job)(dev, inp))
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
    """Run ``jobs`` (one job or a list: each ``"dryrun"`` or an importable
    ``"module:function"``) on ``num_processes`` ranks; returns
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
        _job(job)
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

