"""Demo driver reproducing the reference's ``main.f90`` protocol (port of
``diaglib_tpu/demo.py``).

Usage:
    python -m diaglib_tpu_torch.demo symm   [--n 1000] [--n-want 10] [--tol 1e-8]
    python -m diaglib_tpu_torch.demo geneig ...
    python -m diaglib_tpu_torch.demo scflr  ...
    python -m diaglib_tpu_torch.demo caslr  ...
    python -m diaglib_tpu_torch.demo nonsym ...

Each subcommand mirrors one menu entry of the reference driver
(main.f90:26-45): build the same procedurally generated matrices on the
device (``--device``, the card by default; ``--device cpu`` on a machine
without one), solve densely on the host with scipy as the oracle, run the
corresponding iterative drivers, write the same result files (lapack.txt,
lobpcg.txt, davidson.txt, caslr.txt, cashp.txt, caslr_eff.txt,
nonsym.txt: eigenvalue and eigenvector with the phase fixed so component
1 is positive, main.f90:337), and print the per-iteration convergence
tables.  ``--seed`` seeds the ``torch.Generator`` of the random matrices
and guesses.  Everything is float64; torch's default dtype is left alone.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import scipy.linalg
import torch

from ._device import host_array

from .problems import (
    casida_blocks,
    dense_matvec,
    diag_precnd,
    lrprec_eff,
    lrprec_std,
    metric_matrix,
    nonsym_matrix,
    symm_matrix,
)
from .profiling import wall
from .reporting import print_convergence_table, timing_report
from .solvers import caslr, caslr_eff, davidson, gen_david, lobpcg, nonsym
from .types import SolverOptions
from .utils.guess import guess_evec


def _write_results(path, eig, evec, n_want):
    """Result file in the reference's format (main.f90:331-341)."""
    eig, evec = host_array(eig), host_array(evec)
    with open(path, "w") as f:
        for i in range(n_want):
            f.write(f"   eigenvalue # {i+1:6d}: {float(eig[i]):12.6f}\n")
            f.write("   eigenvector: \n")
            v = evec[i]
            if v[0] < 0:
                v = -v
            for off in range(0, len(v), 10):
                f.write("".join(f"{x:12.6f}" for x in v[off:off + 10]) + "\n")
            f.write("\n")


def _gen(args, seed=None):
    return torch.Generator(device=args.dev).manual_seed(
        args.seed if seed is None else seed)


def _options(args, n_max):
    return SolverOptions(n_targ=args.n_want, n_max=n_max,
                         max_iter=args.itmax, tol=args.tol,
                         max_dav=args.m_max, verbose=args.verbose)


def _report(args, fname, res, secs, title, name, evec=None):
    print_convergence_table(res, args.n_want, title, args.tol)
    timing_report(name, secs, int(res.n_iter), int(res.n_matvec),
                  includes_compile=True)
    _write_results(os.path.join(args.out_dir, fname), res.eig,
                   res.evec if evec is None else evec, args.n_want)


def cmd_symm(args):
    n, n_want = args.n, args.n_want
    n_eig = min(2 * n_want, n_want + 5)
    a = symm_matrix(n, device=args.dev)
    diag = torch.diagonal(a)
    # dense oracle on the host (scipy): the reference's lapack.txt is a
    # host dsyev (main.f90:321-342)
    w, v = scipy.linalg.eigh(host_array(a))
    _write_results(os.path.join(args.out_dir, "lapack.txt"), w, v.T, n_want)
    opts = _options(args, n_eig)
    guess = guess_evec(4, _gen(args), n, n_eig, diagonal=diag)

    res, dt = wall(lambda: lobpcg(dense_matvec(a), diag_precnd(diag),
                                  guess, opts, generator=_gen(args)))
    _report(args, "lobpcg.txt", res, dt, "LOBPCG", "lobpcg")
    res, dt = wall(lambda: davidson(dense_matvec(a), diag_precnd(diag),
                                    guess, opts, generator=_gen(args)))
    _report(args, "davidson.txt", res, dt, "Davidson-Liu", "davidson")
    _check(res, w, n_want)


def cmd_geneig(args):
    n, n_want = args.n, args.n_want
    n_eig = min(2 * n_want, n_want + 5)
    a = symm_matrix(n, device=args.dev)
    s = metric_matrix(n, _gen(args), device=args.dev)
    diag = torch.diagonal(a)
    w, v = scipy.linalg.eigh(host_array(a), host_array(s))
    _write_results(os.path.join(args.out_dir, "lapack.txt"), w, v.T, n_want)
    opts = _options(args, n_eig)
    guess = guess_evec(4, _gen(args), n, n_eig, diagonal=diag)

    res, dt = wall(lambda: lobpcg(dense_matvec(a), diag_precnd(diag),
                                  guess, opts, bvec=dense_matvec(s),
                                  generator=_gen(args)))
    _report(args, "lobpcg.txt", res, dt, "LOBPCG (generalized)", "lobpcg")
    res, dt = wall(lambda: gen_david(dense_matvec(a), diag_precnd(diag),
                                     dense_matvec(s), guess, opts,
                                     generator=_gen(args)))
    _report(args, "davidson.txt", res, dt, "Generalized Davidson",
            "gen_david")
    _check(res, w, n_want)


def _casida(args, tdscf):
    n, n_want = args.n, args.n_want
    n_eig = min(2 * n_want, n_want + 5)
    blk = casida_blocks(n, _gen(args), tdscf=tdscf, device=args.dev)
    h = {k: host_array(blk[k]) for k in ("aa", "bb", "sigma", "delta")}
    e_full = np.block([[h["aa"], h["bb"]], [h["bb"], h["aa"]]])
    s_full = np.block([[h["sigma"], h["delta"]],
                       [-h["delta"], -h["sigma"]]])
    ev, evec = scipy.linalg.eigh(s_full, e_full)
    omega = 1.0 / ev[::-1][:n_want]
    _write_results(os.path.join(args.out_dir, "lapack.txt"), omega,
                   evec[:, ::-1][:, :n_want].T, n_want)

    diag = torch.diagonal(blk["aa"]) - torch.diagonal(blk["sigma"])
    guess = guess_evec(4, _gen(args), 2 * n, n_eig, diagonal=diag)
    ops = dict(apbmul=dense_matvec(blk["apb"]),
               ambmul=dense_matvec(blk["amb"]),
               spdmul=dense_matvec(blk["spd"]),
               smdmul=dense_matvec(blk["smd"]))
    pc_std = lrprec_std(torch.diagonal(blk["aa"]),
                        torch.diagonal(blk["sigma"]))
    pc_eff = lrprec_eff(torch.diagonal(blk["aa"]),
                        torch.diagonal(blk["sigma"]))
    opts = _options(args, n_eig)

    res, dt = wall(lambda: caslr(lrprec=pc_std, evec_guess=guess,
                                 options=opts, algorithm=0, **ops))
    _report(args, "caslr.txt", res, dt, "Casida LR (inverse pencil)",
            "caslr", evec=res.evec / np.sqrt(2.0))
    if not tdscf:
        # the reference runs Helmich-Paris only in test_caslr (i_alg=1 set
        # at main.f90:688, reset at 693); test_scflr never exercises it
        res, dt = wall(lambda: caslr(lrprec=pc_std, evec_guess=guess,
                                     options=opts, algorithm=1, **ops))
        _report(args, "cashp.txt", res, dt, "Casida LR (Helmich-Paris)",
                "caslr/hp", evec=res.evec / np.sqrt(2.0))
    res, dt = wall(lambda: caslr_eff(lrprec=pc_eff, evec_guess=guess,
                                     options=opts, **ops))
    _report(args, "caslr_eff.txt", res, dt, "Casida LR (efficient)",
            "caslr_eff", evec=res.evec / 2.0)
    _check(res, omega, n_want)


def cmd_caslr(args):
    _casida(args, tdscf=False)


def cmd_scflr(args):
    _casida(args, tdscf=True)


def cmd_nonsym(args):
    n, n_want = args.n, args.n_want
    a = nonsym_matrix(n, _gen(args, 1), variant=args.variant,
                      device=args.dev)
    diag = torch.diagonal(a)
    w = np.sort(scipy.linalg.eig(host_array(a), right=False).real)
    _np = min(n_want, len(w))
    opts = _options(args, n_want)
    guess = guess_evec(6, _gen(args), n, n_want, diagonal=diag)
    res, dt = wall(lambda: nonsym(
        dense_matvec(a), dense_matvec(a.T), diag_precnd(diag), guess, opts,
        side=args.side, generator=_gen(args)))
    print("  two-sided nonsymmetric Davidson "
          f"(side={args.side}), ok={bool(res.ok)}")
    timing_report("nonsym", dt, int(res.n_iter), int(res.n_matvec),
                  includes_compile=True)
    _write_results(os.path.join(args.out_dir, "nonsym.txt"), res.eig,
                   res.evec_r if args.side != 'l' else res.evec_l, n_want)
    err = float(np.max(np.abs(host_array(res.eig[:_np]) - w[:_np])))
    print(f"  max |eig - dense| over {_np} roots: {err:.2e}")


def _check(res, oracle, n_want):
    err = float(np.max(np.abs(host_array(res.eig[:n_want])
                              - host_array(oracle)[:n_want])))
    print(f"  converged: {bool(res.ok)}; max |eig - dense| = {err:.2e}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="diaglib_tpu_torch.demo",
                                description=__doc__)
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--n-want", type=int, default=10)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--itmax", type=int, default=100)
    p.add_argument("--m-max", type=int, default=20,
                   help="max_dav (reference m_max, main.f90:18)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--verbose", action="store_true",
                   help="live per-iteration progress (SolverOptions.verbose)")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--device", default="cuda",
                   help="torch device of the matrices and solves (cuda, "
                        "the default, needs a card; cpu)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("symm")
    sub.add_parser("geneig")
    sub.add_parser("scflr")
    sub.add_parser("caslr")
    pn = sub.add_parser("nonsym")
    pn.add_argument("--side", default="c", choices=["r", "l", "s", "c"])
    pn.add_argument("--variant", type=int, default=4, choices=[1, 2, 3, 4])
    args = p.parse_args(argv)
    args.dev = torch.device(args.device)
    if args.dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("demo: no CUDA device; pass --device cpu to run "
                           "on the CPU")
    os.makedirs(args.out_dir, exist_ok=True)
    {"symm": cmd_symm, "geneig": cmd_geneig, "scflr": cmd_scflr,
     "caslr": cmd_caslr, "nonsym": cmd_nonsym}[args.cmd](args)


if __name__ == "__main__":
    main()
