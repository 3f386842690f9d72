"""The float32 -> float64 solve ladders (port of ``davidson_ladder``,
``lobpcg_ladder``, ``gen_david_ladder``, ``caslr_ladder``,
``caslr_eff_ladder`` and ``nonsym_ladder`` of
``diaglib_tpu/solvers/mixed.py``).

1. Run the solver in float32 until the residuals reach the float32 noise
   floor (``lo_tol``, at most ``lo_iter`` iterations); it need not
   converge.  The Davidson ladders' float32 stage (``davidson_ladder``,
   ``gen_david_ladder``) also ends when its residuals stall, before
   ``lo_tol`` (``solvers/davidson.py``: the largest rms of the targeted
   roots has stopped falling), where the matrix's float32 noise floor
   lies above ``lo_tol``; the other ladders run to ``lo_tol`` or
   ``lo_iter``.
2. Warm-start the float64 solver from the float32 Ritz vectors;
   ``check_guess`` (and, with a metric, ``b_ortho``) re-orthonormalizes
   them in float64 (the Casida solvers split the paired rows and
   orthonormalize the halves again, in their metrics for ``caslr_eff``).

The result is the float64 stage's, with both stages' iteration and matvec
counts added up.  On CUDA tensors each Davidson stage (``davidson_ladder``,
``gen_david_ladder``) runs its iteration as replayed CUDA graphs, each
stage capturing its own once per shape: called again with the same
callables (marked ``utils.graphs.replayable``), a ladder replays both
stages' graphs over their kept state, the two stages' buffers in one
arena made by the call that kept them (``solvers/davidson.py``).

``sharding=`` (a :class:`~diaglib_tpu_torch.parallel.VectorSharding`) is
passed to both stages: the guess, the callbacks' blocks and the result's
vectors are then this rank's column shards.  In JAX the sharding of the
guess propagates through ``jit``; the eager port takes it explicitly.
"""

from __future__ import annotations

import dataclasses

import torch

from ..types import (
    LROps,
    LRSolverResult,
    NonsymResult,
    SolverOptions,
    SolverResult,
)
from ..utils.graphs import Arena
from .caslr import caslr, caslr_eff
from .davidson import _float32_stage, davidson, gen_david
from .lobpcg import lobpcg
from .nonsym import nonsym

__all__ = ["LROps", "davidson_ladder", "lobpcg_ladder", "gen_david_ladder",
           "caslr_ladder", "caslr_eff_ladder", "nonsym_ladder"]


def _lo_options(options: SolverOptions, lo_tol, lo_iter) -> SolverOptions:
    return dataclasses.replace(
        options,
        tol=max(float(options.tol), float(lo_tol)),
        max_iter=lo_iter if lo_iter is not None else options.max_iter,
    )


def _two_stage(solver, matvec_lo, precnd_lo, matvec_hi, precnd_hi,
               evec_guess, options: SolverOptions, lo_tol, lo_iter,
               generator, bvec_lo=None, bvec_hi=None, sharding=None,
               lo_solver=None):
    lo_kw = dict(bvec=bvec_lo) if bvec_lo is not None else {}
    hi_kw = dict(bvec=bvec_hi) if bvec_hi is not None else {}
    lo = (lo_solver or solver)(
        matvec_lo, precnd_lo, evec_guess.to(torch.float32),
        _lo_options(options, lo_tol, lo_iter), generator=generator,
        sharding=sharding, **lo_kw)
    hi = solver(matvec_hi, precnd_hi, lo.evec.to(torch.float64), options,
                generator=generator, sharding=sharding, **hi_kw)
    return SolverResult(
        eig=hi.eig,
        evec=hi.evec,
        ok=hi.ok,
        n_iter=lo.n_iter + hi.n_iter,
        n_matvec=lo.n_matvec + hi.n_matvec,
        done=hi.done,
        rms_history=hi.rms_history,
        max_history=hi.max_history,
        eig_history=hi.eig_history,
        # the float32 stage is a warm start only; the float64 stage
        # re-orthonormalizes its guess, so only its ortho health counts
        ortho_ok=hi.ortho_ok,
    )


def davidson_ladder(matvec_lo, precnd_lo, matvec_hi, precnd_hi,
                    evec_guess: torch.Tensor, options: SolverOptions, *,
                    lo_tol: float = 2e-6, lo_iter: int | None = None,
                    generator: torch.Generator | None = None,
                    sharding=None) -> SolverResult:
    """float32-then-float64 Davidson-Liu.

    ``matvec_lo``/``precnd_lo`` operate on float32 blocks,
    ``matvec_hi``/``precnd_hi`` on float64.  ``lo_tol`` is the float32
    stage's rms target and ``lo_iter`` its cap.  Where ``lo_tol`` lies
    below the float32 noise floor (~1e-6 ||A||), the stage ends when its
    residuals stop falling instead (the module docstring), and the
    float64 stage starts from there.  Returns the float64 stage's
    :class:`SolverResult` with iteration/matvec counts accumulated over
    both stages.  Called again with the same callables, each stage
    replays its kept graphs as :func:`davidson` does, under the same
    condition: every callable marked ``utils.graphs.replayable``.
    """
    with Arena.ladder():
        return _two_stage(davidson, matvec_lo, precnd_lo, matvec_hi,
                          precnd_hi, evec_guess, options, lo_tol, lo_iter,
                          generator, sharding=sharding,
                          lo_solver=_float32_stage)


def lobpcg_ladder(matvec_lo, precnd_lo, matvec_hi, precnd_hi,
                  evec_guess: torch.Tensor, options: SolverOptions, *,
                  lo_tol: float = 2e-6, lo_iter: int | None = None,
                  generator: torch.Generator | None = None, bvec_lo=None,
                  bvec_hi=None, sharding=None) -> SolverResult:
    """float32-then-float64 LOBPCG; pass ``bvec_lo``/``bvec_hi`` for the
    generalized problem.  Arguments and result as :func:`davidson_ladder`.
    """
    return _two_stage(lobpcg, matvec_lo, precnd_lo, matvec_hi, precnd_hi,
                      evec_guess, options, lo_tol, lo_iter, generator,
                      bvec_lo=bvec_lo, bvec_hi=bvec_hi, sharding=sharding)


def gen_david_ladder(matvec_lo, precnd_lo, bvec_lo, matvec_hi, precnd_hi,
                     bvec_hi, evec_guess: torch.Tensor,
                     options: SolverOptions, *, lo_tol: float = 2e-6,
                     lo_iter: int | None = None,
                     generator: torch.Generator | None = None,
                     sharding=None) -> SolverResult:
    """float32-then-float64 generalized Davidson.  The float64 stage
    B-orthonormalizes the warm-start block from scratch, so the float32
    basis's metric errors do not reach the float64 result.  The float32
    stage ends on ``lo_tol``, ``lo_iter`` or a stall, as
    :func:`davidson_ladder`'s.  The result is the float64 stage's with
    both stages' counts added up.  Its graphs are kept for the next call
    as :func:`davidson_ladder`'s."""
    with Arena.ladder():
        lo = _float32_stage(matvec_lo, precnd_lo,
                            evec_guess.to(torch.float32),
                            _lo_options(options, lo_tol, lo_iter),
                            bvec=bvec_lo, generator=generator,
                            sharding=sharding)
        hi = gen_david(matvec_hi, precnd_hi, bvec_hi,
                       lo.evec.to(torch.float64), options,
                       generator=generator, sharding=sharding)
    return dataclasses.replace(hi, n_iter=lo.n_iter + hi.n_iter,
                               n_matvec=lo.n_matvec + hi.n_matvec)


def _lr_two_stage(solver, ops_lo: LROps, ops_hi: LROps, evec_guess,
                  options, lo_tol, lo_iter, generator, sharding, **kw):
    lo = solver(ops_lo.apbmul, ops_lo.ambmul, ops_lo.spdmul, ops_lo.smdmul,
                ops_lo.lrprec, evec_guess.to(torch.float32),
                _lo_options(options, lo_tol, lo_iter), generator=generator,
                sharding=sharding, **kw)
    hi = solver(ops_hi.apbmul, ops_hi.ambmul, ops_hi.spdmul, ops_hi.smdmul,
                ops_hi.lrprec, lo.evec.to(torch.float64), options,
                generator=generator, sharding=sharding, **kw)
    return dataclasses.replace(hi, n_iter=lo.n_iter + hi.n_iter,
                               n_matvec=lo.n_matvec + hi.n_matvec)


def caslr_ladder(ops_lo: LROps, ops_hi: LROps, evec_guess: torch.Tensor,
                 options: SolverOptions, *, algorithm: int = 1,
                 lo_tol: float = 2e-6, lo_iter: int | None = None,
                 generator: torch.Generator | None = None,
                 sharding=None) -> LRSolverResult:
    """float32-then-float64 Casida solver (:func:`~.caslr.caslr`, reduced
    solve ``algorithm`` in both stages).  ``ops_lo``/``ops_hi`` are the
    float32 and float64 :class:`LROps` tiers; ``evec_guess`` holds (n_max,
    2n) paired rows (``[Y_local | Z_local]`` under ``sharding``).  The
    float64 stage re-orthonormalizes the split warm-start rows in float64,
    so the float32 stage only has to land in the right subspace.  The
    result is the float64 stage's with both stages' counts added up."""
    return _lr_two_stage(caslr, ops_lo, ops_hi, evec_guess, options, lo_tol,
                         lo_iter, generator, sharding, algorithm=algorithm)


def caslr_eff_ladder(ops_lo: LROps, ops_hi: LROps, evec_guess: torch.Tensor,
                     options: SolverOptions, *, lo_tol: float = 2e-6,
                     lo_iter: int | None = None,
                     generator: torch.Generator | None = None,
                     sharding=None) -> LRSolverResult:
    """float32-then-float64 efficient Casida solver
    (:func:`~.caslr.caslr_eff`).  The float64 stage B-orthonormalizes the
    split warm-start rows against (A+B) and (A-B) from scratch, which
    erases the float32 metric noise.  Arguments and result as
    :func:`caslr_ladder`."""
    return _lr_two_stage(caslr_eff, ops_lo, ops_hi, evec_guess, options,
                         lo_tol, lo_iter, generator, sharding)


def nonsym_ladder(matvec_lo, matvec_l_lo, precnd_lo, matvec_hi, matvec_l_hi,
                  precnd_hi, evec_guess: torch.Tensor,
                  options: SolverOptions, *, side: str = "c",
                  lo_tol: float = 2e-6, lo_iter: int | None = None,
                  generator: torch.Generator | None = None, sharding=None,
                  driver: str = "auto") -> NonsymResult:
    """float32-then-float64 two-sided nonsymmetric Davidson.

    The float32 stage runs one-sided (the right pass for sides 'c'/'s',
    whose float64 stage re-derives its left side from the right vectors
    anyway; the left pass for 'l'), and the float64 stage starts from its
    eigenvectors, re-orthonormalized in float64 by ``check_guess``.
    ``driver`` and ``sharding`` are forwarded to both stages (see
    :func:`nonsym`).  The result is the float64 stage's with both stages'
    counts added up.
    """
    lo_side = "r" if side in ("s", "c") else side
    kw = dict(generator=generator, sharding=sharding, driver=driver)
    lo = nonsym(matvec_lo, matvec_l_lo, precnd_lo,
                evec_guess.to(torch.float32),
                _lo_options(options, lo_tol, lo_iter), side=lo_side, **kw)
    lo_evec = lo.evec_l if side == "l" else lo.evec_r
    hi = nonsym(matvec_hi, matvec_l_hi, precnd_hi, lo_evec.to(torch.float64),
                options, side=side, **kw)
    return dataclasses.replace(hi, n_iter=lo.n_iter + hi.n_iter,
                               n_matvec=lo.n_matvec + hi.n_matvec)
