"""Solver options and results (port of ``diaglib_tpu/types.py``).

Callback contract, as in the JAX package:

* ``matvec(x)`` applies the operator to a block of row vectors,
  ``x: (k, n) -> (k, n)``; it must be linear (zero rows stay zero).
* ``precnd(shift, r)`` is a shift-aware preconditioner,
  ``(float, (k, n)) -> (k, n)``.
* The Casida operators ``apbmul``/``ambmul``/``spdmul``/``smdmul`` map
  ``(k, n) -> (k, n)``, and the paired preconditioner
  ``lrprec(fac, rp, rm) -> (yp, ym)`` takes a 0-d tensor ``fac`` on the
  solve's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

MatVec = Callable[[torch.Tensor], torch.Tensor]
PrecndFn = Callable[[float, torch.Tensor], torch.Tensor]
LRPrecndFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                      tuple]

__all__ = ["MatVec", "PrecndFn", "LRPrecndFn", "LROps", "SolverOptions",
           "SolverResult", "LRSolverResult", "NonsymResult"]


@dataclasses.dataclass(frozen=True)
class LROps:
    """The Casida four-operator bundle and its paired preconditioner, for
    example one precision tier of a linear-response ladder."""

    apbmul: MatVec
    ambmul: MatVec
    spdmul: MatVec
    smdmul: MatVec
    lrprec: LRPrecndFn


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Solver configuration, field for field the JAX package's.

    n_targ:   number of converged eigenpairs required.
    n_max:    block size / max subspace width per macro-block (>= n_targ).
    max_iter: maximum number of iterations.
    tol:      rms convergence threshold; the max-norm threshold is ``10*tol``.
    max_dav:  macro-blocks before a restart; effective ``max(10, max_dav)``.
    shift:    diagonal level shift, removed from the reported eigenvalues.
    reduced_solver: the route of the reduced solves (``utils.reduced``):
              "auto" and "device" are ``torch.linalg`` on the tensors'
              device, "host" scipy's LAPACK on a float64 CPU copy,
              "jacobi" the cyclic-Jacobi solvers of ``utils.jacobi`` on
              the tensors' device.
    verbose:  print one progress line per iteration.
    wide_mm:  routing of the float64 Ritz rotations and ortho projections
              to the exact int8 wide-rotation kernel (kernel K3,
              ``ops.slicing.sliced_wide_mm``): "auto" (the per-driver
              default of ``utils.mm._WIDE_DEFAULTS``, on for every driver),
              "always", "never".  The kernel runs on CUDA tensors only; on
              the CPU every mode is a plain matmul.
    sliced_mm: the integer-sliced long-contraction route: "always" sends
              every float64 product within the exact int32 budget to
              ``ops.slicing.sliced_mm`` / ``sliced_mmT`` / ``sliced_mTm``
              (before the wide route); "auto" and "never" are plain
              matmuls ("never" also turns the wide route off, as in the
              reference; "auto" is on only on a TPU there).
    """

    n_targ: int
    n_max: int
    max_iter: int = 100
    tol: float = 1e-8
    max_dav: int = 20
    shift: float = 0.0
    reduced_solver: str = "auto"
    verbose: bool = False
    wide_mm: str = "auto"
    sliced_mm: str = "auto"

    def __post_init__(self):
        if self.n_max < self.n_targ:
            raise ValueError("n_max must be >= n_targ")

    @property
    def dim_dav(self) -> int:
        return max(10, self.max_dav)

    @property
    def tol_max(self) -> float:
        return 10.0 * self.tol


@dataclasses.dataclass(frozen=True)
class SolverResult:
    """Result of a symmetric eigensolver.

    eig:  (n_max,) eigenvalues ascending (shift removed).
    evec: (n_max, n) eigenvector rows.
    ok:   True if the first n_targ roots converged.
    n_iter: iterations performed.
    n_matvec: operator applications, one per vector in each applied block.
    done: (n_max,) per-root converged flags (a contiguous prefix).
    rms_history/max_history/eig_history: (max_iter, n_max) tables.
    ortho_ok: False if any orthogonalization step failed to converge.
    """

    eig: torch.Tensor
    evec: torch.Tensor
    ok: bool
    n_iter: int
    n_matvec: int
    done: torch.Tensor
    rms_history: torch.Tensor
    max_history: torch.Tensor
    eig_history: torch.Tensor
    ortho_ok: bool


@dataclasses.dataclass(frozen=True)
class LRSolverResult:
    """Result of a Casida linear-response solver (``caslr``/``caslr_eff``).

    The fields are :class:`SolverResult`'s; ``evec`` rows are the paired
    vectors (Y, Z) of length 2n (under a sharding, ``[Y_local |
    Z_local]``, 2 n_local wide) and ``eig`` the excitation energies w,
    ascending.
    """

    eig: torch.Tensor
    evec: torch.Tensor
    ok: bool
    n_iter: int
    n_matvec: int
    done: torch.Tensor
    rms_history: torch.Tensor
    max_history: torch.Tensor
    eig_history: torch.Tensor
    ortho_ok: bool


@dataclasses.dataclass(frozen=True)
class NonsymResult:
    """Result of the two-sided nonsymmetric Davidson (``nonsym``).

    eig:    (n_max,) eigenvalues, ascending real parts (shift removed).
    evec_r / evec_l: (n_max, n) right / left eigenvector rows (zeros for
            the side a one-sided run does not compute); after a
            consecutive run evec_l @ evec_r^T = I.
    ok:     True if the first n_targ roots converged (on both sides, with
            matching eigenvalues, for the consecutive sides).
    n_iter / n_matvec: summed over the passes.
    done:   (n_max,) converged flags of the last pass.
    rms_history_r / max_history_r / rms_history_l / max_history_l:
            (max_iter, n_max) residual tables of each side's pass.
    eig_history: (max_iter, n_max) eigenvalues of the last pass.
    ortho_ok: as in :class:`SolverResult`.
    """

    eig: torch.Tensor
    evec_r: torch.Tensor
    evec_l: torch.Tensor
    ok: bool
    n_iter: int
    n_matvec: int
    done: torch.Tensor
    rms_history_r: torch.Tensor
    max_history_r: torch.Tensor
    rms_history_l: torch.Tensor
    max_history_l: torch.Tensor
    eig_history: torch.Tensor
    ortho_ok: bool
