"""Toy problems and callbacks (port of the parts of
``diaglib_tpu/problems.py`` the ported solvers use).

Everything is row-major: operator callbacks map ``x: (k, n) -> (k, n)``.
Random inputs come from ``torch.Generator`` streams, not JAX's: tests that
compare with the JAX package pass JAX's matrices over as numpy.
"""

from __future__ import annotations

import torch

__all__ = ["symm_matrix", "metric_matrix", "dense_matvec", "diag_precnd",
           "bsr_gen_problem"]


def symm_matrix(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """The Hilbert-like symmetric test matrix: a(i,i) = i+1,
    a(i,j) = 1/(i+j), 1-based."""
    i = torch.arange(1, n + 1, dtype=dtype, device=device)
    a = 1.0 / (i[:, None] + i[None, :])
    a.diagonal().copy_(i + 1.0)
    return a


def metric_matrix(n: int, generator: torch.Generator | None = None,
                  dtype=torch.float64, device=None) -> torch.Tensor:
    """Random SPD metric S = M^T M with M uniform in [0, 1)."""
    m = torch.rand((n, n), generator=generator, dtype=dtype, device=device)
    return m.T @ m


def bsr_gen_problem(n: int, block: int, blocks_per_row: int, seed: int,
                    metric_blocks_per_row: int = 4, na: int | None = None,
                    device=None):
    """Flagship-scale generalized eigenproblem A x = lambda B x on symmetric
    sliced BSR stores.

    A is ``random_bsr_spd(n, block, blocks_per_row)`` (separated low
    modes); B an independent diagonally dominant SPD operator from the
    same builder with ``metric_blocks_per_row`` blocks per row, milder
    off-diagonals (``off_scale=0.1``) and no low modes.  Both are float32
    BSR matrices sliced with ``slice_bsr_sym``; A's values come from seed
    ``seed``, B's from ``seed + 1``.  Returns the two stores ``(a, b)``.
    """
    from .ops.bsr import random_bsr_spd
    from .ops.bsr_sliced_sym import slice_bsr_sym

    a = slice_bsr_sym(random_bsr_spd(n, block, blocks_per_row, seed,
                                     dtype=torch.float32, device=device),
                      na=na)
    b = slice_bsr_sym(random_bsr_spd(n, block, metric_blocks_per_row,
                                     seed + 1, dtype=torch.float32,
                                     off_scale=0.1, n_low_modes=0,
                                     device=device), na=na)
    return a, b


def dense_matvec(a: torch.Tensor):
    """Row-block matvec closure for a dense matrix: ``x @ a.T``."""
    def mv(x):
        return x @ a.T

    return mv


def diag_precnd(diagonal: torch.Tensor, guard: float = 1.0e-5):
    """Shift-and-invert diagonal preconditioner (mprec):
    y_i = x_i / (d_i + fac) where |d_i + fac| > guard, else y_i = x_i."""
    def pc(fac, x):
        denom = diagonal + fac
        safe = denom.abs() > guard
        return torch.where(safe[None, :],
                           x / torch.where(safe, denom, 1.0), x)

    return pc
