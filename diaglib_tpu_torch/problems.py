"""Toy problems and callbacks (port of the parts of
``diaglib_tpu/problems.py`` the Davidson slice uses).

Everything is row-major: operator callbacks map ``x: (k, n) -> (k, n)``.
"""

from __future__ import annotations

import torch

__all__ = ["symm_matrix", "dense_matvec", "diag_precnd"]


def symm_matrix(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """The Hilbert-like symmetric test matrix: a(i,i) = i+1,
    a(i,j) = 1/(i+j), 1-based."""
    i = torch.arange(1, n + 1, dtype=dtype, device=device)
    a = 1.0 / (i[:, None] + i[None, :])
    a.diagonal().copy_(i + 1.0)
    return a


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
