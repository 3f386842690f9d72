"""The small dense reduced solves (port of the "device" route of
``diaglib_tpu/utils/reduced.py``).

``method``: "auto" and "device" run ``torch.linalg`` on the tensors'
device; "host" (LAPACK through the host) and "jacobi" (the on-device
Jacobi kernels) are not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["resolve", "eigh", "svd", "cholesky", "eigh_gen"]

_METHODS = ("auto", "device", "host", "jacobi")


def resolve(method: str) -> str:
    if method not in _METHODS:
        raise ValueError(
            f"reduced_solver must be one of {_METHODS}, got {method!r}")
    if method in ("host", "jacobi"):
        raise NotImplementedError(
            f"reduced_solver={method!r} is not ported to diaglib_tpu_torch "
            "yet; use 'auto' or 'device'")
    return "device"


def eigh(a: torch.Tensor, method: str = "device"):
    """Eigenvalues ascending and eigenvectors of symmetric ``a``."""
    resolve(method)
    return torch.linalg.eigh(a)


def svd(a: torch.Tensor, method: str = "device"):
    """Full SVD ``(u, s, vt)`` of ``a``, singular values descending."""
    resolve(method)
    return torch.linalg.svd(a)


def cholesky(a: torch.Tensor, method: str = "device") -> torch.Tensor:
    """Lower Cholesky factor of SPD ``a``; a matrix that is not positive
    definite gives NaN in the whole lower triangle (zeros above), not an
    exception: the contract of the JAX package's ``jnp.linalg.cholesky``,
    so that a caller can test the result and take a rescue path."""
    resolve(method)
    lo, info = torch.linalg.cholesky_ex(a)
    return torch.where((info != 0)[..., None, None],
                       torch.tril(torch.full_like(lo, float("nan"))), lo)


def eigh_gen(s: torch.Tensor, a: torch.Tensor, method: str = "device"):
    """The symmetric pencil ``s x = e a x`` with ``a`` SPD: eigenvalues
    ascending and eigenvectors normalized as LAPACK's dsygv (itype 1)
    does, ``x^T a x = I``."""
    resolve(method)
    lo = cholesky(a)
    tmp = torch.linalg.solve_triangular(lo, s, upper=False)
    std = torch.linalg.solve_triangular(lo, tmp.mT, upper=False)
    e, y = torch.linalg.eigh(0.5 * (std + std.mT))
    return e, torch.linalg.solve_triangular(lo.mT, y, upper=True)
