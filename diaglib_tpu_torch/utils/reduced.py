"""The small dense reduced solves (port of ``diaglib_tpu/utils/reduced.py``).

``method`` everywhere:

* "device": ``torch.linalg`` on the tensors' device;
* "jacobi": the cyclic-Jacobi solvers of ``utils/jacobi.py``, eager sweeps
  on the tensors' device;
* "host": scipy's LAPACK on a float64 CPU copy, the result returned on the
  input's device and dtype;
* "auto": "device" (the reference's "auto" picks "jacobi" only on a TPU).

``v0`` and ``off_tol`` (a warm-start basis and a relaxed off-norm target)
serve the Jacobi route; the exact routes ignore them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import jacobi as _jacobi
from .mm import mm, mTm

__all__ = ["resolve", "eigh", "svd", "cholesky", "eigh_gen"]

_METHODS = ("auto", "device", "host", "jacobi")


def resolve(method: str) -> str:
    if method not in _METHODS:
        raise ValueError(
            f"reduced_solver must be one of {_METHODS}, got {method!r}")
    return "device" if method == "auto" else method


def _host(a: torch.Tensor) -> np.ndarray:
    return a.detach().to("cpu", torch.float64).numpy()


def _back(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(like.device,
                                                        like.dtype)


def eigh(a: torch.Tensor, method: str = "device", v0=None, off_tol=0.0):
    """Eigenvalues ascending and eigenvectors of symmetric ``a``."""
    method = resolve(method)
    if method == "device":
        return torch.linalg.eigh(a)
    if method == "jacobi":
        return _jacobi.jacobi_eigh(a, v0=v0, off_tol=off_tol)
    import scipy.linalg

    w, v = scipy.linalg.eigh(_host(a))
    return _back(w, a), _back(v, a)


def svd(a: torch.Tensor, method: str = "device", off_tol=0.0):
    """Full SVD ``(u, s, vt)`` of ``a``, singular values descending.  The
    Jacobi route is the one-sided (Hestenes) form."""
    method = resolve(method)
    if method == "device":
        return torch.linalg.svd(a)
    if method == "jacobi":
        return _jacobi.jacobi_svd_onesided(a, off_tol=off_tol)
    import scipy.linalg

    u, s, vt = scipy.linalg.svd(_host(a))
    return _back(u, a), _back(s, a), _back(vt, a)


def cholesky(a: torch.Tensor, method: str = "device") -> torch.Tensor:
    """Lower Cholesky factor of SPD ``a``; a matrix that is not positive
    definite gives NaN, not an exception (the contract of the JAX
    package's ``jnp.linalg.cholesky``, so that a caller can test the
    result and take a rescue path): in the whole lower triangle (zeros
    above) on the device and Jacobi routes, everywhere on the host route
    (LAPACK dpotrf's ``info``)."""
    if resolve(method) == "host":
        import scipy.linalg

        c, info = scipy.linalg.lapack.dpotrf(_host(a), lower=1, clean=1)
        if info != 0:
            c = np.full_like(c, np.nan)
        return _back(c, a)
    lo, info = torch.linalg.cholesky_ex(a)
    return torch.where((info != 0)[..., None, None],
                       torch.tril(torch.full_like(lo, float("nan"))), lo)


def eigh_gen(s: torch.Tensor, a: torch.Tensor, method: str = "device",
             off_tol=0.0):
    """The symmetric pencil ``s x = e a x`` with ``a`` SPD: eigenvalues
    ascending and eigenvectors normalized as LAPACK's dsygv (itype 1)
    does, ``x^T a x = I``.  The Jacobi route whitens without a Cholesky
    (a = V D V^T, a^-1/2 = V D^-1/2 V^T), ``off_tol`` relaxing both of its
    eigensolves."""
    method = resolve(method)
    if method == "device":
        lo = cholesky(a)
        tmp = torch.linalg.solve_triangular(lo, s, upper=False)
        std = torch.linalg.solve_triangular(lo, tmp.mT, upper=False)
        e, y = torch.linalg.eigh(0.5 * (std + std.mT))
        return e, torch.linalg.solve_triangular(lo.mT, y, upper=True)
    if method == "jacobi":
        d, v = _jacobi.jacobi_eigh(a, off_tol=off_tol)
        inv_sqrt = 1.0 / torch.sqrt(
            torch.clamp(d, min=torch.finfo(a.dtype).tiny))
        w_half = v * inv_sqrt[None, :]
        std = mTm(w_half, mm(s, w_half))
        e, y = _jacobi.jacobi_eigh(0.5 * (std + std.T), off_tol=off_tol)
        return e, mm(w_half, y)
    import scipy.linalg

    w, x = scipy.linalg.eigh(_host(s), _host(a))
    return _back(w, a), _back(x, a)
