"""The small dense reduced solves (port of the "device" route of
``diaglib_tpu/utils/reduced.py``).

``method``: "auto" and "device" run ``torch.linalg`` on the tensors'
device; "host" (LAPACK through the host) and "jacobi" (the on-device
Jacobi kernels) are not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["resolve", "eigh", "svd"]

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
