"""Contractions of the solvers (port of ``diaglib_tpu/utils/mm.py``).

On the H100 float64 is native, so ``mm``/``mmT``/``mTm`` are plain matmuls
in the operands' dtype.  :func:`routing_for` checks the kernel-route
options of :class:`~diaglib_tpu_torch.types.SolverOptions`.
"""

from __future__ import annotations

import torch

__all__ = ["mm", "mmT", "mTm", "routing_for"]

_ROUTES = ("auto", "always", "never")


def routing_for(options) -> None:
    """Validate ``options.wide_mm`` / ``options.sliced_mm``: "auto" and
    "never" are plain matmuls; "always" needs a kernel not yet ported."""
    for name, kernel in (("wide_mm", "the wide-rotation kernel "
                          "(diaglib_tpu/ops/slicing.py::_wide_kernel)"),
                         ("sliced_mm", "the integer-sliced long-contraction "
                          "route (diaglib_tpu/ops/slicing.py::sliced_mm)")):
        mode = getattr(options, name)
        if mode not in _ROUTES:
            raise ValueError(f"{name} must be one of {_ROUTES}, got {mode!r}")
        if mode == "always":
            raise NotImplementedError(
                f"{name}='always' needs {kernel}, not yet ported to "
                "diaglib_tpu_torch")


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b."""
    return a @ b


def mmT(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T (Gram layout, contracting the last axes)."""
    return a @ b.T


def mTm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a.T @ b (contracting the first axes)."""
    return a.T @ b
