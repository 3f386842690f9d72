"""Global configuration helpers (port of ``diaglib_tpu/config.py``).

The reference library (diaglib.f90) is hard-wired to double precision;
this package is dtype-polymorphic instead: every solver works in the dtype
of its inputs and derives its machine-epsilon thresholds (e.g. tol_ortho =
2*eps, diaglib.f90:151) from that dtype.  :func:`enable_x64` sets torch's
default float dtype, which is global to the process: no function of the
package calls it for the caller, and a caller that sets it for a while
restores it after.  The JAX package's ``enable_persistent_cache`` (a cache
of XLA compiles) has no counterpart here.
"""

from __future__ import annotations

import torch

__all__ = ["enable_x64", "default_dtype", "eps", "tol_ortho"]


def enable_x64(enable: bool = True) -> None:
    """Make float64 torch's default float dtype (float32 when False)."""
    torch.set_default_dtype(torch.float64 if enable else torch.float32)


def default_dtype() -> torch.dtype:
    """torch's default float dtype: float64 after :func:`enable_x64`."""
    return torch.get_default_dtype()


def eps(dtype) -> float:
    """Machine epsilon of ``dtype`` (Fortran ``epsilon(one)``)."""
    return float(torch.finfo(dtype).eps)


def tol_ortho(dtype) -> float:
    """Orthogonalization threshold, ``2 * epsilon`` (diaglib.f90:151)."""
    return 2.0 * eps(dtype)
