"""Convergence tables, timing reports and the live progress line (port of
``diaglib_tpu/reporting.py``).

The solvers return their whole convergence history (``eig_history``,
``rms_history``, ``max_history``), so the reference's verbose table
(diaglib.f90 formats 1030/1040) is rendered after the solve, in the JAX
package's exact format.  With ``SolverOptions.verbose`` each solver also
prints one line an iteration through :func:`inflight_progress`; the loop
is eager, so it prints directly.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ._device import host_array

__all__ = ["convergence_table", "print_convergence_table", "timing_report",
           "inflight_progress"]


def convergence_table(result, n_targ: int, solver: str = "Davidson-Liu",
                      tol: float = None) -> str:
    """Render the reference's verbose iteration table (format 1030/1040)."""
    eig_h = host_array(result.eig_history)
    rms_h = host_array(result.rms_history)
    max_h = host_array(result.max_history)
    n_iter = int(result.n_iter)
    lines = []
    head = f"{solver} iterations"
    if tol is not None:
        head += f" (tol={tol:10.2e})"
    bar = "-" * 66
    lines += [f"    {head}:", f"    {bar}",
              "       iter  root              eigenvalue         rms         max ok",
              f"    {bar}"]
    for it in range(n_iter):
        for i in range(n_targ):
            rms, mx = rms_h[it, i], max_h[it, i]
            ok = rms < (tol or np.inf) and mx < 10 * (tol or np.inf)
            lines.append(
                f"       {it+1:4d}  {i+1:4d}{eig_h[it, i]:24.12f}"
                f"{rms:12.4e}{mx:12.4e}  {'T' if ok else 'F'}")
        lines.append("")
    return "\n".join(lines)


def print_convergence_table(result, n_targ: int, solver: str = "Davidson-Liu",
                            tol: float = None, file=None):
    print(convergence_table(result, n_targ, solver, tol),
          file=file or sys.stdout)


def timing_report(solver: str, wall_s: float, n_iter: int, n_matvec: int,
                  file=None, includes_compile: bool = False):
    """Timing summary in the spirit of diaglib.f90:1835-1841: one wall
    figure and the counters.  Set ``includes_compile`` when the timed call
    was a cold first run, which includes the kernels' build and warm-up
    (the name is the JAX package's, whose first call compiles)."""
    file = file or sys.stdout
    note = "  (includes kernel build and warm-up)" if includes_compile else ""
    print(f"  timings for {solver} (wall):", file=file)
    print(f"    total:                {wall_s:12.4f} s{note}", file=file)
    print(f"    iterations:           {n_iter:12d}", file=file)
    print(f"    operator applications:{n_matvec:12d}", file=file)


def _finite_max(x: torch.Tensor) -> float:
    """The maximum over the finite entries (0 where none is)."""
    return float(torch.where(torch.isfinite(x), x, 0.0).max())


def inflight_progress(name: str, it, n_act, eig, rms, rmx):
    """One live progress line an iteration (``SolverOptions.verbose``), in
    the JAX package's format: the first eigenvalue, and the largest finite
    rms and max residual over all roots."""
    print(f"{name} it={int(it)} n_act={int(n_act)} "
          f"eig0={float(eig[0]):.12e} rms={_finite_max(rms):.3e} "
          f"max={_finite_max(rmx):.3e}", flush=True)
