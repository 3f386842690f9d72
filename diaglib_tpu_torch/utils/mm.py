"""Contractions of the solvers (port of ``diaglib_tpu/utils/mm.py``).

On the H100 float64 is native, so ``mm``/``mmT``/``mTm`` are plain
matmuls in the operands' dtype, except on the wide-rotation route: a
float64 product on CUDA tensors with a small contraction and a wide output
(a Ritz rotation or an ortho projection) goes to the exact integer-sliced
kernel K3 (``ops.slicing.sliced_wide_mm``) when the route is on.

Routing rides :class:`~diaglib_tpu_torch.types.SolverOptions`: each solver
enters :func:`routing_for` around its run, and ``wide_mm="auto"`` resolves
to the per-driver default of ``_WIDE_DEFAULTS``, as in the reference.  A
bare call outside any solver keeps the route off ("auto" means off there).
The reference's TPU-only machinery (the x2 scaling and 4096-chunked scans
of emulated float64, the ``DIAGLIB_TPU_*`` environment overrides and the
bisection modes) is not carried.
"""

from __future__ import annotations

import torch

__all__ = ["mm", "mmT", "mTm", "mm_routing", "routing_for"]

_ROUTES = ("auto", "always", "never")

# per-driver wide-kernel defaults for SolverOptions.wide_mm == "auto",
# the reference's table (diaglib_tpu/utils/mm.py _WIDE_DEFAULTS)
_WIDE_DEFAULTS = {
    "davidson": "always",
    "gen_david": "always",
    "caslr": "always",
    "caslr_eff": "always",
    "nonsym": "always",
    "lobpcg": "always",
}

# the route in force: set by mm_routing around a solver run; None = unset
_ROUTING = {"wide": None, "sliced": None}


class mm_routing:
    """Kernel-routing context (wide / sliced contraction paths).

    ``wide`` / ``sliced``: "always" | "never" | "auto" | None (= leave as
    is).  Solvers enter it through :func:`routing_for`.
    """

    def __init__(self, wide=None, sliced=None):
        self.wide, self.sliced = wide, sliced

    def __enter__(self):
        self.prev = dict(_ROUTING)
        if self.wide is not None:
            _ROUTING["wide"] = self.wide
        if self.sliced is not None:
            _ROUTING["sliced"] = self.sliced
        return self

    def __exit__(self, *exc):
        _ROUTING.clear()
        _ROUTING.update(self.prev)


def routing_for(options, driver: str) -> mm_routing:
    """Routing context for a solver ``driver`` ("davidson", "lobpcg", ...)
    from ``options.wide_mm`` / ``options.sliced_mm``; "auto" resolves to
    the driver's default.  ``sliced_mm="always"`` (the long-contraction
    route) is not ported yet and raises."""
    for name in ("wide_mm", "sliced_mm"):
        mode = getattr(options, name)
        if mode not in _ROUTES:
            raise ValueError(f"{name} must be one of {_ROUTES}, got {mode!r}")
    if options.sliced_mm == "always":
        raise NotImplementedError(
            "sliced_mm='always' needs the integer-sliced long-contraction "
            "route (diaglib_tpu/ops/slicing.py::sliced_mm), not yet ported "
            "to diaglib_tpu_torch")
    wide = options.wide_mm
    if wide == "auto":
        wide = _WIDE_DEFAULTS.get(driver, "never")
    sliced = None if options.sliced_mm == "auto" else options.sliced_mm
    return mm_routing(wide=wide, sliced=sliced)


def _use_wide(dtype, device, k: int, m: int, n: int) -> bool:
    """Whether ``(m, k) @ (k, n)`` goes to kernel K3: the route is
    "always", the operands are float64 CUDA tensors (the reference asks for
    the TPU backend here), and the shape is the rotation shape the kernel
    is for: k <= 4096, m <= 1024, n >= 8192, n % 256 == 0, within the
    exact-int32 budget."""
    if _ROUTING["sliced"] == "never" or _ROUTING["wide"] != "always":
        return False
    use = (dtype == torch.float64 and torch.device(device).type == "cuda"
           and k <= 4096 and m <= 1024 and n >= 8192 and n % 256 == 0)
    if use:
        from ..ops.slicing import wide_feasible
        use = wide_feasible(m, k, n)
    return use


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b."""
    if (a.ndim == 2 and b.ndim == 2
            and _use_wide(a.dtype, a.device, a.shape[1], a.shape[0],
                          b.shape[1])):
        from ..ops.slicing import sliced_wide_mm
        return sliced_wide_mm(a, b)
    return a @ b


def mmT(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T (Gram layout, contracting the last axes)."""
    return a @ b.T


def mTm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a.T @ b (contracting the first axes)."""
    if (a.ndim == 2 and b.ndim == 2
            and _use_wide(a.dtype, a.device, a.shape[0], a.shape[1],
                          b.shape[1])):
        from ..ops.slicing import sliced_wide_mm
        return sliced_wide_mm(a.T, b)
    return a.T @ b
