"""Contractions of the solvers (port of ``diaglib_tpu/utils/mm.py``).

On the H100 float64 is native, so ``mm``/``mmT``/``mTm`` are plain
matmuls in the operands' dtype, except on two routes, taken in the
reference's order:

* the sliced route (``sliced_mm="always"``): every float64 product whose
  contraction fits the exact int32 budget (``ops.slicing.fits_exact``,
  K < 2^17) goes to the exact integer-sliced ``sliced_mm`` /
  ``sliced_mmT`` / ``sliced_mTm``, on any device;
* the wide-rotation route: a float64 product on CUDA tensors with a small
  contraction and a wide output (a Ritz rotation or an ortho projection)
  goes to the exact integer-sliced kernel K3 (``ops.slicing.
  sliced_wide_mm``) when the route is on.

Routing rides :class:`~diaglib_tpu_torch.types.SolverOptions`: each solver
enters :func:`routing_for` around its run, and ``wide_mm="auto"`` resolves
to the per-driver default of ``_WIDE_DEFAULTS``, as in the reference.  A
bare call outside any solver keeps the route off ("auto" means off there).
The reference's TPU-only machinery (the x2 scaling and 4096-chunked scans
of emulated float64, the ``DIAGLIB_TPU_*`` environment overrides and the
bisection modes) is not carried.

Sharding: a solver given ``sharding=`` enters :class:`mm_sharding` beside
its routing.  Under it ``mmT``, which contracts over n, all-reduces its
small result; ``mm``/``mTm`` contract over rows and stay local; and
:func:`sum_n`, :func:`amax_n` and :func:`norm_n` take the block sums,
n-axis maxima and row norms over all ranks.  The reference gets the same
collectives from XLA's partitioner.  Without a sharding the helpers are
the plain expressions they replace.
"""

from __future__ import annotations

import torch

__all__ = ["mm", "mmT", "mTm", "mm_routing", "routing_for", "mm_sharding",
           "current_sharding", "global_n", "sum_n", "amax_n", "norm_n"]

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
# the VectorSharding in force: set by mm_sharding around a solver run
_SHARDING = [None]


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
    the driver's default."""
    for name in ("wide_mm", "sliced_mm"):
        mode = getattr(options, name)
        if mode not in _ROUTES:
            raise ValueError(f"{name} must be one of {_ROUTES}, got {mode!r}")
    wide = options.wide_mm
    if wide == "auto":
        wide = _WIDE_DEFAULTS.get(driver, "never")
    sliced = None if options.sliced_mm == "auto" else options.sliced_mm
    return mm_routing(wide=wide, sliced=sliced)


class mm_sharding:
    """Sharding context: under it the n-axis contractions and reductions
    of this module are all-reduced over ``sharding``'s group (None leaves
    them local)."""

    def __init__(self, sharding):
        self.sharding = sharding

    def __enter__(self):
        self.prev = _SHARDING[0]
        _SHARDING[0] = self.sharding
        return self

    def __exit__(self, *exc):
        _SHARDING[0] = self.prev


def current_sharding():
    """The VectorSharding in force, or None."""
    return _SHARDING[0]


def sum_n(x: torch.Tensor) -> torch.Tensor:
    """The sum of every element of the block x (its n axis included),
    over all ranks under a sharding."""
    s = x.sum()
    sh = _SHARDING[0]
    return s if sh is None else sh.sum(s)


def amax_n(x: torch.Tensor) -> torch.Tensor:
    """Maximum over the last (n) axis, over all ranks under a sharding."""
    s = x.amax(dim=-1)
    sh = _SHARDING[0]
    return s if sh is None else sh.max(s)


def norm_n(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norms of the rows of x (over n), over all ranks under a
    sharding: the square root of the all-reduced sums of squares."""
    sh = _SHARDING[0]
    if sh is None:
        return torch.linalg.norm(x, dim=-1)
    return torch.sqrt(sh.sum((x * x).sum(dim=-1)))


def global_n(n_local: int, sharding) -> int:
    """The global vector length of a solve whose blocks are ``n_local``
    wide: n_local itself, or the sharding's n (checked against it)."""
    if sharding is None:
        return n_local
    if sharding.n_local != n_local:
        raise ValueError(f"blocks are {n_local} wide but the sharding gives "
                         f"this rank {sharding.n_local} columns")
    return sharding.n


def _use_sliced(a: torch.Tensor, b: torch.Tensor, k: int) -> bool:
    """Whether a product of 2-D ``a`` and ``b`` contracting ``k`` goes to
    the exact sliced products: the route is "always", both operands are
    float64 and the contraction fits the exact int32 budget."""
    if _ROUTING["sliced"] != "always" or a.ndim != 2 or b.ndim != 2:
        return False
    from ..ops.slicing import fits_exact
    return (a.dtype == torch.float64 and b.dtype == torch.float64
            and fits_exact(k))


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
    if _use_sliced(a, b, a.shape[-1]):
        from ..ops.slicing import sliced_mm
        return sliced_mm(a, b)
    if (a.ndim == 2 and b.ndim == 2
            and _use_wide(a.dtype, a.device, a.shape[1], a.shape[0],
                          b.shape[1])):
        from ..ops.slicing import sliced_wide_mm
        return sliced_wide_mm(a, b)
    return a @ b


def mmT(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b.T (Gram layout, contracting the last axes); all-reduced over
    the ranks under a sharding."""
    if _use_sliced(a, b, a.shape[-1]):
        from ..ops.slicing import sliced_mmT
        out = sliced_mmT(a, b)
    else:
        out = a @ b.T
    sh = _SHARDING[0]
    return out if sh is None else sh.sum(out)


def mTm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a.T @ b (contracting the first axes)."""
    if _use_sliced(a, b, a.shape[0]):
        from ..ops.slicing import sliced_mTm
        return sliced_mTm(a, b)
    if (a.ndim == 2 and b.ndim == 2
            and _use_wide(a.dtype, a.device, a.shape[0], a.shape[1],
                          b.shape[1])):
        from ..ops.slicing import sliced_wide_mm
        return sliced_wide_mm(a.T, b)
    return a.T @ b
