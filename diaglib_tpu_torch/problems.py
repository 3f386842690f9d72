"""Toy problems and callbacks (port of the parts of
``diaglib_tpu/problems.py`` the ported solvers use).

Everything is row-major: operator callbacks map ``x: (k, n) -> (k, n)``.
Random inputs come from ``torch.Generator`` streams, not JAX's: tests that
compare with the JAX package pass JAX's matrices over as numpy.  The
generators make their tensors on the CUDA device unless ``device`` names
another (``device="cpu"`` on a machine without a card).
"""

from __future__ import annotations

import math

import torch

from ._device import resolve_device
from .utils.graphs import replayable

__all__ = ["symm_matrix", "metric_matrix", "casida_blocks", "nonsym_matrix",
           "dense_matvec", "diag_precnd", "bsr_casida_tdscf",
           "casida_tdscf_ops", "bsr_gen_problem", "bsr_nonsym_similarity",
           "nonsym_similarity_ops", "nonsym_similarity_sided", "lrprec_eff",
           "lrprec_std"]


def symm_matrix(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """The Hilbert-like symmetric test matrix: a(i,i) = i+1,
    a(i,j) = 1/(i+j), 1-based."""
    i = torch.arange(1, n + 1, dtype=dtype, device=resolve_device(device))
    a = 1.0 / (i[:, None] + i[None, :])
    a.diagonal().copy_(i + 1.0)
    return a


def metric_matrix(n: int, generator: torch.Generator | None = None,
                  dtype=torch.float64, device=None) -> torch.Tensor:
    """Random SPD metric S = M^T M with M uniform in [0, 1)."""
    m = torch.rand((n, n), generator=generator, dtype=dtype,
                   device=resolve_device(device))
    return m.T @ m


def casida_blocks(n: int, generator: torch.Generator | None = None,
                  tdscf: bool = False, dtype=torch.float64,
                  device=None) -> dict:
    """Casida test blocks of the reference's test_caslr.

    A+B has diagonal 5+i and off-diagonal 0.2/(i+j) (1-based); A-B is
    diagonal, 2+i (the reference's loop overwrites its off-diagonals, and
    the converged data is what is reproduced); sigma = I + M^T M and
    delta = R - R^T with M, then R, uniform in [0, 1) from ``generator``.
    With ``tdscf=True``, sigma = I and delta = 0 (test_scflr) and nothing
    is drawn.  Returns a dict with apb, amb, sigma, delta, aa, bb, spd,
    smd.
    """
    dev = resolve_device(device)
    i = torch.arange(1, n + 1, dtype=dtype, device=dev)
    apb = 0.2 / (i[:, None] + i[None, :])
    apb.diagonal().copy_(5.0 + i)
    amb = torch.diag(2.0 + i)
    if tdscf:
        sigma = torch.eye(n, dtype=dtype, device=dev)
        delta = torch.zeros((n, n), dtype=dtype, device=dev)
    else:
        m = torch.rand((n, n), generator=generator, dtype=dtype, device=dev)
        sigma = m.T @ m + torch.eye(n, dtype=dtype, device=dev)
        r = torch.rand((n, n), generator=generator, dtype=dtype, device=dev)
        delta = r - r.T
    return dict(apb=apb, amb=amb, sigma=sigma, delta=delta,
                aa=0.5 * (apb + amb), bb=0.5 * (apb - amb),
                spd=sigma + delta, smd=sigma - delta)


def nonsym_matrix(n: int, generator: torch.Generator | None = None,
                  variant: int = 4, dtype=torch.float64,
                  device=None) -> torch.Tensor:
    """Nonsymmetric test matrices of the reference's test_nonsym.

    variant 1: P diag(3..n+2) P^{-1}, P = T^T T SPD from shifted random T
      (real spectrum {i+2});
    variant 2: symmetric + random perturbation in [0, 0.01] with zero
      diagonal;
    variant 3: plain symmetric (``symm_matrix``);
    variant 4: similarity-transformed symmetric A = e^{-T} S e^{T} with
      random T scaled to ||T||_F = 0.01 (the reference's default) — real
      spectrum equal to eigh(S).
    Random values come from ``generator`` (uniform in [0, 1)).
    """
    dev = resolve_device(device)
    if variant == 3:
        return symm_matrix(n, dtype, dev)

    def rand():
        return torch.rand((n, n), generator=generator, dtype=dtype,
                          device=dev)

    if variant == 1:
        t = rand() + torch.diag(100.0 + torch.arange(1, n + 1, dtype=dtype,
                                                     device=dev))
        p = t.T @ t
        d = torch.arange(1, n + 1, dtype=dtype, device=dev) + 2.0
        # A = P diag(d) P^{-1}, P SPD: a Cholesky solve of (P D)^T
        cf = torch.linalg.cholesky(p)
        return torch.cholesky_solve((p * d[None, :]).T, cf).T
    if variant == 2:
        pert = 0.01 * rand()
        pert = pert - torch.diag(torch.diagonal(pert))
        return symm_matrix(n, dtype, dev) + pert
    if variant == 4:
        s = symm_matrix(n, dtype, dev)
        t = rand()
        t = t * (0.01 / torch.linalg.norm(t))
        return _matexp_series(-t) @ s @ _matexp_series(t)
    raise ValueError(f"unsupported nonsym variant {variant}")


def _matexp_series(t: torch.Tensor, terms: int = 12) -> torch.Tensor:
    """e^T by the truncated Taylor series, like the reference's ``matexp``.
    With ||T|| = 0.01, 12 terms truncate at ~1e-33."""
    n = t.shape[0]
    acc = torch.eye(n, dtype=t.dtype, device=t.device)
    term = torch.eye(n, dtype=t.dtype, device=t.device)
    for k in range(1, terms + 1):
        term = (term @ t) / k
        acc = acc + term
    return acc


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

    dev = resolve_device(device)
    a = slice_bsr_sym(random_bsr_spd(n, block, blocks_per_row, seed,
                                     dtype=torch.float32, device=dev),
                      na=na)
    b = slice_bsr_sym(random_bsr_spd(n, block, metric_blocks_per_row,
                                     seed + 1, dtype=torch.float32,
                                     off_scale=0.1, n_low_modes=0,
                                     device=dev), na=na)
    return a, b


def _band_bsr(n: int, block: int, seed: int, scale: float,
              dtype=torch.float32, device=None):
    """One-off-diagonal-band BSR matrix (block row r holds block
    (r, r+1 mod nbr)) with iid normal blocks from a ``torch.Generator``
    seeded with ``seed``, scaled to total Frobenius norm ~``scale``."""
    from .ops.bsr import BSRMatrix

    dev = resolve_device(device)
    nbr = n // block
    c = scale / math.sqrt(nbr * block * block)
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks = c * torch.randn((nbr, block, block), generator=gen, dtype=dtype,
                             device=dev)
    rows = torch.arange(nbr, dtype=torch.int32, device=dev)
    return BSRMatrix(blocks_t=blocks.transpose(1, 2).contiguous(), rows=rows,
                     cols=(rows + 1) % nbr, row_start=rows.clone(), n=n,
                     block=block)


def _bsr_transpose_band(t):
    """Transpose of a one-band BSR from :func:`_band_bsr`: entry (r, r+1)
    becomes (r+1, r), reordered so that rows stay ascending."""
    from .ops.bsr import BSRMatrix

    nbr = t.n // t.block
    order = torch.argsort((t.rows.long() + 1) % nbr)
    rows = torch.arange(nbr, dtype=torch.int32, device=t.rows.device)
    return BSRMatrix(blocks_t=t.blocks_t[order].transpose(1, 2).contiguous(),
                     rows=rows, cols=(rows - 1) % nbr, row_start=rows.clone(),
                     n=t.n, block=t.block)


def bsr_nonsym_similarity(n: int, block: int, blocks_per_row: int, seed: int,
                          t_scale: float = 0.01, na: int | None = None,
                          device=None):
    """Flagship-scale nonsymmetric problem: a similarity-transformed
    symmetric operator, matrix-free (the reference's variant-4
    construction at production scale).

    R = E_- S E_+ with S the symmetric sliced store of
    ``random_bsr_spd(n, block, blocks_per_row, seed)``, E_± the order-4
    truncated series of e^{±T}, and T the one-band BSR of
    :func:`_band_bsr` from seed ``seed + 1``, scaled to ||T||_F ~
    ``t_scale``.  E_- is the series of -T, not the inverse of E_+, so R is
    similar to S only up to O(||T||^5/120) ~ 1e-19: its spectrum is real
    and equals eig(S) to float64 precision.  The left operator is the
    exact transpose R^T = E_+^T S E_-^T, applied through the general store
    of T^T.

    Returns ``(stores, diagonal)``: ``stores = (s, t, tt)``, a
    :class:`~.ops.bsr_sliced_sym.SymSlicedBSR` and two
    :class:`~.ops.bsr_sliced.SlicedBSR`, and S's diagonal for the
    preconditioner (diag(R) = diag(S) + O(||T||)).
    """
    from .ops.bsr import random_bsr_spd
    from .ops.bsr_sliced import slice_bsr
    from .ops.bsr_sliced_sym import slice_bsr_sym

    dev = resolve_device(device)
    s = slice_bsr_sym(random_bsr_spd(n, block, blocks_per_row, seed,
                                     dtype=torch.float32, device=dev), na=na)
    t = _band_bsr(n, block, seed + 1, t_scale, device=dev)
    st = slice_bsr(t, na=na)
    stt = slice_bsr(_bsr_transpose_band(t), na=na)
    return (s, st, stt), s.diagonal


def _exp_apply(apply_t, x, sign, terms):
    """E x for E the order-``terms`` series of e^{sign T}, T by rows."""
    term, acc = x, x
    for j in range(1, terms + 1):
        term = apply_t(term) * (sign / j)
        acc = acc + term
    return acc


def nonsym_similarity_ops(stores, dtype=torch.float64, terms: int = 4):
    """(matvec, matvec_l) closures over the similarity stores at a tier:
    R x = E_- S E_+ x and R^T x = E_+^T S E_-^T x, rowwise.  ``terms`` = 4
    keeps the e^{±T} truncation at ||T||^5/120 ~ 1e-19 for ||T|| = 0.01."""
    from .ops.bsr_sliced import sliced_bsr_matvec
    from .ops.bsr_sliced_sym import sliced_matvec_any

    s, st, stt = stores
    smv = sliced_matvec_any(s, dtype=dtype)
    tmv = sliced_bsr_matvec(st, dtype=dtype)
    ttmv = sliced_bsr_matvec(stt, dtype=dtype)

    def mv(x):
        return _exp_apply(tmv, smv(_exp_apply(tmv, x, 1.0, terms)), -1.0,
                          terms)

    def mv_l(x):
        return _exp_apply(ttmv, smv(_exp_apply(ttmv, x, -1.0, terms)), 1.0,
                          terms)

    return mv, mv_l


def nonsym_similarity_sided(s_store, t_store, sign: float,
                            dtype=torch.float64, terms: int = 4):
    """One matvec closure for either side: ``t_store`` is the store of T
    with ``sign`` +1 (the right operator R) or of T^T with ``sign`` -1 (the
    left operator R^T).  The same computation as
    :func:`nonsym_similarity_ops`."""
    from .ops.bsr_sliced import sliced_bsr_matvec
    from .ops.bsr_sliced_sym import sliced_matvec_any

    smv = sliced_matvec_any(s_store, dtype=dtype)
    tmv = sliced_bsr_matvec(t_store, dtype=dtype)
    sign = float(sign)

    def mv(x):
        return _exp_apply(tmv, smv(_exp_apply(tmv, x, sign, terms)), -sign,
                          terms)

    return mv


def dense_matvec(a: torch.Tensor):
    """Row-block matvec closure for a dense matrix: ``x @ a.T``."""
    def mv(x):
        return x @ a.T

    return replayable(mv)


def diag_precnd(diagonal: torch.Tensor, guard: float = 1.0e-5):
    """Shift-and-invert diagonal preconditioner (mprec):
    y_i = x_i / (d_i + fac) where |d_i + fac| > guard, else y_i = x_i."""
    def pc(fac, x):
        denom = diagonal + fac
        safe = denom.abs() > guard
        return torch.where(safe[None, :],
                           x / torch.where(safe, denom, 1.0), x)

    return replayable(pc)


def _guard_denom(denom: torch.Tensor, scale: torch.Tensor,
                 rel: float = 1.0e-5) -> torch.Tensor:
    """Clamp a preconditioner denominator away from zero, relative to the
    row's magnitude ``scale`` (the mprec guard extended to the paired
    preconditioners): a row resonant with the current root would
    otherwise give a huge expansion vector nearly parallel to others,
    which breaks the metric Cholesky downstream."""
    floor = rel * torch.clamp(scale, min=1.0)
    return torch.where(denom.abs() < floor,
                       torch.where(denom < 0.0, -floor, floor), denom)


def lrprec_std(aa_diag: torch.Tensor, sigma_diag: torch.Tensor):
    """Paired preconditioner of ``caslr`` (the reference's lrprec_1, called
    with fac = w): yp = -(a xp + f s xm) / (a^2 - f^2 s^2), ym the same
    with xp and xm swapped."""
    a, sg = aa_diag, sigma_diag

    def pc(fac, xp, xm):
        denom = a * a - fac * fac * sg * sg
        denom = _guard_denom(denom, a * a + fac * fac * sg * sg)
        yp = -(a * xp + fac * sg * xm) / denom
        ym = -(a * xm + fac * sg * xp) / denom
        return yp, ym

    return pc


def lrprec_eff(aa_diag: torch.Tensor, sigma_diag: torch.Tensor):
    """Paired preconditioner of ``caslr_eff`` (the reference's lrprec_2,
    called with fac = 1/w): denom = f^2 a^2 - s^2, yp = (f a xp + s xm) /
    denom, ym the same with xp and xm swapped."""
    a, sg = aa_diag, sigma_diag

    def pc(fac, xp, xm):
        denom = fac * fac * a * a - sg * sg
        denom = _guard_denom(denom, fac * fac * a * a + sg * sg)
        yp = (fac * a * xp + sg * xm) / denom
        ym = (fac * a * xm + sg * xp) / denom
        return yp, ym

    return pc


def bsr_casida_tdscf(n: int, block: int, blocks_per_row: int, seed: int,
                     na: int | None = None, device=None):
    """Flagship-scale Casida problem on symmetric sliced BSR stores.

    TD-SCF structure (sigma = I, delta = 0, so spd = smd = identity): the
    heavy operators are A+B and A-B, both ``random_bsr_spd(n, block,
    blocks_per_row, seed)`` float32 matrices with ``off_scale`` 0.3 and
    0.15.  The same seed gives them the same sparsity pattern and the same
    separated low rows, so the low modes of the product spectrum sit on
    rows the paired diagonal preconditioner resolves.  Each is sliced
    with ``slice_bsr_sym``; one store serves both tiers of a ladder.
    Built on the CUDA device unless ``device`` names another.

    Returns ``(ops_lo, ops_hi, diag_aa, (apb, amb))``: the float32 and
    float64 :class:`~diaglib_tpu_torch.types.LROps` tiers (with
    ``lrprec_eff``), the averaged diagonal (A+B + A-B)/2 and the two
    stores.
    """
    from .ops.bsr import random_bsr_spd
    from .ops.bsr_sliced_sym import slice_bsr_sym

    dev = resolve_device(device)
    apb, amb = (slice_bsr_sym(random_bsr_spd(n, block, blocks_per_row, seed,
                                             dtype=torch.float32,
                                             off_scale=scale, device=dev),
                              na=na) for scale in (0.3, 0.15))
    ops_lo, ops_hi = casida_tdscf_ops(apb, amb)
    return ops_lo, ops_hi, 0.5 * (apb.diagonal + amb.diagonal), (apb, amb)


def casida_tdscf_ops(apb, amb, prec: str = "eff"):
    """``(ops_lo, ops_hi)`` LROps tiers over two sliced stores (either
    flavor) of A+B and A-B, TD-SCF structure: ``spdmul`` and ``smdmul``
    are the identity, and the preconditioner works on diag_aa = (diag(A+B)
    + diag(A-B))/2 with unit sigma, in float32 for the float32 tier.
    ``prec``: "eff" pairs the tiers with ``lrprec_eff`` (for
    ``caslr_eff``), "std" with ``lrprec_std`` (for ``caslr``)."""
    from .ops.bsr_sliced_sym import sliced_matvec_any
    from .types import LROps

    if prec not in ("eff", "std"):
        raise ValueError(f"prec must be 'eff' or 'std', got {prec!r}")
    diag_aa = 0.5 * (apb.diagonal + amb.diagonal)
    make_prec = lrprec_eff if prec == "eff" else lrprec_std

    def ident(x):
        return x

    def tier(dtype):
        return LROps(
            apbmul=sliced_matvec_any(apb, dtype=dtype),
            ambmul=sliced_matvec_any(amb, dtype=dtype),
            spdmul=ident, smdmul=ident,
            lrprec=make_prec(diag_aa.to(dtype), torch.ones_like(
                diag_aa, dtype=dtype)))

    return tier(torch.float32), tier(torch.float64)
