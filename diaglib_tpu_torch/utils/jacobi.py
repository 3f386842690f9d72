"""Symmetric eigensolver and SVDs by cyclic Jacobi (port of
``diaglib_tpu/utils/jacobi.py``): the ``reduced_solver="jacobi"`` route.

Brent-Luk parallel ordering: in each round, row i is paired with row
i + L/2, all L/2 disjoint rotations are applied at once by a handful of
batched tensor ops over the two halves of the matrix, and the tournament
then rotates the data layout (top half becomes [t0, b0, t1..t_{L/2-2}],
bottom half [b1..b_{L/2-1}, t_{L/2-1}]), fused into the concatenation of
the rotated halves.  A sweep is L-1 rounds.  The stop test is the
reference's: the off-diagonal norm below ``max(eps, off_tol) *
max(||A||, 1)``, or a plateau once in the quadratic regime, or the sweep
cap.  The reference traces it inside its ``while_loop``; eager torch reads
it on the host, once a sweep.

float64 input with ``mixed_precision`` (the default) runs the bulk of the
sweeps in float32, re-orthonormalizes the float32 basis with two polar
steps and finishes with float64 sweeps from it, as the reference does (its
iteration counts depend on this).  The SVD is the Jacobi eigensolve of the
augmented matrix [[0, A^T], [A, 0]] (:func:`jacobi_svd`) or one-sided
Hestenes rotations of A's columns (:func:`jacobi_svd_onesided`).
"""

from __future__ import annotations

import math

import torch

from .mm import mm, mTm

__all__ = ["jacobi_eigh", "jacobi_svd", "jacobi_svd_onesided",
           "rank_argsort"]


def rank_argsort(w: torch.Tensor, descending: bool = False) -> torch.Tensor:
    """Stable argsort of a 1-D tensor: ties keep their index order, in
    both directions (the reference's order; it builds it from an O(L^2)
    comparison matrix only because its compiler needs that)."""
    return torch.sort(w, descending=descending, stable=True).indices


def tournament(top: torch.Tensor, bot: torch.Tensor,
               axis: int) -> torch.Tensor:
    """The two rotated halves, concatenated along ``axis`` in the next
    round's Brent-Luk layout."""
    L2 = top.shape[axis]
    if L2 == 1:         # one pair: the tournament is trivial
        return torch.cat([top, bot], dim=axis)
    return torch.cat([top.narrow(axis, 0, 1), bot.narrow(axis, 0, 1),
                      top.narrow(axis, 1, L2 - 2),
                      bot.narrow(axis, 1, L2 - 1),
                      top.narrow(axis, L2 - 1, 1)], dim=axis)


def _halves(x: torch.Tensor, c: torch.Tensor, axis: int):
    """x's two halves along ``axis`` and a broadcaster of per-pair
    coefficients onto them."""
    L2 = x.shape[axis] // 2
    p, q = x.narrow(axis, 0, L2), x.narrow(axis, L2, L2)
    return p, q, (c[:, None] if axis == 0 else c[None, :])


def _rotate_permute(x, c, s, axis):
    """Rotate every pair (i, i + L/2) along ``axis`` by (c, s), then apply
    the tournament permutation."""
    p, q, cb = _halves(x, c, axis)
    sb = s[:, None] if axis == 0 else s[None, :]
    return tournament(cb * p - sb * q, sb * p + cb * q, axis)


def _rotation(app, aqq, apq2, small):
    """(c, s) of the rotations that annihilate the pivots; ``apq2`` is
    twice the off-diagonal pivot, ``small`` the pairs left alone."""
    one = torch.ones((), dtype=app.dtype, device=app.device)
    tau = (aqq - app) / torch.where(small, one, apq2)
    sgn = torch.where(tau >= 0.0, one, -one)      # sign(0) must be +1 here
    t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _as_dtype(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


def _jacobi_sweeps(a: torch.Tensor, v: torch.Tensor, max_sweeps: int,
                   off_tol=0.0):
    """Sweeps until the off-diagonal norm reaches ``max(eps, off_tol) *
    max(||A||, 1)`` in the working dtype, a plateau in the quadratic
    regime (a full sweep gaining less than 10 % once below sqrt(eps) ||A||:
    the eps target is out of reach at large L), or ``max_sweeps``.  ``v``
    accumulates the rotations on the right; both come back in the
    tournament layout, which the caller's sort undoes.  ``off_tol`` may be
    a 0-d tensor (the solvers adapt it to their residual level)."""
    L = a.shape[-1]
    L2 = L // 2
    dtype, dev = a.dtype, a.device
    eps = torch.finfo(dtype).eps
    anorm = torch.linalg.norm(a)
    big = torch.clamp(anorm, min=1.0)
    tol = torch.clamp(_as_dtype(off_tol, dtype, dev), min=eps) * big
    qthresh = math.sqrt(eps) * big
    small_pivot = eps * anorm * 1e-3
    eye = torch.eye(L, dtype=torch.bool, device=dev)

    def offnorm(m):
        # the off-diagonal entries summed directly: ||m||^2 - ||diag||^2
        # cancels near convergence and stalls around sqrt(eps) ||A||
        return torch.linalg.norm(torch.where(eye, 0.0, m))

    m = a
    prev = torch.full((), math.inf, dtype=dtype, device=dev)
    for _ in range(max_sweeps):
        off = offnorm(m)
        plateau = (off < qthresh) & (off >= 0.9 * prev)
        if not bool((off > tol) & ~plateau):
            break
        for _ in range(L - 1):
            d = torch.diagonal(m)
            apq = torch.diagonal(m[:L2, L2:])         # m[i, i + L/2]
            c, s = _rotation(d[:L2], d[L2:], 2.0 * apq,
                             apq.abs() <= small_pivot)
            m = _rotate_permute(m, c, s, 0)
            m = _rotate_permute(m, c, s, 1)
            v = _rotate_permute(v, c, s, 1)
        prev = off
    return m, v


def _pad_odd(a: torch.Tensor, unit: bool) -> torch.Tensor:
    """``a`` with one more row and column of zeros (a 1 on the new
    diagonal entry when ``unit``): a decoupled pad for odd sizes."""
    out = torch.nn.functional.pad(a, (0, 1, 0, 1))
    if unit:
        out[-1, -1] = 1.0
    return out


def _drop_pad(L0: int, pad_col: torch.Tensor) -> torch.Tensor:
    """Indices of the L0 columns other than ``pad_col``, in order."""
    idx = torch.arange(L0, device=pad_col.device)
    return idx + (idx >= pad_col).to(idx.dtype)


def _polar(vv: torch.Tensor) -> torch.Tensor:
    """Two Newton steps of the polar iteration: a float32-accurate basis
    made orthonormal to float64 (error eps32 -> eps32^4)."""
    for _ in range(2):
        vv = 1.5 * vv - 0.5 * mm(vv, mTm(vv, vv))
    return vv


def jacobi_eigh(a: torch.Tensor, max_sweeps: int = 30,
                mixed_precision: bool = True, v0=None, off_tol=0.0):
    """Eigenvalues ascending and eigenvectors (columns) of symmetric
    ``a`` by cyclic Jacobi, as ``torch.linalg.eigh`` returns them.

    float64 input with ``mixed_precision`` runs float32 sweeps, two polar
    steps and float64 sweeps; that path ignores ``v0``, as the reference
    does (a warm start measured slower there).  ``v0``: an orthonormal
    warm-start basis for the single-precision-phase path.  ``off_tol``:
    the relative off-norm target (a float or 0-d tensor); 0 keeps
    machine-precision polishing.
    """
    L0 = a.shape[-1]
    dtype, dev = a.dtype, a.device
    L = L0 + L0 % 2     # odd sizes get a decoupled zero row and column
    if L != L0:
        a = _pad_odd(a, unit=False)
        if v0 is not None:
            v0 = _pad_odd(v0, unit=True)
    if mixed_precision and dtype == torch.float64:
        _, v32 = _jacobi_sweeps(
            a.to(torch.float32),
            torch.eye(L, dtype=torch.float32, device=dev), max_sweeps)
        vv = _polar(v32.to(torch.float64))
        a1 = mTm(vv, mm(a, vv))
        m, v = _jacobi_sweeps(0.5 * (a1 + a1.T), vv, max_sweeps, off_tol)
    elif v0 is not None:
        a1 = mTm(v0, mm(a, v0))
        m, v = _jacobi_sweeps(0.5 * (a1 + a1.T), v0, max_sweeps, off_tol)
    else:
        m, v = _jacobi_sweeps(a, torch.eye(L, dtype=dtype, device=dev),
                              max_sweeps, off_tol)
    w = torch.diagonal(m)
    order = rank_argsort(w)
    w, v = w[order], v[:, order]
    if L != L0:
        # the pad eigenpair (0, e_{L0}), wherever the sort put it: the
        # column with the most weight on the pad row
        keep = _drop_pad(L0, v[L0].abs().argmax())
        w, v = w[keep], v[:L0, keep]
    return w, v


def _unit_columns(m: torch.Tensor) -> torch.Tensor:
    nrm = torch.linalg.norm(m, dim=0, keepdim=True)
    return m / torch.where(nrm == 0.0, 1.0, nrm)


def jacobi_svd(a: torch.Tensor, max_sweeps: int = 30, off_tol=0.0):
    """SVD ``(u, s, vt)`` of square ``a``, s descending, from the Jacobi
    eigensolve of [[0, A^T], [A, 0]], whose eigenpairs are
    (+-sigma_i, (v_i; +-u_i)/sqrt(2)).  ``off_tol`` as in
    :func:`jacobi_eigh`."""
    L = a.shape[-1]
    zero = torch.zeros_like(a)
    aug = torch.cat([torch.cat([zero, a.T], dim=1),
                     torch.cat([a, zero], dim=1)])
    w, x = jacobi_eigh(aug, max_sweeps, off_tol=off_tol)
    s = w.flip(0)[:L]                       # the positive half, descending
    xs = x.flip(1)[:, :L] * math.sqrt(2.0)
    # renormalized: zero singular values leave an arbitrary scale
    return _unit_columns(xs[L:]), s, _unit_columns(xs[:L]).T


def _onesided_sweeps(a: torch.Tensor, v: torch.Tensor, max_sweeps: int,
                     off_tol=0.0):
    """One-sided (Hestenes) Jacobi: rotate column pairs of ``a`` (and the
    same rotations into ``v``) in the Brent-Luk order until every pair
    has |a_p . a_q| <= max(eps, off_tol) ||a_p|| ||a_q||, or the worst
    pair angle plateaus below sqrt(eps), or ``max_sweeps``.  On exit
    ``a @ V`` has nearly orthogonal columns whose norms are the singular
    values."""
    L = a.shape[-1]
    L2 = L // 2
    dtype, dev = a.dtype, a.device
    finfo = torch.finfo(dtype)
    rel = torch.clamp(_as_dtype(off_tol, dtype, dev), min=finfo.eps)
    sqrt_eps = math.sqrt(finfo.eps)
    m = a
    mx = torch.full((), math.inf, dtype=dtype, device=dev)
    prev = mx
    for _ in range(max_sweeps):
        plateau = (mx < sqrt_eps) & (mx >= 0.9 * prev)
        if not bool((mx > rel) & ~plateau):
            break
        worst = torch.zeros((), dtype=dtype, device=dev)
        for _ in range(L - 1):
            p, q = m[:, :L2], m[:, L2:]
            app = (p * p).sum(dim=0)
            aqq = (q * q).sum(dim=0)
            apq = (p * q).sum(dim=0)
            rel_pq = apq.abs() / (torch.sqrt(app * aqq) + finfo.tiny)
            worst = torch.maximum(worst, rel_pq.max())
            c, s = _rotation(app, aqq, 2.0 * apq,
                             rel_pq <= finfo.eps * 1e-2)
            m = _rotate_permute(m, c, s, 1)
            v = _rotate_permute(v, c, s, 1)
        prev, mx = mx, worst
    return m, v


def jacobi_svd_onesided(a: torch.Tensor, max_sweeps: int = 30, off_tol=0.0,
                        mixed_precision: bool = True):
    """SVD ``(u, s, vt)`` of square ``a`` by one-sided (Hestenes) Jacobi:
    the contract of :func:`jacobi_svd` at a fraction of its rotations
    (L columns instead of a 2L augmented matrix), with small singular
    values to full relative accuracy (column norms, no Gram squaring).
    float64 input with ``mixed_precision`` runs float32 sweeps first and
    finishes in float64 from the polar-corrected basis."""
    L0 = a.shape[-1]
    dtype, dev = a.dtype, a.device
    L = L0 + L0 % 2
    if L != L0:
        # a decoupled unit pad keeps the matrix nonsingular; its singular
        # value is exactly 1
        a = _pad_odd(a, unit=True)
    if mixed_precision and dtype == torch.float64:
        _, v32 = _onesided_sweeps(
            a.to(torch.float32),
            torch.eye(L, dtype=torch.float32, device=dev), max_sweeps)
        vv = _polar(v32.to(torch.float64))
        m, v = _onesided_sweeps(mm(a, vv), vv, max_sweeps, off_tol)
    else:
        m, v = _onesided_sweeps(a, torch.eye(L, dtype=dtype, device=dev),
                                max_sweeps, off_tol)
    s = torch.sqrt((m * m).sum(dim=0))
    order = rank_argsort(s, descending=True)
    s = s[order]
    u = m[:, order] / torch.where(s == 0.0, 1.0, s)[None, :]
    v = v[:, order]
    if L != L0:
        # the pad triplet (1, e_{L0}, e_{L0}), identified on v's pad row
        keep = _drop_pad(L0, v[L0].abs().argmax())
        s, u, v = s[keep], u[:L0, keep], v[:L0, keep]
    return u, s, v.T
