"""Eigensolver for small real nonsymmetric matrices on the tensors' device
(port of ``diaglib_tpu/utils/eberlein.py``): the ``nonsym(driver=
"device")`` route.

A norm-reducing Jacobi-like method (Eberlein, SIAM J. 10, 1962) in the
Brent-Luk parallel order.  Each round applies, to every disjoint pivot
pair (p, q) at once:

1. an orthogonal rotation that annihilates the symmetric part of the 2x2
   pivot block (classical Jacobi on (A + A^T)/2); and
2. a norm-reducing shear, the similarity T^-1 A T with
   T = [[cosh y, sinh y], [sinh y, cosh y]] on the (p, q) plane, y the
   damped Newton step from 0 on the convex Frobenius norm of the
   transformed matrix (clamped to |y| <= 1/4).

Rotations drive a normal matrix with real spectrum to diagonal form and
shears drive the departure from normality to zero; complex-conjugate pairs
converge to 2x2 skew-coupled blocks whose |Im| is read off the block
discriminants (the caller parks them).  Accumulating S and S^-1 gives both
eigenvector sides from one iteration: columns of S are the right
eigenvectors, columns of S^-T the left ones.

The stop test (the effective off-norm of the reference, with its plateau
and stall exits) is read on the host once a sweep.  The bulk of the
sweeps runs in float32; S^-1 is then Newton-refined in float64 so that the
float64 phase starts from an exact similarity, as in the reference.
"""

from __future__ import annotations

import math

import torch

from .jacobi import (
    _as_dtype,
    _drop_pad,
    _pad_odd,
    _rotation,
    _unit_columns,
    rank_argsort,
    tournament,
)
from .mm import mm

__all__ = ["eberlein_eig"]


def _pair_apply(x, alpha, beta, gamma, delta, axis, permute):
    """[[alpha, beta], [gamma, delta]] applied to every Brent-Luk pair
    (i, i + L/2) along ``axis``: top' = alpha top + beta bot, bot' =
    gamma top + delta bot; with ``permute`` the tournament permutation is
    fused into the concatenation."""
    L2 = x.shape[axis] // 2
    p, q = x.narrow(axis, 0, L2), x.narrow(axis, L2, L2)

    def bc(c):
        return c[:, None] if axis == 0 else c[None, :]

    top = bc(alpha) * p + bc(beta) * q
    bot = bc(gamma) * p + bc(delta) * q
    if not permute:
        return torch.cat([top, bot], dim=axis)
    return tournament(top, bot, axis)


def _block_entries(m, L2):
    d = torch.diagonal(m)
    return (d[:L2], d[L2:], torch.diagonal(m[:L2, L2:]),
            torch.diagonal(m[L2:, :L2]))


def _eberlein_sweeps(a, s, sinv, max_sweeps: int, off_tol=0.0):
    """Rotation + shear sweeps; returns (m, s, sinv) in the tournament
    layout.  ``off_tol``: the relative target of the effective off-norm,
    floored at eps (a float or 0-d tensor)."""
    L = a.shape[-1]
    L2 = L // 2
    dtype, dev = a.dtype, a.device
    eps = torch.finfo(dtype).eps
    anorm = torch.linalg.norm(a)
    big = torch.clamp(anorm, min=1.0)
    tol = torch.clamp(_as_dtype(off_tol, dtype, dev), min=eps) * big
    qthresh = math.sqrt(eps) * big
    small_pivot = eps * anorm * 1e-3
    tiny = eps * anorm * anorm * 1e-3
    eye = torch.eye(L, dtype=torch.bool, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    def off_eff(m):
        # the distance from an extractable converged form: an entry whose
        # 2x2 discriminant is negative (a complex-pair candidate) counts
        # only its deviation from a normal block [[a, b], [-b, a]], every
        # other entry counts fully (see the reference)
        d = torch.diagonal(m)
        half = 0.5 * (d[:, None] - d[None, :])
        mt = m.T
        disc = half * half + m * mt
        sym = 0.5 * (m + mt)
        contrib = torch.where(disc < 0.0, sym * sym + half * half, m * m)
        return torch.sqrt(torch.where(eye, 0.0, contrib).sum())

    def round_step(m, s, sinv):
        # rotation: classical Jacobi on the symmetric part
        app, aqq, apq, aqp = _block_entries(m, L2)
        u = apq + aqp                      # 2 sym(A)_pq
        c, sr = _rotation(app, aqq, u, u.abs() <= small_pivot)
        m = _pair_apply(m, c, -sr, sr, c, 0, permute=False)
        m = _pair_apply(m, c, -sr, sr, c, 1, permute=False)
        s = _pair_apply(s, c, -sr, sr, c, 1, permute=False)
        sinv = _pair_apply(sinv, c, -sr, sr, c, 0, permute=False)

        # shear: the damped Newton step on the convex norm function
        app, aqq, apq, aqp = _block_entries(m, L2)
        blk_sq = app * app + aqq * aqq + apq * apq + aqp * aqp
        sq = m * m
        colsq = sq.sum(dim=0)
        rowsq = sq.sum(dim=1)
        colprod = (m[:, :L2] * m[:, L2:]).sum(dim=0)
        rowprod = (m[:L2, :] * m[L2:, :]).sum(dim=1)
        P = colsq[:L2] + colsq[L2:] + rowsq[:L2] + rowsq[L2:] - 2.0 * blk_sq
        Q = 2.0 * ((colprod - app * apq - aqp * aqq)
                   - (rowprod - app * aqp - apq * aqq))
        dd = app - aqq
        vv = apq - aqp
        denom = 2.0 * P + 4.0 * (dd * dd + vv * vv)
        flat = denom <= tiny
        y = -(Q + 2.0 * dd * vv) / torch.where(flat, one, denom)
        # any step between 0 and the minimizer is a strict descent; the
        # clamp guards the far-from-normal regime against overshoot
        y = torch.clamp(torch.where(flat, 0.0, y), -0.25, 0.25)
        ch, sh = torch.cosh(y), torch.sinh(y)
        m = _pair_apply(m, ch, -sh, -sh, ch, 0, permute=True)
        m = _pair_apply(m, ch, sh, sh, ch, 1, permute=True)
        s = _pair_apply(s, ch, sh, sh, ch, 1, permute=True)
        sinv = _pair_apply(sinv, ch, -sh, -sh, ch, 0, permute=True)
        return m, s, sinv

    m = a
    prev = torch.full((), math.inf, dtype=dtype, device=dev)
    for _ in range(max_sweeps):
        off = off_eff(m)
        # the eps target is out of reach at large L (plateau), and a hard
        # stall anywhere (a defective matrix) must not burn the budget
        plateau = (off < qthresh) & (off >= 0.9 * prev)
        stall = off >= 0.999 * prev
        if not bool((off > tol) & ~plateau & ~stall):
            break
        for _ in range(L - 1):
            m, s, sinv = round_step(m, s, sinv)
        prev = off
    return m, s, sinv


def _wi_estimate(m, wr):
    """|Im lambda| per index from the 2x2 block discriminants of the
    converged matrix: a complex pair converges to a skew coupling with
    disc = -Im^2 < 0; every real-spectrum coupling decays to ~0."""
    half = 0.5 * (wr[:, None] - wr[None, :])
    disc = half * half + m * m.T
    neg = torch.sqrt(torch.clamp(-disc, min=0.0))
    eye = torch.eye(m.shape[0], dtype=torch.bool, device=m.device)
    return torch.where(eye, 0.0, neg).amax(dim=1)


def eberlein_eig(a: torch.Tensor, max_sweeps: int = 30,
                 mixed_precision: bool = True, off_tol=0.0):
    """Eigendecomposition of a small real nonsymmetric matrix on its
    device.

    Returns ``(wr, wi, vr, vl)``: ``wr`` ascending, |Im| magnitudes in
    ``wi`` (signs not resolved: callers park on |wi|), unit right
    eigenvectors in the columns of ``vr`` and unit left eigenvectors in
    the columns of ``vl`` (vl^T A = wr vl^T), what the nonsymmetric driver
    takes from LAPACK's dgeev.  Contract: diagonalizable with (mostly)
    real spectrum; complex pairs are located and measured but their
    columns are only the real 2x2-block basis, and a defective input stops
    at the stall exit or the sweep cap.  ``off_tol``: the relative
    off-norm target of the last phase (a float or 0-d tensor).
    """
    L0 = a.shape[-1]
    dtype, dev = a.dtype, a.device
    L = L0 + L0 % 2
    if L != L0:
        a = _pad_odd(a, unit=False)
    if mixed_precision:
        # float32 sweeps, then float64, for float32 input too: the float32
        # drift is far too coarse to return, and the dgeev this replaces
        # always solves in float64
        eye32 = torch.eye(L, dtype=torch.float32, device=dev)
        _, s32, sinv32 = _eberlein_sweeps(a.to(torch.float32), eye32, eye32,
                                          max_sweeps)
        s0 = s32.to(torch.float64)
        sinv0 = sinv32.to(torch.float64)
        # the two float32 accumulators drift apart (||S^-1 S - I|| ~ 0.2 at
        # L ~ 300), so four quadratic Newton steps, not two
        eye2 = 2.0 * torch.eye(L, dtype=torch.float64, device=dev)
        for _ in range(4):
            sinv0 = mm(sinv0, eye2 - mm(s0, sinv0))
        a1 = mm(sinv0, mm(a.to(torch.float64), s0))
        m, s, sinv = _eberlein_sweeps(a1, s0, sinv0, max_sweeps, off_tol)
        m, s, sinv = m.to(dtype), s.to(dtype), sinv.to(dtype)
    else:
        eye = torch.eye(L, dtype=dtype, device=dev)
        m, s, sinv = _eberlein_sweeps(a, eye, eye, max_sweeps, off_tol)
    wr = torch.diagonal(m)
    wi = _wi_estimate(m, wr)
    order = rank_argsort(wr)
    wr, wi = wr[order], wi[order]
    vr = _unit_columns(s[:, order])
    vl = _unit_columns(sinv.T[:, order])
    if L != L0:
        # the pad row and column stay exactly decoupled, so its eigenpair
        # is (0, e_{L0}); drop it wherever the sort put it
        keep = _drop_pad(L0, vr[L0].abs().argmax())
        wr, wi, vr, vl = wr[keep], wi[keep], vr[:L0, keep], vl[:L0, keep]
    return wr, wi, vr, vl
