"""Hardened orthogonalization (port of the standard- and B-metric parts of
``diaglib_tpu/ortho/core.py``).

Every routine works on row-major vector blocks ``U: (k, n)`` with an
optional boolean row-validity ``mask``; masked rows are zero and stay zero.
The retry and refinement loops keep the reference's ladders, tolerances
and state (``_CDState`` / ``_VsXState``): their predicates (converged,
failed, stalled, the growth / overlap test, b_ortho's Cholesky / SVD
choice) are 0-d device tensors, and each pass leaves the state unchanged
through a mask once the loop's own predicate says stop.  Such a loop runs
in one of two ways (:func:`_passes`):

* eagerly, reading its predicate once a pass, as the reference's
  ``lax.while_loop`` tests its ``cond``; the public routines always run
  so, and return Python bools and floats as they did;
* unrolled to a fixed number of passes, under :class:`unrolled`: nothing
  is read, so a solver step can be captured as a CUDA graph, and the
  context records on the device whether every loop stopped within its
  passes (and no QR fallback or SVD rescue was needed), i.e. whether the
  unrolled result is the loop's own.  A caller whose step did not finish
  runs it again eagerly (``utils/graphs.py``); under :class:`eager_passes`
  the eager loops record the most passes each took.

* ``norm_est``   — triangular norm bound.
* ``ortho_cd``   — shifted Cholesky + iterative refinement + growth model.
* ``ortho_qr``   — QR fallback (also applies R^{-1} to a second set).
* ``ortho_vs_x`` — project out an orthonormal X, re-orthonormalize, repeat.
* ``b_ortho``    — B-orthonormalize U given BU (Cholesky, SVD rescue).
* ``b_ortho_svd`` — the metric^{-1/2} SVD branch with a relative cut.
* ``b_ortho_vs_x`` — B-orthogonalize U against X, then orthonormalize.
* ``svd_biortho`` — biorthonormalize a (left, right) pair of blocks.
* ``biortho_vs_x`` — biorthogonalize a pair against a biorthonormal pair.

The projections and rotations go through ``utils.mm``, so on the card
their float64 wide products take the wide-rotation kernel when the
solver's routing has it on.  Under ``utils.mm.mm_sharding`` the blocks are
column shards: every reduction over n (the Gram products of ``mmT``, the
norms of ``ortho_cd`` and ``b_ortho``) is all-reduced, ``ortho_qr``
factors the all-gathered block and keeps its own columns, and
``norm_est``, which works on reduced matrices, reduces nothing.
"""

from __future__ import annotations

import math

import torch

from ..utils.masking import masked_cholesky, masked_svd
from ..utils.mm import current_sharding, mm, mmT, mTm, norm_n, sum_n

__all__ = ["norm_est", "ortho_cd", "ortho_qr", "ortho_vs_x", "b_ortho",
           "b_ortho_svd", "b_ortho_vs_x", "svd_biortho", "biortho_vs_x"]

_MAXIT = 10
_MAXIT_BIORTHO = 20


def _eps(dtype) -> float:
    return torch.finfo(dtype).eps


def _tol_ortho(dtype) -> float:
    return 2.0 * _eps(dtype)


def _rowmask(mask, k, device):
    if mask is None:
        return torch.ones((k,), dtype=torch.bool, device=device)
    return mask


class unrolled:
    """Run the refinement loops entered under this context unrolled to the
    fixed pass counts of ``budgets`` (keys "vs", the ortho_vs_x passes;
    "cd", ortho_cd's refinement passes; "shift", the Cholesky level-shift
    retries), reading nothing back.

    ``finished`` (a 0-d bool tensor, or None when no loop could fall
    short) is true when every loop stopped within its passes and no
    branch that only an eager loop takes (ortho_cd's QR fallback,
    b_ortho's SVD rescue) was needed: the result is then the eager loops'
    own, bit for bit.  ``live`` is the mask of the pass being computed
    (None outside any masked pass)."""

    def __init__(self, budgets: dict):
        if budgets["vs"] < 1 or budgets["cd"] < 1 or budgets["shift"] < 0:
            raise ValueError(f"unrolled: budgets {budgets} below 1 pass")
        self.budgets = budgets
        self.live = None
        self.finished = None

    def need(self, flag: torch.Tensor):
        """The result is the loops' own only if ``flag`` holds (in a live
        pass)."""
        if self.live is not None:
            flag = flag | ~self.live
        self.finished = flag if self.finished is None else (
            self.finished & flag)

    def __enter__(self):
        self.prev = _UNROLLED[0]
        _UNROLLED[0] = self
        return self

    def __exit__(self, *exc):
        _UNROLLED[0] = self.prev


# the unrolled context in force (None: loops run eagerly)
_UNROLLED = [None]


class eager_passes:
    """Record, while entered, the most passes each eagerly run refinement
    loop took, by the keys of :class:`unrolled`'s budgets: the budgets
    under which the unrolled loops would have finished."""

    def __init__(self):
        self.most = {"vs": 0, "cd": 0, "shift": 0}

    def __enter__(self):
        self.prev = _COUNTING[0]
        _COUNTING[0] = self
        return self

    def __exit__(self, *exc):
        _COUNTING[0] = self.prev


# the eager_passes context in force (None: passes are not counted)
_COUNTING = [None]


def _passes(key: str, max_iter: int, done_of):
    """The passes of a refinement loop that stops once ``done_of()`` (a
    0-d bool tensor, or Python False before the first pass) holds, or
    after ``max_iter`` passes: the reference's ``lax.while_loop``.

    Eagerly, it reads the predicate once a pass.  Under :class:`unrolled`
    it yields ``budgets[key]`` passes (at most max_iter) without a read,
    each with ``live`` set to the loop's own mask, and when the budget is
    short of max_iter records that the loop must have stopped by then."""
    rec = _UNROLLED[0]
    if rec is None:
        taken = max_iter
        for it in range(max_iter):
            done = done_of()
            if done is not False and bool(done):
                taken = it
                break
            yield it
        count = _COUNTING[0]
        if count is not None:
            count.most[key] = max(count.most[key], taken)
        return
    outer = rec.live
    count = min(max_iter, rec.budgets[key])
    try:
        for it in range(count):
            done = done_of()
            if done is not False:
                rec.live = ~done if outer is None else outer & ~done
            yield it
    finally:
        rec.live = outer
    if count < max_iter:
        rec.need(done_of())


def _keep(new, old):
    """``new`` in a live pass, ``old`` in a masked one."""
    rec = _UNROLLED[0]
    if rec is None or rec.live is None:
        return new
    return torch.where(rec.live, new, old)


def norm_est(L: torch.Tensor, mask=None) -> torch.Tensor:
    """||L|| <= max_i |L_ii| + ||strict lower||_F, masked rows/cols out."""
    mask = _rowmask(mask, L.shape[0], L.device)
    diag_norm = torch.where(mask, torch.diagonal(L).abs(), 0.0).max()
    outer = mask[:, None] & mask[None, :]
    lower = torch.where(outer, torch.tril(L, diagonal=-1), 0.0)
    return diag_norm + torch.sqrt((lower * lower).sum())


def _shifted_cholesky(metric, mask, unorm, dtype):
    """Cholesky with the level-shift retry ladder: on failure add
    ``max(eps*alpha*||U||, tol_ortho)`` to the valid diagonal, alpha = 100
    growing 10x per retry, at most _MAXIT retries.  Returns (L, failed),
    ``failed`` a 0-d bool tensor."""
    L, failed = masked_cholesky(metric, mask)
    alpha = 100.0
    for _ in _passes("shift", _MAXIT, lambda: ~failed):
        shift = torch.clamp(_eps(dtype) * alpha * unorm, min=_tol_ortho(dtype))
        shifted = metric + torch.diag(
            torch.where(mask, shift, 0.0).to(metric.dtype))
        L_new, failed_new = masked_cholesky(shifted, mask)
        L, failed = _keep(L_new, L), _keep(failed_new, failed)
        alpha *= 10.0
    return L, failed


def _ortho_cd(u: torch.Tensor, mask=None, max_iter: int = _MAXIT):
    """:func:`ortho_cd` with ``growth`` and ``ok`` as 0-d tensors."""
    k, n = u.shape
    dtype = u.dtype
    mask = _rowmask(mask, k, u.device)
    eye = torch.eye(k, dtype=dtype, device=u.device)
    growth = torch.ones((), dtype=dtype, device=u.device)
    prev_rcond = torch.full((), math.inf, dtype=dtype, device=u.device)
    ok = torch.zeros((), dtype=torch.bool, device=u.device)
    done = False
    for it in _passes("cd", max_iter, lambda: done):
        metric = mmT(u, u)
        unorm = torch.sqrt(sum_n(u * u))
        L, failed = _shifted_cholesky(metric, mask, unorm, dtype)
        linv = torch.linalg.solve_triangular(L, eye, upper=False)
        l_norm = norm_est(L, mask)
        linv_norm = norm_est(linv, mask)
        rcond = l_norm * linv_norm
        error = _eps(dtype) * rcond * rcond
        converged = error < _tol_ortho(dtype)
        # each refinement pass squares the orthogonality error, so rcond
        # must drop sharply pass over pass; a stalled rcond means the
        # block is numerically rank deficient and can never converge here
        stop = converged | failed
        if it > 0:
            stop = stop | ((rcond >= 0.5 * prev_rcond) & ~converged)
        # a failed ladder leaves u and growth as they were
        u = _keep(torch.where(failed, u, mm(linv, u)), u)
        growth = _keep(torch.where(failed, growth, growth * linv_norm),
                       growth)
        ok = _keep(converged, ok)
        prev_rcond = _keep(rcond, prev_rcond)
        done = _keep(stop, done)
    return u, growth, ok & done if done is not False else ok


def ortho_cd(u: torch.Tensor, mask=None, max_iter: int = _MAXIT):
    """Cholesky orthonormalization with level shifting and refinement.

    Returns ``(u_ortho, growth, ok)``: ``growth`` is the accumulated
    ||L^-1|| product the *_vs_x callers use to bound the orthogonality
    error they re-introduce; ``ok`` is False if the refinement did not
    converge (the shift ladder failed, rcond stalled, or max_iter passes
    ran out) — callers then fall back to QR.
    """
    u, growth, ok = _ortho_cd(u, mask, max_iter)
    return u, float(growth), bool(ok)


def ortho_qr(u: torch.Tensor, mask=None, extra=None):
    """QR orthonormalization of the masked rows.

    Valid rows are (stably) permuted to the front, so the leading Q columns
    depend only on them; masked rows come back as zeros.  With ``extra``
    (e.g. A@U with the same masked rows) the same transform R^{-1} is
    applied to it and ``(q, extra_q)`` is returned.
    """
    k = u.shape[0]
    mask = _rowmask(mask, k, u.device)
    # sharded: every rank factors the same gathered block (the rare
    # fallback path, bit-equal to the unsharded QR) and keeps its columns
    sh = current_sharding()
    full = u if sh is None else sh.all_gather(u)
    n = full.shape[1]
    perm = torch.argsort((~mask).to(torch.int8), stable=True)
    inv_perm = torch.argsort(perm, stable=True)
    u_p = full[perm]
    # masked (now trailing) rows become unit vectors so the QR stays
    # well-posed; they never influence the leading (valid) Q columns
    basis = torch.nn.functional.one_hot(
        torch.arange(k, device=u.device) % n, n).to(u.dtype)
    mask_p = mask[perm]
    u_p = torch.where(mask_p[:, None], u_p, basis)
    q, r = torch.linalg.qr(u_p.T, mode="reduced")      # (n, k), (k, k)
    q_rows = torch.where(mask_p[:, None], q.T, 0.0)
    out = q_rows[inv_perm]
    if sh is not None:
        out = sh.local_cols(out)
    if extra is None:
        return out
    e_rows = torch.linalg.solve_triangular(r.T, extra[perm], upper=False)
    e_rows = torch.where(mask_p[:, None], e_rows.to(u.dtype), 0.0)
    return out, e_rows[inv_perm]


def _ortho_or_qr(u, mask):
    """ortho_cd with the QR fallback; returns (u, growth, cd_ok), the last
    two 0-d tensors.  When ortho_cd fails, u comes from QR and callers
    must compute the explicit overlap to test convergence.  Under
    :class:`unrolled` the fallback is not taken: the context records
    that it was needed."""
    u_cd, growth, ok = _ortho_cd(u, mask)
    rec = _UNROLLED[0]
    if rec is not None:
        rec.need(ok)
        return u_cd, growth, ok
    return (u_cd if bool(ok) else ortho_qr(u, mask)), growth, ok


def _iterate_vs_x(project, x_for_overlap, u, umask, max_iter):
    """Project out X, re-orthonormalize, repeat until the (estimated)
    overlap with X is below 2*eps.  Returns (u, done), ``done`` a 0-d
    bool tensor."""
    dtype = u.dtype
    u, _, _ = _ortho_or_qr(u, umask)
    done = False
    for _ in _passes("vs", max_iter, lambda: done):
        uu, growth, cd_ok = _ortho_or_qr(project(u), umask)
        xu_norm = growth * _eps(dtype)
        if _UNROLLED[0] is None and not bool(cd_ok):
            overlap = mmT(uu, x_for_overlap)
            xu_norm = torch.sqrt((overlap * overlap).sum())
        u = _keep(uu, u)
        done = _keep(xu_norm < _tol_ortho(dtype), done)
    if done is False:
        done = torch.zeros((), dtype=torch.bool, device=u.device)
    return u, done


def _ortho_vs_x(x, u, xmask=None, umask=None, max_iter: int = _MAXIT):
    """:func:`ortho_vs_x` with ``done`` a 0-d tensor."""
    xmask = _rowmask(xmask, x.shape[0], x.device)
    umask = _rowmask(umask, u.shape[0], u.device)
    xm = torch.where(xmask[:, None], x, 0.0)

    def project(uu):
        return uu - mm(mmT(uu, xm), xm)

    return _iterate_vs_x(project, xm, u, umask, max_iter)


def ortho_vs_x(x: torch.Tensor, u: torch.Tensor, xmask=None, umask=None,
               max_iter: int = _MAXIT):
    """Orthogonalize block u against orthonormal x, then orthonormalize u.

    Iterates ``u <- u - (u x^T) x`` + orthonormalization until
    ||x u^T|| < 2*eps, estimating the overlap from ortho_cd's growth factor
    when available.  Masked rows of x and u are zero and stay zero.
    Returns ``(u, done)``.
    """
    u, done = _ortho_vs_x(x, u, xmask, umask, max_iter)
    return u, bool(done)


def _b_ortho(u, bu, mask=None):
    """:func:`b_ortho` with ``ok`` a 0-d tensor; under :class:`unrolled`
    the SVD rescue is not taken, and the context records when it was
    needed."""
    k = u.shape[0]
    mask = _rowmask(mask, k, u.device)
    norms = norm_n(u)
    inv = torch.where(norms > 0.0,
                      1.0 / torch.where(norms > 0.0, norms, 1.0), 1.0)
    u = u * inv[:, None]
    bu = bu * inv[:, None]
    metric = mmT(u, bu)
    L, failed = masked_cholesky(metric, mask)
    rec = _UNROLLED[0]
    if rec is None and bool(failed):
        u_new, bu_new = b_ortho_svd(u, bu, mask)
    else:
        if rec is not None:
            rec.need(~failed)
        u_new = torch.linalg.solve_triangular(L, u, upper=False)
        bu_new = torch.linalg.solve_triangular(L, bu, upper=False)
    u_new = torch.where(mask[:, None], u_new, 0.0)
    bu_new = torch.where(mask[:, None], bu_new, 0.0)
    return u_new, bu_new, ~failed


def b_ortho(u: torch.Tensor, bu: torch.Tensor, mask=None):
    """B-orthonormalize u given ``bu = B u``.

    The rows are first normalized (exact in span, and it keeps the metric
    O(1) when rows arrive with very different norms); the metric
    ``u bu^T`` is Cholesky-factored and L^{-1} applied to both u and bu.
    When the Cholesky fails (a numerically rank-deficient block),
    :func:`b_ortho_svd` takes over as the rescue path, and ``ok`` comes
    back False so the solver's ``ortho_ok`` records it.

    Returns ``(u, bu, ok)``; masked rows are zero.
    """
    u, bu, ok = _b_ortho(u, bu, mask)
    return u, bu, bool(ok)


def b_ortho_svd(u: torch.Tensor, bu: torch.Tensor, mask=None,
                tol_svd: float = 1.0e-5):
    """Apply metric^{-1/2} to u and bu, dropping singular directions below
    ``tol_svd`` RELATIVE to the largest singular value (the reference's
    disabled ``use_svd`` branch, with the reference package's relative
    cut).  Returns ``(u, bu)``."""
    k = u.shape[0]
    mask = _rowmask(mask, k, u.device)
    metric = mmT(u, bu)
    uu, s, vt = masked_svd(metric, mask)
    s_floor = tol_svd * torch.where(mask, s, 0.0).max()
    s_inv = torch.where(s > s_floor,
                        1.0 / torch.sqrt(torch.maximum(s, s_floor)), 0.0)
    m_inv_half = uu @ (s_inv[:, None] * vt)
    u_new = mTm(m_inv_half, u)
    bu_new = mTm(m_inv_half, bu)
    u_new = torch.where(mask[:, None], u_new, 0.0)
    bu_new = torch.where(mask[:, None], bu_new, 0.0)
    return u_new, bu_new


def _b_ortho_vs_x(x, bx, u, xmask=None, umask=None,
                  max_iter: int = _MAXIT):
    """:func:`b_ortho_vs_x` with ``done`` a 0-d tensor."""
    xmask = _rowmask(xmask, x.shape[0], x.device)
    umask = _rowmask(umask, u.shape[0], u.device)
    xm = torch.where(xmask[:, None], x, 0.0)
    bxm = torch.where(xmask[:, None], bx, 0.0)

    def project(uu):
        return uu - mm(mmT(uu, bxm), xm)

    return _iterate_vs_x(project, bxm, u, umask, max_iter)


def b_ortho_vs_x(x: torch.Tensor, bx: torch.Tensor, u: torch.Tensor,
                 xmask=None, umask=None, max_iter: int = _MAXIT):
    """B-orthogonalize u against x (metric overlap ``u bx^T``), then
    orthonormalize u; iterate as :func:`ortho_vs_x`.  Returns
    ``(u, done)``."""
    u, done = _b_ortho_vs_x(x, bx, u, xmask, umask, max_iter)
    return u, bool(done)


def svd_biortho(u_l: torch.Tensor, u_r: torch.Tensor, mask=None):
    """Biorthonormalize (u_l, u_r) through the SVD of their overlap
    O = u_l u_r^T = U S V^T: u_l <- S^-1/2 U^T u_l, u_r <- S^-1/2 V^T u_r,
    so that u_l u_r^T = I on the valid block.  Returns ``(u_l, u_r)``."""
    k = u_l.shape[0]
    mask = _rowmask(mask, k, u_l.device)
    uu, s, vt = masked_svd(mmT(u_l, u_r), mask)
    inv_sqrt = 1.0 / torch.sqrt(s)
    u_l_new = inv_sqrt[:, None] * mTm(uu, u_l)
    u_r_new = inv_sqrt[:, None] * mm(vt, u_r)
    return (torch.where(mask[:, None], u_l_new, 0.0),
            torch.where(mask[:, None], u_r_new, 0.0))


def biortho_vs_x(xl: torch.Tensor, xr: torch.Tensor, ul: torch.Tensor,
                 ur: torch.Tensor, xmask=None, umask=None,
                 max_iter: int = _MAXIT_BIORTHO):
    """Biorthogonalize (ul, ur) against the biorthonormal pair (xl, xr):
    ``ur <- ur - (ur xl^T) xr`` and ``ul <- ul - (ul xr^T) xl``, then
    orthonormalize each, repeating until both overlaps are below 2*eps
    (estimated from ortho_cd's growth, or explicit after a QR fallback);
    finish with :func:`svd_biortho`.  Returns ``(ul, ur, done)``."""
    xmask = _rowmask(xmask, xl.shape[0], xl.device)
    umask = _rowmask(umask, ul.shape[0], ul.device)
    xlm = torch.where(xmask[:, None], xl, 0.0)
    xrm = torch.where(xmask[:, None], xr, 0.0)
    dtype = ul.dtype

    def overlap_err(x, u, growth, cd_ok):
        if bool(cd_ok):
            return float(growth) * _eps(dtype)
        overlap = mmT(x, u)
        return float(torch.sqrt((overlap * overlap).sum()))

    done = False
    it = 0
    while not done and it < max_iter:
        ur_ = ur - mm(mmT(ur, xlm), xrm)
        ul_ = ul - mm(mmT(ul, xrm), xlm)
        ul, g_l, ok_l = _ortho_or_qr(ul_, umask)
        ur, g_r, ok_r = _ortho_or_qr(ur_, umask)
        done = (overlap_err(xrm, ul, g_l, ok_l) < _tol_ortho(dtype)
                and overlap_err(xlm, ur, g_r, ok_r) < _tol_ortho(dtype))
        it += 1
    ul, ur = svd_biortho(ul, ur, umask)
    return ul, ur, done
