"""Casida linear-response eigensolvers (port of
``diaglib_tpu/solvers/caslr.py``).

Solves the paired response problem

    [[A, B], [B, A]] (Y, Z) = w [[S, D], [-D, -S]] (Y, Z)

in the combinations vp = Y+Z, vm = Y-Z, through four operator callbacks
apbmul = (A+B)., ambmul = (A-B)., spdmul = (S+D)., smdmul = (S-D). and a
paired preconditioner ``lrprec(fac, rp, rm) -> (yp, ym)``.

* ``caslr``: plain-orthonormal vp/vm spaces, four operator applications
  on the new block an iteration, the reduced 2 ldu pencil solved by
  ``algorithm=0``, its exact half-size reduction (the inverse pencil
  S_red x = e A_red x, eigenvalues 1/e from the top), or ``algorithm=1``,
  the Helmich-Paris scheme (SVD of the coupling matrix, scaled
  projections, two Cholesky factors, a second SVD).
* ``caslr_eff``: expansion vectors kept B-orthonormal in the (A+B) and
  (A-B) metrics, so the reduced problem is the half-size symmetric
  ``s^T s`` eigenproblem; two counted operator applications an iteration
  (the metric applications of expand and restart are not counted, as in
  the reference); eigenvalues carried as 1/w and reported as w.

The loops are eager Python over the reference's state: fixed
``(lda_pad, n)`` buffers with a row count ``ldu``, the reduced Gram
matrices updated only in their new rows and columns.  The reduced solves
work on the leading ``ldu x ldu`` block directly, so the reference's
prefix buckets with identity or large-negative padding are not carried.
They take ``options.reduced_solver`` and, on the Jacobi route, the
reference's adaptive off-norm target; there the Helmich-Paris SVDs are the
two-sided (augmented) ``jacobi_svd``, as the reference calls them.

Sharded (``sharding=`` a :class:`~diaglib_tpu_torch.parallel.VectorSharding`
over n): each rank passes and receives the paired rows as ``[Y_local |
Z_local]``, its column shard of Y beside its column shard of Z, a
``(n_max, 2 n_local)`` block; the callbacks see ``(k, n_local)`` blocks.
The Gram products, norms and maxima are all-reduced (``utils.mm``), ``n``
in the rms is the global length, and the random fill of zero guess rows
draws at global width and keeps the rank's columns, so a sharded solve
starts where the unsharded one does.
"""

from __future__ import annotations

import math

import torch

from ..ortho.core import b_ortho, b_ortho_vs_x, ortho_cd, ortho_vs_x
from ..reporting import inflight_progress
from ..types import LRSolverResult, SolverOptions
from ..utils import reduced
from ..utils.jacobi import jacobi_svd
from ..utils.masking import gather_rows, prefix_lock, prefix_mask, scatter_rows
from ..utils.mm import (
    amax_n,
    current_sharding,
    global_n,
    mm,
    mm_sharding,
    mmT,
    mTm,
    norm_n,
    routing_for,
)

__all__ = ["caslr", "caslr_eff"]


def _split_guess(evec_guess: torch.Tensor, n_max: int):
    """(n_max, 2n) paired rows -> (vp, vm) = (Y+Z, Y-Z) and n."""
    if evec_guess.shape[0] != n_max:
        raise ValueError(f"guess must have n_max={n_max} rows, got "
                         f"{evec_guess.shape[0]}")
    n2 = evec_guess.shape[1]
    if n2 % 2:
        raise ValueError("guess rows must have even length 2n")
    n = n2 // 2
    y, z = evec_guess[:, :n], evec_guess[:, n:]
    return y + z, y - z, n


def _nonzero_or_random(v: torch.Tensor, generator):
    """Zero rows of v replaced by uniform rows in [-0.5, 0.5) from
    ``generator``; nonzero rows are kept as they are, and nothing is drawn
    when no row is zero.  A row's norm is taken over all ranks under a
    sharding, and the random rows are drawn at global width with the
    rank's columns kept."""
    zero = norm_n(v) == 0.0
    if not bool(zero.any()):
        return v
    sh = current_sharding()
    shape = (v.shape[0], v.shape[1] if sh is None else sh.n)
    rnd = torch.rand(shape, generator=generator, dtype=v.dtype,
                     device=v.device) - 0.5
    if sh is not None:
        rnd = sh.local_cols(rnd)
    return torch.where(zero[:, None], rnd, v)


def _combine(eigp: torch.Tensor, eigm: torch.Tensor) -> torch.Tensor:
    """(Y, Z) rows of length 2n from the plus/minus components."""
    return torch.cat([eigp + eigm, eigp - eigm], dim=1)


def _sym(a: torch.Tensor) -> torch.Tensor:
    return 0.5 * (a + a.T)


def _reduced_inverse_pencil(ep: torch.Tensor, em: torch.Tensor,
                            s: torch.Tensor, n_max: int, method: str,
                            off_tol=0.0):
    """``algorithm=0`` on the leading blocks: the 2L pencil S_red x = e
    A_red x with A_red = diag(ep, em), S_red = [[0, s^T], [s, 0]],
    eliminated exactly to the L-size SPD pencil (s ep^-1 s^T) um = e^2 em
    um, up = ep^-1 s^T um / e, whose n_max largest e are the ones the full
    solve returns, with its x^T A_red x = 1 normalization (both halves
    weigh 1/2, hence 1/sqrt(2)).  Returns (w, up, um), w = 1/e.
    ``method``/``off_tol``: the reduced route and its Jacobi target."""
    lp = reduced.cholesky(_sym(ep), method)
    w = torch.linalg.solve_triangular(lp, s.T, upper=False)   # lp^-1 s^T
    g = w.T @ w                                               # s ep^-1 s^T
    e2, um = reduced.eigh_gen(_sym(g), _sym(em), method, off_tol=off_tol)
    e2_top = e2.flip(0)[:n_max]
    um_top = um.flip(1)[:, :n_max]
    eig = 1.0 / torch.sqrt(torch.clamp(e2_top, min=0.0))
    up_top = torch.linalg.solve_triangular(lp.T, w @ um_top, upper=True)
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    return eig, up_top * eig[None, :] * inv_sqrt2, um_top * inv_sqrt2


def _hp_svd(a: torch.Tensor, method: str, off_tol):
    """The Helmich-Paris SVDs: the reduced route's SVD, except that the
    Jacobi route is the two-sided augmented form, as in the reference."""
    if method == "jacobi":
        return jacobi_svd(a, off_tol=off_tol)
    return reduced.svd(a, method)


def _reduced_helmich_paris(ep: torch.Tensor, em: torch.Tensor,
                           s: torch.Tensor, n_max: int, method: str,
                           off_tol=0.0):
    """``algorithm=1`` on the leading blocks: SVD s = U1 S1 V1^T, scale by
    S1^-1/2, project ep and em, Cholesky both, C = Lm^T Lp, SVD C = U2 S2
    V2^T; the eigenvalues are the n_max smallest singular values of C
    (ascending), the components xp = V1s Lm U2 and xm = U1s Lp V2 scaled
    by 1/(sqrt(2) w).  Singular vectors may differ in sign between LAPACK
    builds; only the products xp, xm enter the result.  ``method`` /
    ``off_tol``: the reduced route and its Jacobi target."""
    L = s.shape[0]
    u1, s1, vt1 = _hp_svd(s, method, off_tol)
    inv_sqrt = 1.0 / torch.sqrt(s1)
    u1s = u1 * inv_sqrt[None, :]
    vt1s = vt1 * inv_sqrt[:, None]
    ept = vt1s @ (_sym(ep) @ vt1s.T)
    emt = u1s.T @ (_sym(em) @ u1s)
    lp = reduced.cholesky(_sym(ept), method)
    lm = reduced.cholesky(_sym(emt), method)
    u2, s2, vt2 = _hp_svd(lm.T @ lp, method, off_tol)
    pos = L - 1 - torch.arange(n_max, device=s.device)
    eig = s2[pos]
    scale = 1.0 / (math.sqrt(2.0) * eig)
    up = (vt1s.T @ (lm @ u2))[:, pos] * scale[None, :]
    um = (u1s @ (lp @ vt2.T))[:, pos] * scale[None, :]
    return eig, up, um


def _gram_update(gmat: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                 ldu: int, n_act: int, n_max: int) -> torch.Tensor:
    """``gmat = left @ right^T`` after n_act new rows were appended to both
    ``left`` and ``right`` at row ``ldu``: only the new rows and columns
    are computed."""
    lblk = gather_rows(left, ldu, n_max, count=n_act)
    rblk = gather_rows(right, ldu, n_max, count=n_act)
    g = scatter_rows(gmat, mmT(lblk, right), ldu)
    return scatter_rows(g.T, mmT(rblk, left), ldu).T


def caslr(apbmul, ambmul, spdmul, smdmul, lrprec, evec_guess: torch.Tensor,
          options: SolverOptions, *, algorithm: int = 0,
          generator: torch.Generator | None = None,
          sharding=None) -> LRSolverResult:
    """Casida solver with plain-orthonormal expansion spaces.

    Args:
      apbmul, ambmul, spdmul, smdmul: linear callbacks ``(k, n) -> (k, n)``
        applying A+B, A-B, S+D and S-D to row blocks.
      lrprec: ``(w, rp, rm) -> (yp, ym)``, called with the first active
        eigenvalue as a 0-d tensor.
      evec_guess: (n_max, 2n) paired rows (Y, Z); its dtype and device are
        the solve's.  Zero rows of Y+Z or Y-Z are filled from
        ``generator`` (the vp rows first, then the vm rows).
      options: SolverOptions.
      algorithm: 0 = the inverse pencil, 1 = Helmich-Paris.
      sharding: optional VectorSharding; the guess and the returned
        ``evec`` are then ``[Y_local | Z_local]`` and the callbacks get
        and return the rank's column shards.

    Returns an LRSolverResult: eigenvalues w ascending and paired
    eigenvectors (Y, Z).
    """
    if algorithm not in (0, 1):
        raise ValueError("algorithm must be 0 or 1")
    with routing_for(options, "caslr"), mm_sharding(sharding):
        return _caslr_impl(apbmul, ambmul, spdmul, smdmul, lrprec,
                           evec_guess, options, algorithm, generator,
                           sharding)


def caslr_eff(apbmul, ambmul, spdmul, smdmul, lrprec,
              evec_guess: torch.Tensor, options: SolverOptions, *,
              generator: torch.Generator | None = None,
              sharding=None) -> LRSolverResult:
    """Efficient Casida solver with (A+B)- and (A-B)-orthonormal expansion
    vectors.  Arguments and result as :func:`caslr`; ``lrprec`` is called
    with the internal 1/w of the first active root."""
    with routing_for(options, "caslr_eff"), mm_sharding(sharding):
        return _caslr_impl(apbmul, ambmul, spdmul, smdmul, lrprec,
                           evec_guess, options, None, generator, sharding)


def _caslr_impl(apbmul, ambmul, spdmul, smdmul, lrprec, evec_guess, options,
                algorithm, generator, sharding):
    """The loop of both solvers; ``algorithm`` None is ``caslr_eff``."""
    eff = algorithm is None
    name = "caslr_eff" if eff else "caslr"
    method = reduced.resolve(options.reduced_solver)
    n_targ, n_max = options.n_targ, options.n_max
    lda_pad = options.dim_dav * n_max + n_max
    max_iter = options.max_iter
    vp0, vm0, n = _split_guess(evec_guess, n_max)
    dtype, dev = evec_guess.dtype, evec_guess.device
    sqrtn = math.sqrt(global_n(n, sharding))
    sqrt2 = math.sqrt(2.0)
    targ = torch.arange(n_max, device=dev) < n_targ

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def masked(x, mask):
        return torch.where(mask[:, None], x, 0.0)

    vp0 = _nonzero_or_random(vp0, generator)
    vm0 = _nonzero_or_random(vm0, generator)
    # scatter_rows writes in place: every space is a buffer of its own
    lvp, lvm, bvp, bvm = (zeros(lda_pad, n) for _ in range(4))
    ortho_ok, n_matvec = True, 0
    if eff:
        # B-orthonormal start in the (A+B) / (A-B) metrics
        vp0, lvp0, ok_p = b_ortho(vp0, apbmul(vp0))
        vm0, lvm0, ok_m = b_ortho(vm0, ambmul(vm0))
        scatter_rows(lvp, lvp0, 0), scatter_rows(lvm, lvm0, 0)
        ortho_ok, n_matvec = ok_p and ok_m, 2 * n_max
    else:
        vp0, _, _ = ortho_cd(vp0)
        vm0, _, _ = ortho_cd(vm0)
    vp = scatter_rows(zeros(lda_pad, n), vp0, 0)
    vm = scatter_rows(zeros(lda_pad, n), vm0, 0)
    epmat, emmat, smat = (zeros(lda_pad, lda_pad) for _ in range(3))
    ldu, n_act, m_dim = 0, n_max, 1
    eig = zeros(n_max)
    evec = zeros(n_max, 2 * n)
    done = torch.zeros((n_max,), dtype=torch.bool, device=dev)
    rms = torch.full((n_max,), math.inf, dtype=dtype, device=dev)
    rmx = torch.full((n_max,), math.inf, dtype=dtype, device=dev)
    ok, it = False, 0
    eig_h = zeros(max_iter, n_max)
    rms_h = torch.full((max_iter, n_max), math.inf, dtype=dtype, device=dev)
    max_h = torch.full((max_iter, n_max), math.inf, dtype=dtype, device=dev)

    while not ok and it < max_iter:
        ldu_new = ldu + n_act
        amask = torch.arange(n_max, device=dev) < n_act

        def apply_new(op, space, target):
            out = op(gather_rows(space, ldu, n_max, count=n_act))
            return scatter_rows(target, masked(out, amask), ldu)

        if not eff:
            lvp = apply_new(apbmul, vp, lvp)
            lvm = apply_new(ambmul, vm, lvm)
        bvm = apply_new(spdmul, vp, bvm)     # (S+D) vp
        bvp = apply_new(smdmul, vm, bvp)     # (S-D) vm
        n_matvec += (2 if eff else 4) * n_act

        col_ok = prefix_mask(lda_pad, ldu_new, device=dev)
        smat = _gram_update(smat, vm, bvm, ldu, n_act, n_max)
        lead = slice(0, ldu_new)
        off_tol = 0.0
        if method == "jacobi":
            # the reference's adaptive Jacobi target, an order tighter
            # than the symmetric drivers' (the eigenvalue map adds one)
            prev_rms = torch.where(~done, rms, math.inf).min()
            off_tol = torch.clamp(1e-3 * prev_rms, 0.0, 1e-5)
        if eff:
            # the reduced problem s^T s u+ = (1/w)^2 u+, largest first
            smat = torch.where(col_ok[:, None] & col_ok[None, :], smat, 0.0)
            s_l = smat[lead, lead]
            e_red, c = reduced.eigh(s_l.T @ s_l, method, off_tol=off_tol)
            inv_w = torch.sqrt(e_red.flip(0)[:n_max].abs())
            up = scatter_rows(zeros(lda_pad, n_max), c.flip(1)[:, :n_max], 0)
            um = mm(smat, up) / inv_w[None, :]
            eig = 1.0 / inv_w
        else:
            epmat = _gram_update(epmat, vp, lvp, ldu, n_act, n_max)
            emmat = _gram_update(emmat, vm, lvm, ldu, n_act, n_max)
            solve = (_reduced_inverse_pencil if algorithm == 0
                     else _reduced_helmich_paris)
            eig, up, um = solve(epmat[lead, lead], emmat[lead, lead],
                                smat[lead, lead], n_max, method, off_tol)
            up = scatter_rows(zeros(lda_pad, n_max), up, 0)
            um = scatter_rows(zeros(lda_pad, n_max), um, 0)

        eigp = mTm(up, vp)
        eigm = mTm(um, vm)
        evec = _combine(eigp, eigm)
        if eff:
            rp = mTm(um, bvp) - inv_w[:, None] * mTm(up, lvp)
            rm = mTm(up, bvm) - inv_w[:, None] * mTm(um, lvm)
            scale = inv_w * sqrt2
        else:
            rp = mTm(up, lvp) - eig[:, None] * mTm(um, bvp)
            rm = mTm(um, lvm) - eig[:, None] * mTm(up, bvm)
            scale = 1.0

        active = ~done & targ
        rms = torch.where(active, (norm_n(rp) + norm_n(rm))
                          / (scale * sqrtn), rms)
        rmx = torch.where(active, (amax_n(rp.abs()) + amax_n(rm.abs()))
                          / scale, rmx)
        conv = (rms < options.tol) & (rmx < options.tol_max) & (it > 0)
        done = prefix_lock(done, conv, n_targ)
        ok = bool(done[:n_targ].all())

        eig_h[it] = eig
        rms_h[it] = rms
        max_h[it] = rmx
        if options.verbose:
            inflight_progress(name, it, n_act, eig_h[it], rms, rmx)

        n_frozen = int(done.sum())
        n_act_new = n_max - n_frozen
        if ok:
            ldu = ldu_new
        elif m_dim < options.dim_dav:
            # expand: precondition the active residuals, orthogonalize them
            # against their space (in its metric for caslr_eff), append
            umask = torch.arange(n_max, device=dev) < n_act_new
            rpb = gather_rows(rp, n_frozen, n_max, count=n_act_new)
            rmb = gather_rows(rm, n_frozen, n_max, count=n_act_new)
            fac = inv_w[n_frozen] if eff else eig[n_frozen]
            yp, ym = lrprec(fac, rpb, rmb)
            yp, ym = masked(yp, umask), masked(ym, umask)
            if eff:
                yp, p_done = b_ortho_vs_x(vp, lvp, yp, xmask=col_ok,
                                          umask=umask)
                yp, lyp, bok_p = b_ortho(yp, masked(apbmul(yp), umask),
                                         umask)
                ym, m_done = b_ortho_vs_x(vm, lvm, ym, xmask=col_ok,
                                          umask=umask)
                ym, lym, bok_m = b_ortho(ym, masked(ambmul(ym), umask),
                                         umask)
                lvp = scatter_rows(lvp, lyp, ldu_new)
                lvm = scatter_rows(lvm, lym, ldu_new)
                p_done, m_done = p_done and bok_p, m_done and bok_m
            else:
                yp, p_done = ortho_vs_x(vp, yp, xmask=col_ok, umask=umask)
                ym, m_done = ortho_vs_x(vm, ym, xmask=col_ok, umask=umask)
            vp = scatter_rows(vp, yp, ldu_new)
            vm = scatter_rows(vm, ym, ldu_new)
            ldu, n_act, m_dim = ldu_new, n_act_new, m_dim + 1
            ortho_ok = ortho_ok and p_done and m_done
        else:
            # restart: collapse both spaces onto the Ritz components
            if eff:
                vpn, lvpn, ok_p = b_ortho(eigp, apbmul(eigp))
                vmn, lvmn, ok_m = b_ortho(eigm, ambmul(eigm))
                lvp = scatter_rows(zeros(lda_pad, n), lvpn, 0)
                lvm = scatter_rows(zeros(lda_pad, n), lvmn, 0)
            else:
                vpn, _, ok_p = ortho_cd(eigp)
                vmn, _, ok_m = ortho_cd(eigm)
                lvp, lvm = zeros(lda_pad, n), zeros(lda_pad, n)
            vp = scatter_rows(zeros(lda_pad, n), vpn, 0)
            vm = scatter_rows(zeros(lda_pad, n), vmn, 0)
            bvp, bvm = zeros(lda_pad, n), zeros(lda_pad, n)
            ldu, n_act, m_dim = 0, n_max, 1
            ortho_ok = ortho_ok and ok_p and ok_m
        it += 1

    return LRSolverResult(eig=eig, evec=evec, ok=ok, n_iter=it,
                          n_matvec=n_matvec, done=done, rms_history=rms_h,
                          max_history=max_h, eig_history=eig_h,
                          ortho_ok=ortho_ok)
