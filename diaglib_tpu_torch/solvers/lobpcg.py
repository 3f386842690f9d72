"""LOBPCG eigensolver, standard and generalized (port of
``diaglib_tpu/solvers/lobpcg.py``).

The loop is eager Python over the reference's state: each of the blocks
X, P and W owns a fixed ``n_max``-row slot of ``space: (3*n_max, n)`` and
validity masks carry the active counts, so the reduced problem and every
rotation match the reference row for row.

Semantics kept from the reference:

* a Rayleigh-Ritz of the (B-orthonormalized) guess, then an explicit first
  W block from the preconditioned residuals;
* per iteration: the matvec on W only, the full reduced Gram over the
  valid slots, a masked eigh, and the rotation of x / ax / bx;
* P from coefficient differences orthogonalized against the new X
  coefficients, so P costs no matvecs;
* the diagonal level shift is added to A by the driver and removed from
  the reported eigenvalues; the preconditioner gets ``shift - eig[0]``;
* the generalized path keeps X, P and W B-orthonormal through
  ``b_ortho_vs_x`` + ``bvec`` + ``b_ortho``;
* locking scans all n_max roots; convergence needs the first n_targ.

Sharded (``sharding=``), as :func:`~.davidson.davidson`: the blocks are
column shards, the rms uses the global n and every n-axis reduction is
all-reduced; the P step orthogonalizes replicated coefficients and
reduces nothing.
"""

from __future__ import annotations

import math

import torch

from ..ortho.core import b_ortho, b_ortho_vs_x, ortho_vs_x
from ..reporting import inflight_progress
from ..types import SolverOptions, SolverResult
from ..utils import reduced
from ..utils.guess import check_guess
from ..utils.masking import gather_rows, masked_eigh, prefix_lock
from ..utils.mm import (
    amax_n,
    global_n,
    mm,
    mm_sharding,
    mmT,
    mTm,
    norm_n,
    routing_for,
)

__all__ = ["lobpcg"]


def lobpcg(matvec, precnd, evec_guess: torch.Tensor, options: SolverOptions,
           *, bvec=None, generator: torch.Generator | None = None,
           sharding=None) -> SolverResult:
    """Locally optimal block preconditioned CG for A x = lambda x (or
    lambda B x with ``bvec``).

    Args:
      matvec: ``(k, n) -> (k, n)`` applying A to row vectors.
      precnd: ``(shift, (k, n)) -> (k, n)``.
      evec_guess: (n_max, n) guess rows; its dtype and device are the
        solve's.  Zeros mean a random start from ``generator``.
      options: SolverOptions; ``options.shift`` is added to A by the driver
        and removed from the reported eigenvalues.
      bvec: the SPD metric's apply for the generalized problem.
      sharding: optional VectorSharding (see :func:`~.davidson.davidson`).
    """
    with routing_for(options, "lobpcg"), mm_sharding(sharding):
        return _lobpcg_impl(matvec, precnd, evec_guess, options, bvec,
                            generator, sharding)


def _lobpcg_impl(matvec, precnd, evec_guess, options, bvec, generator,
                 sharding):
    gen_eig = bvec is not None
    method = reduced.resolve(options.reduced_solver)
    n_targ, n_max = options.n_targ, options.n_max
    max_iter = options.max_iter
    if evec_guess.shape[0] != n_max:
        raise ValueError(f"guess must have n_max={n_max} rows")
    n = evec_guess.shape[1]
    dtype, dev = evec_guess.dtype, evec_guess.device
    len_a = 3 * n_max
    sqrtn = math.sqrt(global_n(n, sharding))
    tol_rms, tol_max = options.tol, options.tol_max
    shift = options.shift
    idx_b = torch.arange(n_max, device=dev)
    ones = torch.ones((n_max,), dtype=torch.bool, device=dev)

    def zeros(rows):
        return torch.zeros((rows, n), dtype=dtype, device=dev)

    def apply_a(x):
        return matvec(x) + shift * x

    def build_w(xp, bxp, r, n_frozen, n_act, eig0, p_valid):
        """Preconditioned residuals, orthogonalized against [X | P]."""
        umask = idx_b < n_act
        rblk = gather_rows(r, n_frozen, n_max, count=n_act)
        w = torch.where(umask[:, None], precnd(shift - eig0, rblk), 0.0)
        xmask = torch.cat([ones, p_valid])
        if gen_eig:
            w, o_done = b_ortho_vs_x(xp, bxp, w, xmask=xmask, umask=umask)
            bw = torch.where(umask[:, None], bvec(w), 0.0)
            w, bw, b_ok = b_ortho(w, bw, umask)
            o_done = o_done and b_ok
        else:
            w, o_done = ortho_vs_x(xp, w, xmask=xmask, umask=umask)
            bw = None
        return w, bw, o_done

    # ---- prologue: Rayleigh-Ritz of the guess + explicit first W block ----
    guess = check_guess(evec_guess, generator)
    ortho_ok = True
    if gen_eig:
        x, bx, ortho_ok = b_ortho(guess, bvec(guess))
    else:
        x, bx = guess, None
    ax = apply_a(x)
    g0 = mmT(x, ax)
    eig, c0 = reduced.eigh(0.5 * (g0 + g0.T), method)
    x = mTm(c0, x)
    ax = mTm(c0, ax)
    if gen_eig:
        bx = mTm(c0, bx)
    r0 = ax - eig[:, None] * (bx if gen_eig else x)
    w0, bw0, o_done0 = build_w(
        torch.cat([x, zeros(n_max)]),
        torch.cat([bx, zeros(n_max)]) if gen_eig else None,
        r0, 0, n_max, float(eig[0]), idx_b < 0)
    ortho_ok = ortho_ok and o_done0

    space = torch.cat([x, zeros(n_max), w0])
    aspace = torch.cat([ax, zeros(2 * n_max)])
    bspace = torch.cat([bx, zeros(n_max), bw0]) if gen_eig else None
    n_act, p_count = n_max, 0
    evec = x
    done = torch.zeros((n_max,), dtype=torch.bool, device=dev)
    rms = torch.full((n_max,), math.inf, dtype=dtype, device=dev)
    rmx = torch.full((n_max,), math.inf, dtype=dtype, device=dev)
    ok, n_matvec, it = False, n_max, 0
    eig_h = torch.zeros((max_iter, n_max), dtype=dtype, device=dev)
    rms_h = torch.full((max_iter, n_max), math.inf, dtype=dtype, device=dev)
    max_h = torch.full((max_iter, n_max), math.inf, dtype=dtype, device=dev)

    while not ok and it < max_iter:
        w_mask = idx_b < n_act
        p_valid = idx_b < p_count
        aw = torch.where(w_mask[:, None], apply_a(space[2 * n_max:]), 0.0)
        aspace = torch.cat([aspace[:2 * n_max], aw])
        n_matvec += n_act

        mask = torch.cat([ones, p_valid, w_mask])
        g = mmT(space, aspace)
        off_tol = 0.0
        if method == "jacobi":
            # the adaptive Jacobi target of the reference (see davidson)
            prev_rms = torch.where(~done, rms, math.inf).min()
            scale = torch.clamp(eig.abs().max(), min=1.0)
            off_tol = torch.clamp(0.01 * prev_rms / scale, 0.0, 1e-5)
        e_red, c_full = masked_eigh(0.5 * (g + g.T), mask, method,
                                    off_tol=off_tol)
        eig = e_red[:n_max]
        c = c_full[:, :n_max]                       # (3*n_max, n_max)
        x_new = mTm(c, space)
        ax_new = mTm(c, aspace)
        bx_new = mTm(c, bspace) if gen_eig else None

        r = ax_new - eig[:, None] * (bx_new if gen_eig else x_new)
        active = ~done
        rms = torch.where(active, norm_n(r) / sqrtn, rms)
        rmx = torch.where(active, amax_n(r.abs()), rmx)
        conv = (rms < tol_rms) & (rmx < tol_max) & (it > 0)
        done = prefix_lock(done, conv, n_max)
        ok = bool(done[:n_targ].all())

        eig_h[it] = eig - shift
        rms_h[it] = rms
        max_h[it] = rmx
        if options.verbose:
            inflight_progress("lobpcg", it, n_act, eig_h[it], rms, rmx)
        evec = x_new

        if not ok:
            n_frozen = int(done.sum())
            n_act_new = n_max - n_frozen
            # P from coefficient differences: the new X coefficients of the
            # active roots minus their old-X component, orthogonalized
            # against all new X coefficients
            u_x = c.T                               # (n_max, 3*n_max)
            u_p = gather_rows(u_x, n_frozen, n_max, count=n_act_new)
            umask = idx_b < n_act_new
            onehots = torch.nn.functional.one_hot(
                n_frozen + idx_b, len_a).to(dtype)
            u_p = u_p - torch.where(umask[:, None], onehots, 0.0)
            with mm_sharding(None):         # replicated coefficients
                u_p, p_done = ortho_vs_x(u_x, u_p, umask=umask)
            p_new = mm(u_p, space)
            ap_new = mm(u_p, aspace)
            space = torch.cat([x_new, p_new, zeros(n_max)])
            aspace = torch.cat([ax_new, ap_new, zeros(n_max)])
            if gen_eig:
                bspace = torch.cat([bx_new, mm(u_p, bspace), zeros(n_max)])
            w_new, bw_new, w_done = build_w(
                space[:2 * n_max],
                bspace[:2 * n_max] if gen_eig else None,
                r, n_frozen, n_act_new, float(eig[0]), umask)
            space[2 * n_max:] = w_new
            if gen_eig:
                bspace[2 * n_max:] = bw_new
            n_act, p_count = n_act_new, n_act_new
            ortho_ok = ortho_ok and p_done and w_done
        it += 1

    return SolverResult(
        eig=eig - shift,
        evec=evec,
        ok=ok,
        n_iter=it,
        n_matvec=n_matvec,
        done=done,
        rms_history=rms_h,
        max_history=max_h,
        eig_history=eig_h,
        ortho_ok=ortho_ok,
    )
