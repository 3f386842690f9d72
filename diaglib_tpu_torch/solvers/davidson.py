"""Block Davidson-Liu eigensolvers, standard and generalized (port of
``diaglib_tpu/solvers/davidson.py``).

The loop is eager Python over the same state as the JAX package's
``lax.while_loop``: the expansion space lives in a fixed ``(lda_pad, n)``
buffer (``lda = dim_dav*n_max`` plus one block of scatter padding) with a
row count ``ldu``, so the state matches the reference row for row.

Semantics kept from the reference:

* incremental reduced-matrix update — only the new block's rows of
  ``a_red`` are computed each iteration;
* contiguous-prefix locking with no locking at iteration 0; locked roots
  stay in the space but their residuals and updates are skipped;
* the preconditioner gets the single shift ``-eig[n_frozen]`` of the first
  active root;
* restart when the space is full: collapse onto the Ritz vectors and skip
  the matvecs of locked roots at the next iteration by seeding the reduced
  matrix's diagonal with their eigenvalues;
* dual tolerance: rms = ||r||/sqrt(n) < tol and max|r| < 10*tol;
* ``ortho_ok``, per-iteration histories and ``n_matvec`` counting;
* the phase scopes ``matvec``, ``rayleigh-ritz`` and ``expand-ortho``
  (``torch.profiler.record_function``, the reference's
  ``jax.named_scope``), which a ``profiling.trace`` attributes time to.

Sharded (``sharding=`` a :class:`~diaglib_tpu_torch.parallel.VectorSharding`):
every (k, n) block is the rank's column shard, ``n`` in the rms is the
global length, and the Gram products, norms and maxima are all-reduced
(``utils.mm.mm_sharding``), so every rank holds the same reduced matrix
and eigenvalues and takes the same branch.

Generalized path (``gen_david``, A x = lambda B x): the expansion space is
kept B-orthonormal, so the reduced problem stays a standard symmetric one;
``bspace`` holds B times the space, the residual uses B times the Ritz
vectors, and a restart re-B-orthonormalizes the Ritz block with ``bspace``
kept consistent (the reference's fix of the Fortran restart).
"""

from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from ..ortho.core import b_ortho, b_ortho_vs_x, ortho_vs_x
from ..reporting import inflight_progress
from ..types import SolverOptions, SolverResult
from ..utils.guess import check_guess
from ..utils.masking import (
    gather_rows,
    masked_eigh_prefix,
    prefix_lock,
    prefix_mask,
    scatter_rows,
)
from ..utils.mm import (
    amax_n,
    global_n,
    mm_sharding,
    mmT,
    mTm,
    norm_n,
    routing_for,
)
from ..utils.reduced import resolve

__all__ = ["davidson", "gen_david"]


def davidson(matvec, precnd, evec_guess: torch.Tensor,
             options: SolverOptions, *,
             generator: torch.Generator | None = None,
             sharding=None) -> SolverResult:
    """Compute the lowest eigenpairs of a symmetric operator.

    Args:
      matvec: linear callback ``(k, n) -> (k, n)`` (rows are vectors); must
        map zero rows to zero rows.
      precnd: ``(shift, (k, n)) -> (k, n)`` preconditioner.
      evec_guess: (n_max, n) initial guess rows; its dtype and device are
        the solve's.  Zeros mean a random start from ``generator``.
      options: SolverOptions.
      sharding: optional VectorSharding; ``evec_guess``, the callbacks'
        blocks and the returned ``evec`` are then this rank's column
        shards.

    Returns a SolverResult; ``eig``/``evec`` hold the n_max Ritz pairs
    (shift removed from eig).
    """
    with routing_for(options, "davidson"), mm_sharding(sharding):
        return _davidson_impl(matvec, precnd, None, evec_guess, options,
                              generator, sharding)


def gen_david(matvec, precnd, bvec, evec_guess: torch.Tensor,
              options: SolverOptions, *,
              generator: torch.Generator | None = None,
              sharding=None) -> SolverResult:
    """Generalized Davidson for A x = lambda B x with a B-orthonormal
    expansion space.

    ``bvec`` applies the SPD metric B to a row block; the other arguments
    are :func:`davidson`'s.  The returned eigenvectors are B-orthonormal.
    """
    with routing_for(options, "gen_david"), mm_sharding(sharding):
        return _davidson_impl(matvec, precnd, bvec, evec_guess, options,
                              generator, sharding)


def _davidson_impl(matvec, precnd, bvec, evec_guess, options, generator,
                   sharding):
    gen_eig = bvec is not None
    method = resolve(options.reduced_solver)
    n_targ, n_max = options.n_targ, options.n_max
    lda = options.dim_dav * n_max
    lda_pad = lda + n_max
    max_iter = options.max_iter
    k_rows, n = evec_guess.shape
    if k_rows != n_max:
        raise ValueError(f"guess must have n_max={n_max} rows, got {k_rows}")
    dtype, dev = evec_guess.dtype, evec_guess.device
    sqrtn = math.sqrt(global_n(n, sharding))
    tol_rms, tol_max = options.tol, options.tol_max
    rows_max = torch.arange(n_max, device=dev)
    targ = rows_max < n_targ

    guess = check_guess(evec_guess, generator)
    ortho_ok = True
    if gen_eig:
        guess, bguess, ortho_ok = b_ortho(guess, bvec(guess))
    space = scatter_rows(torch.zeros((lda_pad, n), dtype=dtype, device=dev),
                         guess, 0)
    aspace = torch.zeros((lda_pad, n), dtype=dtype, device=dev)
    bspace = (scatter_rows(torch.zeros_like(space), bguess, 0) if gen_eig
              else None)
    a_red = torch.zeros((lda_pad, lda_pad), dtype=dtype, device=dev)
    ldu, n_act, n_rst, m_dim = 0, n_max, 0, 1
    eig = torch.zeros((n_max,), dtype=dtype, device=dev)
    evec = torch.zeros((n_max, n), dtype=dtype, device=dev)
    done = torch.zeros((n_max,), dtype=torch.bool, device=dev)
    rms = torch.full((n_max,), math.inf, dtype=dtype, device=dev)
    rmx = torch.full((n_max,), math.inf, dtype=dtype, device=dev)
    ok, n_matvec, it = False, 0, 0
    eig_h = torch.zeros((max_iter, n_max), dtype=dtype, device=dev)
    rms_h = torch.full((max_iter, n_max), math.inf, dtype=dtype, device=dev)
    max_h = torch.full((max_iter, n_max), math.inf, dtype=dtype, device=dev)

    while not ok and it < max_iter:
        ldu_new = ldu + n_act
        # the matvec block starts past the n_rst roots whose products are
        # skipped right after a restart; n_rst is 0 on the normal path
        start = ldu + n_rst
        width_valid = ldu_new - start

        with record_function("matvec"):
            block = gather_rows(space, start, n_max, count=width_valid)
            ablock = matvec(block)
            ablock[width_valid:] = 0
            aspace = scatter_rows(aspace, ablock, start)
        n_matvec += n_act

        # incremental reduced-matrix rows: a_red[g, j] = aspace_g . space_j
        # (lower triangle filled by rows)
        col_ok = prefix_mask(lda_pad, ldu_new, device=dev)
        new_rows = torch.where(col_ok[None, :], mmT(ablock, space), 0.0)
        a_red = scatter_rows(a_red, new_rows, start)

        with record_function("rayleigh-ritz"):
            sym = torch.tril(a_red) + torch.tril(a_red, diagonal=-1).T
            off_tol = 0.0
            if method == "jacobi":
                # the reference's adaptive Jacobi target: the intermediate
                # solves stay two orders below the current residual level
                # and tighten to eps as the roots converge
                prev_rms = torch.where(~done & targ, rms, math.inf).min()
                scale = torch.clamp(eig.abs().max(), min=1.0)
                off_tol = torch.clamp(0.01 * prev_rms / scale, 0.0, 1e-5)
            e_red, c_full = masked_eigh_prefix(sym, ldu_new, method,
                                               off_tol=off_tol)
            eig = e_red[:n_max]
            c = c_full[:, :n_max]                      # (lda_pad, n_max)
            evec = mTm(c, space)
            metric_evec = mTm(c, bspace) if gen_eig else evec
            r = mTm(c, aspace) - eig[:, None] * metric_evec

        active = ~done & targ
        rms = torch.where(active, norm_n(r) / sqrtn, rms)
        rmx = torch.where(active, amax_n(r.abs()), rmx)
        conv = (rms < tol_rms) & (rmx < tol_max) & (it > 0)
        done = prefix_lock(done, conv, n_targ)
        ok = bool(done[:n_targ].all())

        eig_h[it] = eig - options.shift
        rms_h[it] = rms
        max_h[it] = rmx
        if options.verbose:
            inflight_progress("davidson", it, n_act, eig_h[it], rms, rmx)

        n_frozen = int(done.sum())
        n_act_new = n_max - n_frozen
        if ok:
            ldu, n_rst = ldu_new, 0
        elif m_dim < options.dim_dav:
            # expand: precondition the active residuals, orthogonalize them
            # against the space and append them
            with record_function("expand-ortho"):
                shift = -float(eig[n_frozen])
                rblk = gather_rows(r, n_frozen, n_max, count=n_act_new)
                pre = precnd(shift, rblk)
                pre[n_act_new:] = 0
                umask = rows_max < n_act_new
                if gen_eig:
                    unew, o_done = b_ortho_vs_x(space, bspace, pre,
                                                xmask=col_ok, umask=umask)
                    bnew = torch.where(umask[:, None], bvec(unew), 0.0)
                    unew, bnew, b_ok = b_ortho(unew, bnew, umask)
                    o_done = o_done and b_ok
                    bspace = scatter_rows(bspace, bnew, ldu_new)
                else:
                    unew, o_done = ortho_vs_x(space, pre, xmask=col_ok,
                                              umask=umask)
                space = scatter_rows(space, unew, ldu_new)
            ldu, n_act, n_rst, m_dim = ldu_new, n_act_new, 0, m_dim + 1
            ortho_ok = ortho_ok and o_done
        else:
            # restart: collapse onto the Ritz vectors (re-B-orthonormalized
            # on the generalized path, bspace kept with them); seed the
            # locked eigenvalues so their matvecs are skipped next iteration
            ev = evec
            if gen_eig:
                ev, bev, b_ok = b_ortho(evec, metric_evec)
                bspace = scatter_rows(torch.zeros_like(bspace), bev, 0)
                ortho_ok = ortho_ok and b_ok
            space = scatter_rows(torch.zeros_like(space), ev, 0)
            aspace = torch.zeros_like(aspace)
            seed = torch.zeros((lda_pad,), dtype=dtype, device=dev)
            seed[:n_frozen] = eig[:n_frozen]
            a_red = torch.diag(seed)
            ldu, n_act, n_rst, m_dim = 0, n_max, n_frozen, 1
        it += 1

    return SolverResult(
        eig=eig - options.shift,
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
