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

The loop has the reference's shape: one fixed-shape state (fixed
``(lda_pad, n)`` buffers, the reduced Gram matrices updated only in their
new rows and columns, every count a 0-d tensor on the device) and an
iteration in steps that read nothing back (:class:`_CaslrIteration`).  On
CUDA tensors each step is captured once a solve as a CUDA graph and
replayed (``utils/graphs.py``); the host reads the device once an
iteration, the packed flags after the ritz step, beside the reduced
solve's own checks.  The expand or restart step keeps its inputs (the
preconditioned block; the Ritz components), so one whose unrolled ortho
loops fell short is run again uncaptured from them.  A ``sharding=`` run
over an NCCL group is captured the same way on every rank, its
collectives inside the graphs; CPU tensors and gloo groups call the same
steps directly, with the ortho loops reading their predicates.

The reduced solves stay between the steps: they work on the leading
``ldu x ldu`` block directly, so the reference's prefix buckets with
identity or large-negative padding are not carried, and write into fixed
padded buffers.  They take ``options.reduced_solver`` and, on the Jacobi
route, the reference's adaptive off-norm target; there the Helmich-Paris
SVDs are the two-sided (augmented) ``jacobi_svd``, as the reference calls
them.

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

from ..ortho.core import (
    _b_ortho,
    _b_ortho_vs_x,
    _ortho_cd,
    _ortho_vs_x,
    b_ortho,
    ortho_cd,
)
from ..reporting import inflight_progress
from ..types import LRSolverResult, SolverOptions
from ..utils import reduced
from ..utils.graphs import StepLoop, StepState, _budgets, _route
from ..utils.jacobi import jacobi_svd
from ..utils.masking import gather_rows, prefix_lock, scatter_rows
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
                 ldu, n_act, n_max: int) -> torch.Tensor:
    """``gmat = left @ right^T`` after n_act new rows were appended to both
    ``left`` and ``right`` at row ``ldu`` (ints or 0-d tensors): only the
    new rows and columns are computed, in place."""
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


class _CaslrIteration(StepState):
    """One solve's fixed-shape state and the steps of an iteration over
    it, the reference's Casida loop state and body.  Every buffer is
    allocated once and written in place: the spaces vp, vm, their
    operator images lvp, lvm ((A+B) vp, (A-B) vm) and metric images bvm,
    bvp ((S+D) vp, (S-D) vm) as ``(lda_pad, n)``, the reduced Gram
    matrices (smat; epmat and emmat for ``caslr``), the padded reduced
    eigenvectors up, um; every count (``ldu``, ``n_act``, ``ldu_new``,
    ``n_frozen``, ``it``) is a 0-d tensor:

    1. :meth:`matvec`: the new block under the operators (two for
       ``caslr_eff``, four for ``caslr``) and the new rows and columns of
       the Gram matrices; (between the steps, uncaptured) :meth:`reduced`,
       the reduced solve on the leading ``ldu_new`` block, whose size
       changes every iteration and whose library calls read their error
       flags, written into the padded buffers;
    2. :meth:`ritz`: the Ritz components, residuals, norms, locking,
       histories and the packed flags;
    3. :meth:`expand` or :meth:`restart`, as the host's count of
       expansions picks, each from inputs it keeps (the preconditioned
       block; the Ritz components) for a rerun.
    """

    BODIES = {"expand": "_expand_ortho", "restart": "_restart_body"}

    def __init__(self, ops, vp0, vm0, lvp0, lvm0, ortho_ok, options,
                 algorithm, sqrtn, budgets):
        (self.apbmul, self.ambmul, self.spdmul, self.smdmul,
         self.lrprec) = ops
        self.eff = algorithm is None
        self.algorithm = algorithm
        self.options, self.sqrtn = options, sqrtn
        n_max = self.n_max = options.n_max
        self.n_targ = options.n_targ
        lda_pad = options.dim_dav * n_max + n_max
        max_iter = options.max_iter
        n = vp0.shape[1]
        dtype, dev = vp0.dtype, vp0.device

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)

        def full(value, *shape, dt=dtype):
            return torch.full(shape, value, dtype=dt, device=dev)

        self.rows = torch.arange(n_max, device=dev)
        self.rows_pad = torch.arange(lda_pad, device=dev)
        self.targ = self.rows < self.n_targ
        self.vp = scatter_rows(zeros(lda_pad, n), vp0, 0)
        self.vm = scatter_rows(zeros(lda_pad, n), vm0, 0)
        self.lvp, self.lvm, self.bvp, self.bvm = (zeros(lda_pad, n)
                                                  for _ in range(4))
        if self.eff:
            scatter_rows(self.lvp, lvp0, 0)
            scatter_rows(self.lvm, lvm0, 0)
            self.epmat = self.emmat = None
        else:
            self.epmat, self.emmat = zeros(lda_pad, lda_pad), zeros(
                lda_pad, lda_pad)
        self.smat = zeros(lda_pad, lda_pad)
        self.up, self.um = zeros(lda_pad, n_max), zeros(lda_pad, n_max)
        self.inv_w = zeros(n_max)
        self.eig = zeros(n_max)
        self.eigp, self.eigm = zeros(n_max, n), zeros(n_max, n)
        self.evec = zeros(n_max, 2 * n)
        self.rp, self.rm = zeros(n_max, n), zeros(n_max, n)
        self.done = zeros(n_max, dt=torch.bool)
        self.rms = full(math.inf, n_max)
        self.rmx = full(math.inf, n_max)
        self.eig_h = zeros(max_iter, n_max)
        self.rms_h = full(math.inf, max_iter, n_max)
        self.max_h = full(math.inf, max_iter, n_max)
        i64 = torch.int64
        self.it = zeros(dt=i64)
        self.ldu = zeros(dt=i64)
        self.n_act = full(n_max, dt=i64)
        self.ldu_new = zeros(dt=i64)
        self.n_frozen = zeros(dt=i64)
        # the branch steps' inputs, kept for rerun
        self.pre_p, self.pre_m = zeros(n_max, n), zeros(n_max, n)
        self.ldu_new3 = zeros(dt=i64)
        self.n_act3 = zeros(dt=i64)
        self.eigp3, self.eigm3 = zeros(n_max, n), zeros(n_max, n)
        self._init_steps(ortho_ok, budgets, dev)

    def _masked(self, x, mask):
        return torch.where(mask[:, None], x, 0.0)

    # ---- step 1 ----
    def matvec(self):
        n_max, ldu, n_act = self.n_max, self.ldu, self.n_act
        amask = self.rows < n_act

        def apply_new(op, space, target):
            out = op(gather_rows(space, ldu, n_max, count=n_act))
            scatter_rows(target, self._masked(out, amask), ldu)

        if not self.eff:
            apply_new(self.apbmul, self.vp, self.lvp)
            apply_new(self.ambmul, self.vm, self.lvm)
        apply_new(self.spdmul, self.vp, self.bvm)     # (S+D) vp
        apply_new(self.smdmul, self.vm, self.bvp)     # (S-D) vm
        ldu_new = ldu + n_act
        _gram_update(self.smat, self.vm, self.bvm, ldu, n_act, n_max)
        if self.eff:
            col_ok = self.rows_pad < ldu_new
            self.smat.copy_(torch.where(col_ok[:, None] & col_ok[None, :],
                                        self.smat, 0.0))
        else:
            _gram_update(self.epmat, self.vp, self.lvp, ldu, n_act, n_max)
            _gram_update(self.emmat, self.vm, self.lvm, ldu, n_act, n_max)
        self.ldu_new.copy_(ldu_new)

    # ---- between the steps ----
    def reduced(self, ldu_new: int, method: str):
        n_max = self.n_max
        lead = slice(0, ldu_new)
        off_tol = 0.0
        if method == "jacobi":
            # the reference's adaptive Jacobi target, an order tighter
            # than the symmetric drivers' (the eigenvalue map adds one)
            prev_rms = torch.where(~self.done, self.rms, math.inf).min()
            off_tol = torch.clamp(1e-3 * prev_rms, 0.0, 1e-5)
        if self.eff:
            # the reduced problem s^T s u+ = (1/w)^2 u+, largest first
            s_l = self.smat[lead, lead]
            e_red, c = reduced.eigh(s_l.T @ s_l, method, off_tol=off_tol)
            self.inv_w.copy_(torch.sqrt(e_red.flip(0)[:n_max].abs()))
            up = c.flip(1)[:, :n_max]
        else:
            solve = (_reduced_inverse_pencil if self.algorithm == 0
                     else _reduced_helmich_paris)
            eig, up, um = solve(self.epmat[lead, lead],
                                self.emmat[lead, lead],
                                self.smat[lead, lead], n_max, method, off_tol)
            self.eig.copy_(eig)
            scatter_rows(self.um.zero_(), um, 0)
        scatter_rows(self.up.zero_(), up, 0)

    # ---- step 2 ----
    def ritz(self):
        self.keep_ritz()
        opts = self.options
        if self.eff:
            self.um.copy_(mm(self.smat, self.up) / self.inv_w[None, :])
            self.eig.copy_(1.0 / self.inv_w)
        up, um, eig, inv_w = self.up, self.um, self.eig, self.inv_w
        eigp = mTm(up, self.vp)
        eigm = mTm(um, self.vm)
        if self.eff:
            rp = mTm(um, self.bvp) - inv_w[:, None] * mTm(up, self.lvp)
            rm = mTm(up, self.bvm) - inv_w[:, None] * mTm(um, self.lvm)
            scale = inv_w * math.sqrt(2.0)
        else:
            rp = mTm(up, self.lvp) - eig[:, None] * mTm(um, self.bvp)
            rm = mTm(um, self.lvm) - eig[:, None] * mTm(up, self.bvm)
            scale = 1.0
        active = ~self.done & self.targ
        rms = torch.where(active, (norm_n(rp) + norm_n(rm))
                          / (scale * self.sqrtn), self.rms)
        rmx = torch.where(active, (amax_n(rp.abs()) + amax_n(rm.abs()))
                          / scale, self.rmx)
        conv = (rms < opts.tol) & (rmx < opts.tol_max) & (self.it > 0)
        done = prefix_lock(self.done, conv, self.n_targ)
        at = self.it.view(1)
        self.eig_h.index_copy_(0, at, eig[None])
        self.rms_h.index_copy_(0, at, rms[None])
        self.max_h.index_copy_(0, at, rmx[None])
        self.eigp.copy_(eigp)
        self.eigm.copy_(eigm)
        self.evec.copy_(_combine(eigp, eigm))
        self.rp.copy_(rp)
        self.rm.copy_(rm)
        self.rms.copy_(rms)
        self.rmx.copy_(rmx)
        self.done.copy_(done)
        self.ok.copy_(done[:self.n_targ].all())
        self.n_frozen.copy_(done.sum())
        self.it.add_(1)
        self.pack_flags()

    # ---- step 3 ----
    def expand(self):
        """Precondition the active residuals; then orthogonalize them
        against their space (in its metric for caslr_eff) and append
        them."""
        n_max, n_frozen = self.n_max, self.n_frozen
        n_act_new = n_max - n_frozen
        umask = self.rows < n_act_new
        rpb = gather_rows(self.rp, n_frozen, n_max, count=n_act_new)
        rmb = gather_rows(self.rm, n_frozen, n_max, count=n_act_new)
        first = n_frozen.clamp(max=n_max - 1).view(1)
        fac = (self.inv_w if self.eff else self.eig).index_select(
            0, first).reshape(())
        yp, ym = self.lrprec(fac, rpb, rmb)
        self.pre_p.copy_(self._masked(yp, umask))
        self.pre_m.copy_(self._masked(ym, umask))
        self.ldu_new3.copy_(self.ldu_new)
        self.n_act3.copy_(n_act_new)
        self._expand_ortho()

    def _expand_ortho(self):
        umask = self.rows < self.n_act3
        col_ok = self.rows_pad < self.ldu_new3
        with self._ortho() as rec:
            if self.eff:
                yp, p_done = _b_ortho_vs_x(self.vp, self.lvp, self.pre_p,
                                           xmask=col_ok, umask=umask)
                yp, lyp, bok_p = _b_ortho(
                    yp, self._masked(self.apbmul(yp), umask), umask)
                ym, m_done = _b_ortho_vs_x(self.vm, self.lvm, self.pre_m,
                                           xmask=col_ok, umask=umask)
                ym, lym, bok_m = _b_ortho(
                    ym, self._masked(self.ambmul(ym), umask), umask)
                scatter_rows(self.lvp, lyp, self.ldu_new3)
                scatter_rows(self.lvm, lym, self.ldu_new3)
                p_done, m_done = p_done & bok_p, m_done & bok_m
            else:
                yp, p_done = _ortho_vs_x(self.vp, self.pre_p, xmask=col_ok,
                                         umask=umask)
                ym, m_done = _ortho_vs_x(self.vm, self.pre_m, xmask=col_ok,
                                         umask=umask)
            scatter_rows(self.vp, yp, self.ldu_new3)
            scatter_rows(self.vm, ym, self.ldu_new3)
        self._close(p_done & m_done, rec)
        self.ldu.copy_(self.ldu_new3)
        self.n_act.copy_(self.n_act3)

    def restart(self):
        """Collapse both spaces onto the Ritz components (in their metrics
        for caslr_eff)."""
        self.eigp3.copy_(self.eigp)
        self.eigm3.copy_(self.eigm)
        self._restart_body()

    def _restart_body(self):
        with self._ortho() as rec:
            if self.eff:
                vpn, lvpn, ok_p = _b_ortho(self.eigp3,
                                           self.apbmul(self.eigp3))
                vmn, lvmn, ok_m = _b_ortho(self.eigm3,
                                           self.ambmul(self.eigm3))
                scatter_rows(self.lvp.zero_(), lvpn, 0)
                scatter_rows(self.lvm.zero_(), lvmn, 0)
            else:
                vpn, _, ok_p = _ortho_cd(self.eigp3)
                vmn, _, ok_m = _ortho_cd(self.eigm3)
                self.lvp.zero_()
                self.lvm.zero_()
            scatter_rows(self.vp.zero_(), vpn, 0)
            scatter_rows(self.vm.zero_(), vmn, 0)
        self.bvp.zero_()
        self.bvm.zero_()
        self._close(ok_p & ok_m, rec)
        self.ldu.zero_()
        self.n_act.fill_(self.n_max)


def _start(ops, evec_guess, options, algorithm, generator, sqrtn_of,
           budgets):
    """The prologue, uncaptured: split the paired guess, fill zero rows
    from ``generator``, orthonormalize both halves (in the (A+B) / (A-B)
    metrics for ``caslr_eff``); returns the iteration's state and the
    prologue's matvec count.  ``sqrtn_of(n)``: sqrt of the global n."""
    apbmul, ambmul = ops[:2]
    vp0, vm0, n = _split_guess(evec_guess, options.n_max)
    vp0 = _nonzero_or_random(vp0, generator)
    vm0 = _nonzero_or_random(vm0, generator)
    lvp0 = lvm0 = None
    if algorithm is None:
        # B-orthonormal start in the (A+B) / (A-B) metrics
        vp0, lvp0, ok_p = b_ortho(vp0, apbmul(vp0))
        vm0, lvm0, ok_m = b_ortho(vm0, ambmul(vm0))
        ortho_ok, n_matvec = ok_p and ok_m, 2 * options.n_max
    else:
        vp0, _, _ = ortho_cd(vp0)
        vm0, _, _ = ortho_cd(vm0)
        ortho_ok, n_matvec = True, 0
    st = _CaslrIteration(ops, vp0, vm0, lvp0, lvm0, ortho_ok, options,
                         algorithm, sqrtn_of(n), budgets)
    return st, n_matvec


def _caslr_impl(apbmul, ambmul, spdmul, smdmul, lrprec, evec_guess, options,
                algorithm, generator, sharding):
    """The loop of both solvers; ``algorithm`` None is ``caslr_eff``."""
    eff = algorithm is None
    name = "caslr_eff" if eff else "caslr"
    method = reduced.resolve(options.reduced_solver)
    n_max, max_iter = options.n_max, options.max_iter
    dev = evec_guess.device
    route = _route(dev, sharding)
    st, n_matvec = _start(
        (apbmul, ambmul, spdmul, smdmul, lrprec), evec_guess, options,
        algorithm, generator, lambda n: math.sqrt(global_n(n, sharding)),
        _budgets(route))
    loop = StepLoop(name, st, dev, route, _SCOPES)

    # the host's copies of the counts it needs: the reduced block's size
    # and the matvec count (ldu, n_act) and the branch (m_dim)
    ldu, n_act, m_dim = 0, n_max, 1
    ok, it = False, 0
    with loop:
        while not ok and it < max_iter:
            ldu_new = ldu + n_act
            ok, n_frozen = loop.iterate(lambda: st.reduced(ldu_new, method))
            n_matvec += (2 if eff else 4) * n_act
            if options.verbose:
                inflight_progress(name, it, n_act, st.eig_h[it], st.rms,
                                  st.rmx)
            if not ok:
                if m_dim < options.dim_dav:
                    loop.branch("expand")
                    ldu, n_act, m_dim = ldu_new, n_max - n_frozen, m_dim + 1
                else:
                    loop.branch("restart")
                    ldu, n_act, m_dim = 0, n_max, 1
            it += 1
        ortho_ok = loop.close()
    loop.record(it, st.eig.dtype, options.verbose)
    return LRSolverResult(eig=st.eig, evec=st.evec, ok=ok, n_iter=it,
                          n_matvec=n_matvec, done=st.done,
                          rms_history=st.rms_h, max_history=st.max_h,
                          eig_history=st.eig_h, ortho_ok=ortho_ok)


# the profiler scope of each step (the restart has none)
_SCOPES = {"matvec": "matvec", "ritz": "rayleigh-ritz",
           "expand": "expand-ortho"}
