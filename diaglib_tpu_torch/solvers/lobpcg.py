"""LOBPCG eigensolver, standard and generalized (port of
``diaglib_tpu/solvers/lobpcg.py``).

The loop has the reference's shape: one fixed-shape state (the
reference's ``_LobpcgState``: each of the blocks X, P and W owns a fixed
``n_max``-row slot of ``space: (3*n_max, n)``, with ``aspace`` and
``bspace`` beside it, and every count a 0-d tensor on the device) and an
iteration in steps that read nothing back (:class:`_LobpcgIteration`).
On CUDA tensors each step is captured once a solve as a CUDA graph and
replayed (``utils/graphs.py``); the host reads the device once an
iteration, the packed flags after the ritz step, beside the reduced
eigh's own check.  A ``sharding=`` run over an NCCL group is captured the
same way on every rank, its collectives inside the graphs; CPU tensors
and gloo groups call the same steps directly, with the ortho loops
reading their predicates.

The update step rewrites the whole ``[X | P | W]``, so a captured update
whose unrolled ortho loops fell short (found with the next iteration's
flags) cannot be rerun from the state as it then is.  The update
therefore first copies everything it reads (the three spaces, the Ritz
blocks x / ax / bx, the residuals, the X coefficients, eig and n_frozen)
into buffers of its own, and computes from those copies; a rerun runs it
again from them with the eager loops, which gives the loops' own result.

Semantics kept from the reference:

* a Rayleigh-Ritz of the (B-orthonormalized) guess, then an explicit first
  W block from the preconditioned residuals;
* per iteration: the matvec on W only, the full reduced Gram over the
  valid slots, a masked eigh (its padding made on the device, the eigh of
  the fixed ``(3 n_max)^2`` matrix between the steps), and the rotation of
  x / ax / bx;
* P from coefficient differences orthogonalized against the new X
  coefficients, so P costs no matvecs;
* the diagonal level shift is added to A by the driver and removed from
  the reported eigenvalues; the preconditioner gets ``shift - eig[0]``, a
  0-d tensor;
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

from ..ortho.core import _b_ortho, _b_ortho_vs_x, _ortho_vs_x
from ..reporting import inflight_progress
from ..types import SolverOptions, SolverResult
from ..utils import reduced
from ..utils.graphs import StepLoop, StepState, _budgets, _route
from ..utils.guess import check_guess
from ..utils.masking import gather_rows, masked_pad, prefix_lock
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


def _build_w(precnd, bvec, xp, bxp, r, n_frozen, n_act, shift, p_valid):
    """Preconditioned residuals (``n_act`` of them from row ``n_frozen``
    of r, preconditioned at the 0-d ``shift``), orthogonalized against
    ``xp = [X | P]`` (its P rows where ``p_valid``) in the metric when
    there is one.  Returns ``(w, bw, done)``, ``done`` a 0-d tensor."""
    n_max = r.shape[0]
    umask = torch.arange(n_max, device=r.device) < n_act
    rblk = gather_rows(r, n_frozen, n_max, count=n_act)
    w = torch.where(umask[:, None], precnd(shift, rblk), 0.0)
    xmask = torch.cat([torch.ones_like(p_valid), p_valid])
    if bvec is None:
        w, o_done = _ortho_vs_x(xp, w, xmask=xmask, umask=umask)
        return w, None, o_done
    w, o_done = _b_ortho_vs_x(xp, bxp, w, xmask=xmask, umask=umask)
    bw = torch.where(umask[:, None], bvec(w), 0.0)
    w, bw, b_ok = _b_ortho(w, bw, umask)
    return w, bw, o_done & b_ok


class _LobpcgIteration(StepState):
    """One solve's fixed-shape state and the steps of an iteration over
    it, the reference's ``_LobpcgState`` and loop body.  Every buffer is
    allocated once and written in place; every count (``n_act``,
    ``p_count``, ``n_frozen``, ``it``) is a 0-d tensor:

    1. :meth:`matvec`: A on the W slot, the Gram ``space . aspace^T``
       symmetrized and masked to the valid slots (:func:`masked_pad`);
       (between the steps, uncaptured) :meth:`reduced`, the eigh of that
       fixed ``(3 n_max)^2`` matrix, whose library call reads its own
       error flag;
    2. :meth:`ritz`: the rotations x / ax / bx, the residuals, norms,
       locking and histories, and the packed flags;
    3. :meth:`update` (when not ok): P from coefficient differences, then
       the new W block, from copies of its inputs (module docstring).
    """

    BODIES = {"update": "_update_body"}

    def __init__(self, matvec, precnd, bvec, x, ax, bx, eig, w, bw,
                 ortho_ok, options, sqrtn, budgets):
        self.matvec_fn, self.precnd, self.bvec = matvec, precnd, bvec
        self.options, self.sqrtn = options, sqrtn
        self.shift = options.shift
        n_max = self.n_max = options.n_max
        self.n_targ = options.n_targ
        len_a = 3 * n_max
        max_iter = options.max_iter
        n = x.shape[1]
        dtype, dev = x.dtype, x.device
        gen = bvec is not None

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)

        def full(value, *shape, dt=dtype):
            return torch.full(shape, value, dtype=dt, device=dev)

        self.rows = torch.arange(n_max, device=dev)
        self.cols = torch.arange(len_a, device=dev)
        self.ones = torch.ones((n_max,), dtype=torch.bool, device=dev)
        self.space = torch.cat([x, zeros(n_max, n), w])
        self.aspace = torch.cat([ax, zeros(2 * n_max, n)])
        self.bspace = torch.cat([bx, zeros(n_max, n), bw]) if gen else None
        self.sym = zeros(len_a, len_a)
        self.e_red = zeros(len_a)
        # eigh's eigenvector layout (column-major), kept by copy_, so that
        # the rotations see the operand the eager loop gave them
        self.c_full = zeros(len_a, len_a).mT
        self.eig = eig.clone()
        self.x = x.clone()
        self.ax = zeros(n_max, n)
        self.bx = zeros(n_max, n) if gen else None
        self.r = zeros(n_max, n)
        self.done = zeros(n_max, dt=torch.bool)
        self.rms = full(math.inf, n_max)
        self.rmx = full(math.inf, n_max)
        self.eig_h = zeros(max_iter, n_max)
        self.rms_h = full(math.inf, max_iter, n_max)
        self.max_h = full(math.inf, max_iter, n_max)
        i64 = torch.int64
        self.it = zeros(dt=i64)
        self.n_act = full(n_max, dt=i64)
        self.p_count = zeros(dt=i64)
        self.n_frozen = zeros(dt=i64)
        # the update's inputs, kept for rerun
        self.pre_space = torch.empty_like(self.space)
        self.pre_aspace = torch.empty_like(self.aspace)
        self.pre_bspace = torch.empty_like(self.bspace) if gen else None
        self.x3 = zeros(n_max, n)
        self.ax3 = zeros(n_max, n)
        self.bx3 = zeros(n_max, n) if gen else None
        self.r3 = zeros(n_max, n)
        self.c3 = zeros(n_max, len_a).mT        # as c_full's columns
        self.eig3 = zeros(n_max)
        self.n_frozen3 = zeros(dt=i64)
        self._init_steps(ortho_ok, budgets, dev)

    # ---- step 1 ----
    def matvec(self):
        n_max = self.n_max
        w_mask = self.rows < self.n_act
        p_valid = self.rows < self.p_count
        w = self.space[2 * n_max:]
        aw = torch.where(w_mask[:, None],
                         self.matvec_fn(w) + self.shift * w, 0.0)
        self.aspace[2 * n_max:].copy_(aw)
        g = mmT(self.space, self.aspace)
        mask = torch.cat([self.ones, p_valid, w_mask])
        self.sym.copy_(masked_pad(0.5 * (g + g.T), mask))

    # ---- between the steps ----
    def reduced(self, method: str):
        off_tol = 0.0
        if method == "jacobi":
            # the adaptive Jacobi target of the reference (see davidson)
            prev_rms = torch.where(~self.done, self.rms, math.inf).min()
            scale = torch.clamp(self.eig.abs().max(), min=1.0)
            off_tol = torch.clamp(0.01 * prev_rms / scale, 0.0, 1e-5)
        e_red, c_full = reduced.eigh(self.sym, method, off_tol=off_tol)
        self.e_red.copy_(e_red)
        self.c_full.copy_(c_full)

    # ---- step 2 ----
    def ritz(self):
        self.keep_ritz()
        n_max, opts = self.n_max, self.options
        eig = self.e_red[:n_max]
        c = self.c_full[:, :n_max]                      # (3*n_max, n_max)
        x = mTm(c, self.space)
        ax = mTm(c, self.aspace)
        bx = mTm(c, self.bspace) if self.bvec is not None else None
        r = ax - eig[:, None] * (bx if bx is not None else x)
        active = ~self.done
        rms = torch.where(active, norm_n(r) / self.sqrtn, self.rms)
        rmx = torch.where(active, amax_n(r.abs()), self.rmx)
        conv = (rms < opts.tol) & (rmx < opts.tol_max) & (self.it > 0)
        done = prefix_lock(self.done, conv, n_max)
        at = self.it.view(1)
        self.eig_h.index_copy_(0, at, (eig - self.shift)[None])
        self.rms_h.index_copy_(0, at, rms[None])
        self.max_h.index_copy_(0, at, rmx[None])
        self.eig.copy_(eig)
        self.x.copy_(x)
        self.ax.copy_(ax)
        if bx is not None:
            self.bx.copy_(bx)
        self.r.copy_(r)
        self.rms.copy_(rms)
        self.rmx.copy_(rmx)
        self.done.copy_(done)
        self.ok.copy_(done[:self.n_targ].all())
        self.n_frozen.copy_(done.sum())
        self.it.add_(1)
        self.pack_flags()

    # ---- step 3 ----
    def update(self):
        """Keep the update's inputs, then run it from them."""
        for name in ("space", "aspace", "bspace"):
            if getattr(self, name) is not None:
                getattr(self, "pre_" + name).copy_(getattr(self, name))
        for name in ("x", "ax", "bx", "r", "eig", "n_frozen"):
            if getattr(self, name) is not None:
                getattr(self, name + "3").copy_(getattr(self, name))
        self.c3.copy_(self.c_full[:, :self.n_max])
        self._update_body()

    def _update_body(self):
        n_max, gen = self.n_max, self.bvec is not None
        n_frozen = self.n_frozen3
        n_act_new = n_max - n_frozen
        umask = self.rows < n_act_new
        with self._ortho() as rec:
            # P from coefficient differences: the new X coefficients of
            # the active roots minus their old-X component, orthogonalized
            # against all new X coefficients
            u_x = self.c3.T                             # (n_max, 3*n_max)
            u_p = gather_rows(u_x, n_frozen, n_max, count=n_act_new)
            onehots = (self.cols[None, :] == (n_frozen + self.rows)[:, None])
            u_p = u_p - torch.where(umask[:, None], onehots.to(u_p.dtype),
                                    0.0)
            with mm_sharding(None):         # replicated coefficients
                u_p, p_done = _ortho_vs_x(u_x, u_p, umask=umask)
            for name, xk in (("space", self.x3), ("aspace", self.ax3),
                             ("bspace", self.bx3)):
                if xk is None:
                    continue
                dst = getattr(self, name)
                dst[n_max:2 * n_max].copy_(mm(u_p, getattr(self, "pre_"
                                                           + name)))
                dst[:n_max].copy_(xk)
                dst[2 * n_max:].zero_()
            w, bw, w_done = _build_w(
                self.precnd, self.bvec, self.space[:2 * n_max],
                self.bspace[:2 * n_max] if gen else None, self.r3,
                n_frozen, n_act_new, self.shift - self.eig3[0], umask)
            self.space[2 * n_max:].copy_(w)
            if gen:
                self.bspace[2 * n_max:].copy_(bw)
        self._close(p_done & w_done, rec)
        self.n_act.copy_(n_act_new)
        self.p_count.copy_(n_act_new)


def _start(matvec, precnd, bvec, evec_guess, options, generator, method,
           sqrtn, budgets) -> _LobpcgIteration:
    """The prologue, uncaptured: a Rayleigh-Ritz of the (B-orthonormalized)
    guess and an explicit first W block; returns the iteration's state."""
    gen_eig = bvec is not None
    n_max, shift = options.n_max, options.shift
    dev = evec_guess.device
    guess = check_guess(evec_guess, generator)
    ortho_ok = torch.ones((), dtype=torch.bool, device=dev)
    if gen_eig:
        x, bx, ortho_ok = _b_ortho(guess, bvec(guess))
    else:
        x, bx = guess, None
    ax = matvec(x) + shift * x
    g0 = mmT(x, ax)
    eig, c0 = reduced.eigh(0.5 * (g0 + g0.T), method)
    x = mTm(c0, x)
    ax = mTm(c0, ax)
    if gen_eig:
        bx = mTm(c0, bx)
    r0 = ax - eig[:, None] * (bx if gen_eig else x)
    zeros = torch.zeros_like(x)
    w0, bw0, o_done0 = _build_w(
        precnd, bvec, torch.cat([x, zeros]),
        torch.cat([bx, zeros]) if gen_eig else None, r0, 0, n_max,
        shift - eig[0], torch.zeros((n_max,), dtype=torch.bool, device=dev))
    return _LobpcgIteration(matvec, precnd, bvec, x, ax, bx, eig, w0, bw0,
                            ortho_ok & o_done0, options, sqrtn, budgets)


def _lobpcg_impl(matvec, precnd, evec_guess, options, bvec, generator,
                 sharding):
    method = reduced.resolve(options.reduced_solver)
    n_max, max_iter = options.n_max, options.max_iter
    if evec_guess.shape[0] != n_max:
        raise ValueError(f"guess must have n_max={n_max} rows")
    n = evec_guess.shape[1]
    dev = evec_guess.device
    route = _route(dev, sharding)
    st = _start(matvec, precnd, bvec, evec_guess, options, generator, method,
                math.sqrt(global_n(n, sharding)), _budgets(route))
    loop = StepLoop("lobpcg", st, dev, route, _SCOPES)

    # the host's copy of the W count, for the matvec count
    n_act, n_matvec, ok, it = n_max, n_max, False, 0
    with loop:
        while not ok and it < max_iter:
            ok, n_frozen = loop.iterate(lambda: st.reduced(method))
            n_matvec += n_act
            if options.verbose:
                inflight_progress("lobpcg", it, n_act, st.eig_h[it], st.rms,
                                  st.rmx)
            if not ok:
                loop.branch("update")
                n_act = n_max - n_frozen
            it += 1
        ortho_ok = loop.close()
    loop.record(it, st.eig.dtype, options.verbose)
    return SolverResult(
        eig=st.eig - options.shift,
        evec=st.x,
        ok=ok,
        n_iter=it,
        n_matvec=n_matvec,
        done=st.done,
        rms_history=st.rms_h,
        max_history=st.max_h,
        eig_history=st.eig_h,
        ortho_ok=ortho_ok,
    )


# the profiler scope of each step
_SCOPES = {"matvec": "matvec", "ritz": "rayleigh-ritz",
           "update": "expand-ortho"}
