"""Block Davidson-Liu eigensolvers, standard and generalized (port of
``diaglib_tpu/solvers/davidson.py``).

The loop has the reference's shape: one fixed-shape state (the
reference's ``_DavidsonState``; the expansion space in a ``(lda_pad, n)``
buffer, ``lda = dim_dav*n_max`` plus one block of scatter padding, with
the row count ``ldu`` and every other count a 0-d tensor on the device)
and an iteration in steps that read nothing back (:class:`_Iteration`).
On CUDA tensors each step is captured as a CUDA graph once per shape and
replayed (``utils/graphs.py``, the counterpart of the reference's
``jit`` around ``lax.while_loop``); the host reads the device once an
iteration, the packed flags after the last step, beside the reduced
eigh's own check.

Once per shape: an unsharded solve on the captured route keeps its state
and graphs (``utils.graphs.STEP_CACHE``) under a key of everything the
captured steps bind: the solver ("davidson" or "gen_david"), the
``matvec``, ``precnd`` and ``bvec`` callables (held weakly: the cache
keeps no operator alive, and an entry goes when one of them is
collected), ``n``, the dtype and device, the options, the float32 stage's
stall watch, the route and the pass budgets.  The next solve with that
key resets the state in place (:meth:`_Iteration.start`: every buffer a
step reads before writing gets a fresh state's values, so the bits are a
fresh state's) and replays the graphs, with no warm-up and no capture.
A replay reads what the callables read when they were captured, so only
callables marked ``utils.graphs.replayable`` are keyed: those of the
port's operator constructors (``problems.dense_matvec``,
``diag_precnd``, the ``ops`` matvecs), which read fixed tensors.  Any
other callable, a bound method over an attribute that the caller may
rebind for one, is captured anew each solve.  At most
``utils.graphs.STEP_CACHE_SIZE`` entries a device.  The two stages of one
ladder call keep their (rows, n) buffers in one arena
(``utils.graphs.Arena``), sized for the float64 stage, so keeping both
costs no more device memory than the float64 stage alone; a solve
outside a ladder keeps buffers of its own.  The returned tensors are
copies, never the kept state's.  The private "unrolled" route keeps its
state the same way (with no graphs);
the "eager" route and every sharded solve make a new state and new graphs
each solve.  The ortho loops of a captured step run a fixed number
of masked passes (``_UNROLL``); when they needed more, or the QR
fallback, or the SVD rescue, the step is run again uncaptured from its
intact inputs (a rare-branch rerun), which gives the loops' own result.
A ``sharding=`` run over an NCCL group is captured the same way on every
rank, its all-reduces, all-gathers and ring permutes inside the graphs;
CPU tensors and gloo groups call the same steps directly, with the ortho
loops reading their predicates.

The float32 stage of ``davidson_ladder`` and ``gen_david_ladder``
(:func:`_float32_stage`) also watches its residuals: its ritz step sets a
stall bit, read with the flags, when the largest rms of the targeted
roots lies ``STALL_DROP`` below its first value and has not fallen by
``STALL_FACTOR`` from the largest of the ``STALL_WINDOW`` iterations
before, and the loop then ends as it ends on convergence.  It ends where
float32 no longer lowers the residual the float64 stage starts from: at
the float32 noise floor, where that lies above ``lo_tol``.
:func:`davidson` and :func:`gen_david` never take this exit: they end on
``tol`` or ``max_iter``.

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
  (the reference's ``jax.named_scope``; spans of ``profiling``, a
  ``record_function`` under a running profiler), which a
  ``profiling.trace`` attributes time to.

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

from ..ortho.core import _b_ortho, _b_ortho_vs_x, _ortho_vs_x, b_ortho
from ..reporting import inflight_progress
from ..types import SolverOptions, SolverResult
from ..utils.graphs import (
    STEP_CACHE,
    Arena,
    StepLoop,
    StepState,
    _budgets,
    _route,
)
# the private switch of utils.graphs stays importable from here too
from ..utils.graphs import _UNROLL, _read_flags, _recording  # noqa: F401
from ..utils.guess import check_guess
from ..utils.masking import (
    gather_rows,
    masked_eigh_prefix,
    prefix_lock,
    prefix_mask,
    scatter_rows,
)
from ..utils.mm import amax_n, global_n, mm_sharding, mmT, mTm, norm_n, routing_for
from ..utils.reduced import resolve

__all__ = ["davidson", "gen_david"]

# the stall watch of a ladder's float32 stage (the module docstring): the
# largest targeted rms, once STALL_DROP below its first value, has not
# fallen by STALL_FACTOR over STALL_WINDOW iterations.  The drop keeps the
# watch off a slow start and off a root that enters the targeted set late;
# the window spans the float32 noise floor's scatter (on the H100 at
# n = 32768 the stage reaches it in 5-8 iterations, 5 decades down)
STALL_WINDOW = 3
STALL_FACTOR = 2.0
STALL_DROP = 1e3


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
    (shift removed from eig), tensors of the caller's own.

    Called again with the same ``matvec`` and ``precnd`` objects, ``n``,
    dtype, device and options (unsharded, on CUDA tensors), a solve
    replays the graphs of the last such solve instead of capturing anew,
    when both callables are marked ``utils.graphs.replayable``, as the
    port's operator constructors mark theirs: a replay reads the tensors
    the callables read when they were captured (the module docstring).
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
    Its graphs are kept for the next solve as :func:`davidson`'s, when
    ``bvec`` is marked ``replayable`` too.
    """
    with routing_for(options, "gen_david"), mm_sharding(sharding):
        return _davidson_impl(matvec, precnd, bvec, evec_guess, options,
                              generator, sharding)


def _float32_stage(matvec, precnd, evec_guess: torch.Tensor,
                   options: SolverOptions, *, bvec=None,
                   generator: torch.Generator | None = None,
                   sharding=None) -> SolverResult:
    """A Davidson ladder's float32 stage: :func:`davidson` (with ``bvec``
    :func:`gen_david`) that also ends when its residuals stall (the
    module docstring); ``ok`` is then false."""
    with routing_for(options, "davidson" if bvec is None else "gen_david"), \
            mm_sharding(sharding):
        return _davidson_impl(matvec, precnd, bvec, evec_guess, options,
                              generator, sharding, watch=True)


class _Iteration(StepState):
    """One solve's fixed-shape state and the steps of an iteration over it,
    the reference's ``_DavidsonState`` and loop body.

    Every buffer is allocated once and written in place, and every count
    the steps use (``ldu``, ``n_act``, ``n_rst``, the matvec block's start,
    ``ldu_new``, ``n_frozen``, the shift) is a 0-d tensor on the device,
    so no step reads the device and each can be captured as a CUDA graph:

    1. :meth:`matvec`: the matvec block, its rows of ``a_red`` and ``sym``;
       (between the steps, uncaptured) :meth:`reduced`, the eigh of the
       leading ``ldu_new`` block, whose size changes every iteration and
       whose library call reads its own error flag;
    2. :meth:`ritz`: the rotations, residuals, norms, locking and
       histories, and :attr:`flags`: ok, n_frozen, whether the step 3
       before it finished its ortho loops, ortho_ok, and with ``watch``
       the stall bit (:meth:`stalled`);
    3. :meth:`expand` or :meth:`restart`, as the host's count of
       expansions picks.

    The host reads :attr:`flags` once an iteration.  A step 3 whose
    unrolled ortho loops fell short is found there, one iteration late:
    :meth:`undo_ritz` puts back what step 2 changed, :meth:`rerun` runs
    that step 3 again with the eager loops from the inputs it kept, and
    steps 1 and 2 run again (``utils.graphs.StepState`` / ``StepLoop``).
    """

    BODIES = {"expand": "_expand_ortho", "restart": "_restart_body"}
    CALLABLES = ("matvec_fn", "precnd", "bvec")
    # the counts, 0-d int64 tensors; step 3's inputs ldu_new3, n_frozen3
    COUNTS = ("it", "ldu", "n_act", "n_rst", "ldu_new", "n_frozen",
              "ldu_new3", "n_frozen3")

    def __init__(self, matvec, precnd, bvec, guess, bguess, ortho_ok,
                 options, sqrtn, budgets, watch=False, arena=None):
        """Allocate the state (its (rows, n) buffers in ``arena`` when
        given, see :meth:`wide`) and :meth:`start` a solve on it."""
        self.options, self.sqrtn = options, sqrtn
        n_max = self.n_max = options.n_max
        self.n_targ = options.n_targ
        lda_pad = self.lda_pad = options.dim_dav * n_max + n_max
        max_iter = options.max_iter
        n = guess.shape[1]
        dtype, dev = guess.dtype, guess.device
        gen = bvec is not None

        def empty(*shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device=dev)

        self.rows = torch.arange(n_max, device=dev)
        self.rows_pad = torch.arange(lda_pad, device=dev)
        self.targ = self.rows < self.n_targ
        names, shapes = self.wide(options, n, gen)
        self.arena = arena          # held: a ladder's two states share it
        wide = (arena.buffers(shapes, dtype) if arena is not None
                else [empty(*shape) for shape in shapes])
        self.bspace = self.metric_evec = self.evec3 = self.metric_evec3 = None
        for name, buf in zip(names, wide):
            setattr(self, name, buf)
        self.a_red = empty(lda_pad, lda_pad)
        self.sym = empty(lda_pad, lda_pad)
        self.e_red = empty(lda_pad)
        self.c_full = empty(lda_pad, lda_pad)
        self.eig = empty(n_max)
        self.done = empty(n_max, dt=torch.bool)
        self.rms = empty(n_max)
        self.rmx = empty(n_max)
        self.eig_h = empty(max_iter, n_max)
        self.rms_h = empty(max_iter, n_max)
        self.max_h = empty(max_iter, n_max)
        self.watch = watch
        self.iters = torch.arange(max_iter, device=dev) if watch else None
        for name in self.COUNTS:
            setattr(self, name, empty(dt=torch.int64))
        # step 3's inputs, kept for rerun, beside the wide pre and (on the
        # generalized path) evec3 and metric_evec3
        self.eig3 = empty(n_max)
        self._alloc_steps(budgets, dev)
        self.start(matvec, precnd, bvec, guess, bguess, ortho_ok)

    @staticmethod
    def wide(options, n: int, gen: bool):
        """The names and shapes of a state's (rows, n) buffers, the ones an
        arena holds: (lda_pad, n), then (n_max, n)."""
        n_max = options.n_max
        tall = ["space", "aspace"] + ["bspace"] * gen
        short = ["evec", "r", "pre"] + [
            "metric_evec", "evec3", "metric_evec3"] * gen
        return tall + short, ([(options.dim_dav * n_max + n_max, n)]
                              * len(tall) + [(n_max, n)] * len(short))

    def start(self, matvec, precnd, bvec, guess, bguess, ortho_ok):
        """Write a solve's starting values into the state: the callables,
        the guess (and B times it) at the head of the space, and every
        buffer a step reads before writing as a new state has it."""
        self.matvec_fn, self.precnd, self.bvec = matvec, precnd, bvec
        for buf in (self.space, self.aspace, self.bspace, self.a_red,
                    self.sym, self.e_red, self.c_full, self.eig, self.evec,
                    self.metric_evec, self.r, self.done, self.eig_h,
                    self.pre, self.eig3, self.evec3, self.metric_evec3,
                    *(getattr(self, name) for name in self.COUNTS)):
            if buf is not None:
                buf.zero_()
        scatter_rows(self.space, guess, 0)
        if bvec is not None:
            scatter_rows(self.bspace, bguess, 0)
        for buf in (self.rms, self.rmx, self.rms_h, self.max_h):
            buf.fill_(math.inf)
        self.n_act.fill_(self.n_max)
        self._start_steps(ortho_ok)

    # ---- step 1 ----
    def matvec(self):
        ldu_new = self.ldu + self.n_act
        # the matvec block starts past the n_rst roots whose products are
        # skipped right after a restart; n_rst is 0 on the normal path
        start = self.ldu + self.n_rst
        width = ldu_new - start
        block = gather_rows(self.space, start, self.n_max, count=width)
        ablock = self.matvec_fn(block)
        ablock = torch.where((self.rows < width)[:, None], ablock, 0.0)
        scatter_rows(self.aspace, ablock, start)
        # incremental reduced-matrix rows: a_red[g, j] = aspace_g . space_j
        # (lower triangle filled by rows)
        col_ok = prefix_mask(self.lda_pad, ldu_new, device=ldu_new.device)
        new_rows = torch.where(col_ok[None, :], mmT(ablock, self.space), 0.0)
        scatter_rows(self.a_red, new_rows, start)
        self.sym.copy_(torch.tril(self.a_red)
                       + torch.tril(self.a_red, diagonal=-1).T)
        self.ldu_new.copy_(ldu_new)

    # ---- between the steps ----
    def reduced(self, ldu_new: int, method: str):
        off_tol = 0.0
        if method == "jacobi":
            # the reference's adaptive Jacobi target: the intermediate
            # solves stay two orders below the current residual level and
            # tighten to eps as the roots converge
            prev_rms = torch.where(~self.done & self.targ, self.rms,
                                   math.inf).min()
            scale = torch.clamp(self.eig.abs().max(), min=1.0)
            off_tol = torch.clamp(0.01 * prev_rms / scale, 0.0, 1e-5)
        e_red, c_full = masked_eigh_prefix(self.sym, ldu_new, method,
                                           off_tol=off_tol)
        self.e_red.copy_(e_red)
        self.c_full.copy_(c_full)

    # ---- step 2 ----
    def ritz(self):
        self.keep_ritz()
        n_max = self.n_max
        eig = self.e_red[:n_max]
        c = self.c_full[:, :n_max]                     # (lda_pad, n_max)
        evec = mTm(c, self.space)
        metric_evec = mTm(c, self.bspace) if self.bvec is not None else evec
        r = mTm(c, self.aspace) - eig[:, None] * metric_evec
        active = ~self.done & self.targ
        rms = torch.where(active, norm_n(r) / self.sqrtn, self.rms)
        rmx = torch.where(active, amax_n(r.abs()), self.rmx)
        opts = self.options
        conv = (rms < opts.tol) & (rmx < opts.tol_max) & (self.it > 0)
        done = prefix_lock(self.done, conv, self.n_targ)
        at = self.it.view(1)
        self.eig_h.index_copy_(0, at, (eig - opts.shift)[None])
        self.rms_h.index_copy_(0, at, rms[None])
        self.max_h.index_copy_(0, at, rmx[None])
        self.eig.copy_(eig)
        self.evec.copy_(evec)
        if self.metric_evec is not None:
            self.metric_evec.copy_(metric_evec)
        self.r.copy_(r)
        self.rms.copy_(rms)
        self.rmx.copy_(rmx)
        self.done.copy_(done)
        self.ok.copy_(done[:self.n_targ].all())
        self.n_frozen.copy_(done.sum())
        if self.watch:
            self.stall.copy_(self.stalled())
        self.it.add_(1)
        self.pack_flags()

    def stalled(self):
        """Whether the residuals stopped falling at this iteration: the
        largest targeted rms lies ``STALL_DROP`` below its first value and
        not ``STALL_FACTOR`` below its largest over the ``STALL_WINDOW``
        iterations before (never in the first ``STALL_WINDOW``).  Locked
        roots keep their last rms, under ``tol``."""
        worst = torch.where(self.targ, self.rms_h, -math.inf).amax(dim=1)
        now = torch.where(self.iters == self.it, worst, -math.inf).amax()
        window = (self.iters < self.it) & (self.iters >= self.it
                                           - STALL_WINDOW)
        before = torch.where(window, worst, -math.inf).amax()
        return ((self.it >= STALL_WINDOW) & (now * STALL_DROP < worst[0])
                & (now * STALL_FACTOR > before))

    # ---- step 3 ----
    def expand(self):
        """Precondition the active residuals, orthogonalize them against
        the space and append them."""
        n_max = self.n_max
        n_frozen = self.n_frozen
        first = n_frozen.clamp(max=n_max - 1).view(1)
        shift = -self.eig.index_select(0, first).reshape(())
        rblk = gather_rows(self.r, n_frozen, n_max, count=n_max - n_frozen)
        umask = self.rows < n_max - n_frozen
        self.pre.copy_(torch.where(umask[:, None],
                                   self.precnd(shift, rblk), 0.0))
        self.ldu_new3.copy_(self.ldu_new)
        self.n_frozen3.copy_(n_frozen)
        self._expand_ortho()

    def _expand_ortho(self):
        n_act_new = self.n_max - self.n_frozen3
        umask = self.rows < n_act_new
        col_ok = self.rows_pad < self.ldu_new3
        with self._ortho() as rec:
            if self.bvec is not None:
                unew, o_done = _b_ortho_vs_x(self.space, self.bspace,
                                             self.pre, xmask=col_ok,
                                             umask=umask)
                bnew = torch.where(umask[:, None], self.bvec(unew), 0.0)
                unew, bnew, b_ok = _b_ortho(unew, bnew, umask)
                o_done = o_done & b_ok
                scatter_rows(self.bspace, bnew, self.ldu_new3)
            else:
                unew, o_done = _ortho_vs_x(self.space, self.pre,
                                           xmask=col_ok, umask=umask)
            scatter_rows(self.space, unew, self.ldu_new3)
        self._close(o_done, rec)
        self.ldu.copy_(self.ldu_new3)
        self.n_act.copy_(n_act_new)
        self.n_rst.zero_()

    def restart(self):
        """Collapse onto the Ritz vectors (re-B-orthonormalized on the
        generalized path, bspace kept with them); seed the locked
        eigenvalues so that their matvecs are skipped next iteration."""
        self.n_frozen3.copy_(self.n_frozen)
        self.eig3.copy_(self.eig)
        if self.bvec is not None:
            self.evec3.copy_(self.evec)
            self.metric_evec3.copy_(self.metric_evec)
        self._restart_body()

    def _restart_body(self):
        ev, b_ok = self.evec, torch.ones_like(self.ok)
        with self._ortho() as rec:
            if self.bvec is not None:
                ev, bev, b_ok = _b_ortho(self.evec3, self.metric_evec3)
                scatter_rows(self.bspace.zero_(), bev, 0)
            scatter_rows(self.space.zero_(), ev, 0)
        self.aspace.zero_()
        seed = torch.zeros_like(self.e_red)
        seed[:self.n_max] = self.eig3
        seed = torch.where(self.rows_pad < self.n_frozen3, seed, 0.0)
        self.a_red.copy_(torch.diag(seed))
        self._close(b_ok, rec)
        self.ldu.zero_()
        self.n_act.fill_(self.n_max)
        self.n_rst.copy_(self.n_frozen3)


def _davidson_impl(matvec, precnd, bvec, evec_guess, options, generator,
                   sharding, watch=False):
    gen_eig = bvec is not None
    method = resolve(options.reduced_solver)
    n_max, max_iter = options.n_max, options.max_iter
    k_rows, n = evec_guess.shape
    if k_rows != n_max:
        raise ValueError(f"guess must have n_max={n_max} rows, got {k_rows}")
    dev = evec_guess.device
    route = _route(dev, sharding)

    guess = check_guess(evec_guess, generator)
    bguess, ortho_ok = None, True
    if gen_eig:
        guess, bguess, ortho_ok = b_ortho(guess, bvec(guess))
    budgets = _budgets(route)
    # the state and graphs of the last solve of this shape (the module
    # docstring), unsharded and not on the eager route; else new ones
    key = None if sharding is not None or route == "eager" else \
        STEP_CACHE.key("gen_david" if gen_eig else "davidson",
                       (matvec, precnd, bvec), n, guess.dtype, dev, options,
                       watch, route, budgets)
    st, graphs = STEP_CACHE.take(key, dev)
    if st is not None:
        st.start(matvec, precnd, bvec, guess, bguess, ortho_ok)
    else:
        # inside a ladder call its two stages share one arena, sized for
        # the float64 stage; else the state's buffers are its own
        arena = None if key is None else Arena.of_ladder(
            Arena.nbytes(_Iteration.wide(options, n, gen_eig)[1],
                         torch.float64.itemsize), dev)
        st = _Iteration(matvec, precnd, bvec, guess, bguess, ortho_ok,
                        options, math.sqrt(global_n(n, sharding)), budgets,
                        watch, arena)
    if st.arena is not None:
        st.arena.busy = True        # until STEP_CACHE.put
    loop = StepLoop("davidson", st, dev, route, _SCOPES, graphs)

    # the host's copies of the counts it needs: the reduced block's size
    # and the matvec count (ldu, n_act) and the branch (m_dim)
    ldu, n_act, m_dim = 0, n_max, 1
    ok, n_matvec, it = False, 0, 0
    with loop:
        while not (ok or loop.stalled) and it < max_iter:
            ldu_new = ldu + n_act
            ok, n_frozen = loop.iterate(lambda: st.reduced(ldu_new, method))
            n_matvec += n_act
            if options.verbose:
                inflight_progress("davidson", it, n_act, st.eig_h[it],
                                  st.rms, st.rmx)
            if not (ok or loop.stalled):
                if m_dim < options.dim_dav:
                    loop.branch("expand")
                    ldu, n_act, m_dim = ldu_new, n_max - n_frozen, m_dim + 1
                else:
                    loop.branch("restart")
                    ldu, n_act, m_dim = 0, n_max, 1
            it += 1
        ortho_ok = loop.close()
    loop.record(it, st.eig.dtype, options.verbose)
    # copies: the state serves the next solve
    res = SolverResult(
        eig=st.eig - options.shift,
        evec=st.evec.clone(),
        ok=ok,
        n_iter=it,
        n_matvec=n_matvec,
        done=st.done.clone(),
        rms_history=st.rms_h.clone(),
        max_history=st.max_h.clone(),
        eig_history=st.eig_h.clone(),
        ortho_ok=ortho_ok,
    )
    STEP_CACHE.put(key, dev, st, loop.graphs)
    return res


# the profiler scope of each step (the restart has none)
_SCOPES = {"matvec": "matvec", "ritz": "rayleigh-ritz",
           "expand": "expand-ortho"}
