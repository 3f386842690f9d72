"""Capture and replay of a solver's iteration steps as CUDA graphs.

This is the port's counterpart of the reference's ``jax.jit`` around a
``lax.while_loop`` (``diaglib_tpu/utils/compile.py`` and the solvers'
loops): XLA compiles the whole loop into one device program, so the host
launches it once and reads nothing back until it ends.  PyTorch runs
eagerly, so the iterations of ``davidson`` / ``gen_david``
(``solvers/davidson.py``), ``lobpcg`` (``solvers/lobpcg.py``),
``caslr`` / ``caslr_eff`` (``solvers/caslr.py``) and each pass of
``nonsym`` (``solvers/nonsym.py``) are cut into steps over
fixed buffers, each step is captured as a CUDA graph and then replayed:
one launch a step instead of a few hundred, and no read of the device
inside a step.  The Davidson family (``davidson``, ``gen_david`` and
their ladders' stages) captures once per shape: its state and graphs are
kept for the next solve of the same shape (:class:`StepCache`).  The
other solvers, and every sharded solve, capture once per solve.  A
``sharding=`` solve over an NCCL group is captured the same way, on every
rank: the steps' all-reduces, all-gathers and ring permutes run inside
the graphs, as the reference's collectives run inside its compiled loop.

:class:`StepGraphs` holds a state's graphs, one a step key (the caller
puts the step, the dtype and the branch into it):

* the first call of a key runs the step uncaptured on the capture stream
  (the warm-up: the kernels' libraries load, their shared-memory limits are
  set, and the per-stream scratch of kernel K3 and cuBLAS's workspace are
  allocated before capture), then captures it; every later call replays it;
* the solve runs on the capture stream (``with graphs:``), so the steps,
  the reduced solves between them and any uncaptured rare branch are
  ordered on one stream, and K3's scratch is one buffer for all of them;
* the kernel wrappers count launches in Python, which a replay does not
  run: the counts a capture adds are taken back and added again at every
  replay, so a replayed step counts what it launches;
* the port's collectives are counted in Python too
  (``profiling.collective_inventory``): what a capture posts is recorded
  apart and added to the inventories at every replay, so a replayed step
  counts the collectives it runs and a capture counts none;
* a failed capture raises :class:`GraphCaptureError`; nothing falls back
  to the uncaptured loop.

Under a sharding (an NCCL group; every rank runs the same solve):

* every rank captures and replays the same steps in the same order: the
  host's branches (a rerun, a restart, the end of the loop) follow the
  flags, which are computed from all-reduced results and so the same bits
  on every rank (``mm_sharding``); a solve's record keeps the flags it
  read (``flag_history``), which the fleet jobs compare across the ranks;
* the warm-up call of a step posts every collective and ring permute the
  captured step will post (the same call), so NCCL's peers are connected
  before any capture;
* NCCL runs a collective on its own stream, joined to the capture stream
  by events; every collective's ``wait()`` falls inside its step, so the
  capture ends with every stream joined;
* the capture's error mode is thread-local: NCCL's watchdog thread polls
  the events of the eager collectives (the prologue's, a rerun's) while a
  step is captured, which a global-mode capture would count as a fault;
* the shards a step's ring permutes send and receive are kept for as long
  as the graph lives (``VectorSharding.keep_alive``);
* a rare-branch rerun runs uncaptured on every rank at once, its eager
  collectives on the same communicator between the replays.

gloo groups and CPU tensors have no capture: their steps are called
directly (the "eager" route, or on request "unrolled").

The solvers share the rest of the machinery here:

* :class:`StepState`, the part of a solve's fixed device state every
  solver keeps the same way: the packed flags the host reads once an
  iteration (with a stall bit that only a ladder's float32 Davidson stage
  sets; the others pack 0), what the ritz step changes (kept so that it
  can be undone), the ortho health and the finished bit of the last
  branch step, and the rare-branch rerun of that step from the inputs it
  kept;
* :class:`StepLoop`, the host side of an iteration: the first step, the
  reduced solve between the steps, the ritz step, the one flag read, and
  the rerun of the branch step before it when its unrolled ortho loops
  fell short (found one iteration late, so the iteration is undone and
  run again);
* the private route switch :class:`_recording` (the route and the pass
  budgets) and :func:`_on_route` (one call under it, its launches
  counted), the counted flag read :func:`_read_flags` and the route
  choice :func:`_route`;
* :class:`StepCache` (:data:`STEP_CACHE`), the states and graphs kept
  from one solve to the next of the same shape: a solve that passes a
  key (:meth:`StepCache.key`: the solver, its callables, held weakly, and
  everything else its captured steps bind) takes the state and graphs of
  the last solve with that key, resets the state in place and replays the
  graphs, with no warm-up and no capture.  Only callables marked
  :func:`replayable` are keyed: a replay reads the tensors and numbers a
  callable read when it was captured, so a callable that reads anything
  else at call time (a bound method over an attribute the caller
  rebinds, say) is captured anew each solve.  The port's operator
  constructors mark the closures they return.  At most
  :data:`STEP_CACHE_SIZE` entries a device, the least recently used
  dropped first; an entry goes with its graphs, pool and buffers when one
  of its callables is collected, so the cache keeps no caller's operator
  alive.  The two stages of one ladder call can share their buffers
  (:class:`Arena`).

The step loop's host work is measured where it happens, through
``profiling``'s one span helper (a ``record_function`` under a running
profiler, an entry of each open ``profiling.solve_log``, else nothing):
the phase scopes around the steps, and four leaf spans, none inside
another: ``step-warmup`` (a step's first, uncaptured call),
``graph-capture`` (``capture_begin`` to ``capture_end``),
``step-rerun`` (a branch step run again with the eager loops) and
``reduced-solve`` (the reduced solve, inside ``rayleigh-ritz``).  With a
log open each solve files one record into it (:meth:`StepLoop.record`;
the fields are ``profiling.SolveLog``'s).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import math
import time
import weakref

import torch

from .. import profiling
from ..ortho.core import eager_passes, unrolled
from .mm import current_sharding

__all__ = ["StepGraphs", "StepState", "StepLoop", "StepCache", "Arena",
           "GraphCaptureError", "kernel_counters", "replayable",
           "STEP_CACHE", "STEP_CACHE_SIZE"]


class GraphCaptureError(RuntimeError):
    """A solver step could not be captured as a CUDA graph (it read the
    device, synchronized, or called something a capture refuses)."""


def kernel_counters() -> dict:
    """Each kernel wrapper of the port by name (K2, K1, K3, K4, K5, K6);
    each counts its launches in ``.launches``."""
    from ..ops import bsr, bsr_sliced, bsr_sliced_sym, dist_sliced, slicing

    return {"peel_rows": slicing.peel_rows,
            "sym_spmm": bsr_sliced_sym.sym_spmm,
            "sliced_wide_mm": slicing.sliced_wide_mm,
            "bsr_spmm": bsr.bsr_spmm,
            "sliced_spmm": bsr_sliced.sliced_spmm,
            "group_spmm": dist_sliced.group_spmm}


# one capture stream a device, made at first use (as torch.cuda.graph's
# default capture stream is)
_STREAMS: dict = {}


def _capture_stream(device: torch.device):
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    stream = _STREAMS.get(index)
    if stream is None:
        stream = torch.cuda.Stream(device=index)
        _STREAMS[index] = stream
    return stream


class StepGraphs:
    """A state's CUDA graphs, made once and replayed (see the module
    docstring), or, with ``capture`` false, none.  Use as a context around
    a solve's loop; ``run(key, fn)`` runs the step ``fn`` (no arguments,
    results written into buffers that outlive the solve's loop).
    ``sharding`` is the solve's (NCCL) sharding, whose collectives the
    steps post, or None.

    The current solve's counts (:meth:`new_solve` starts them):
    ``capture_s``, the host time spent capturing, ``pool_bytes``, the
    device memory the graphs' shared pool reserved while capturing, and
    ``replays``, the replays by key."""

    def __init__(self, device: torch.device, capture: bool = True,
                 sharding=None):
        self.device = torch.device(device)
        self.capture = capture
        if capture and self.device.type != "cuda":
            raise ValueError(f"no CUDA graphs on {self.device}")
        self.sharding = sharding
        self.stream = _capture_stream(self.device) if capture else None
        self.counters = kernel_counters() if capture else {}
        self.graphs: dict = {}
        self.launches: dict = {}
        self.posted: dict = {}      # the collectives a key's capture posted
        self.kept: dict = {}        # the tensors its ring permutes use
        self._pool = None
        self.new_solve()

    def new_solve(self):
        """Start the counts of a solve (kept graphs serve many)."""
        self.replays: dict = {}
        self.capture_s = 0.0
        self.pool_bytes = 0

    def __enter__(self):
        if self.capture:
            self._caller = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(self._caller)
            self._ctx = torch.cuda.stream(self.stream)
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        if self.capture:
            self._ctx.__exit__(*exc)
            self._caller.wait_stream(self.stream)
        return False

    def run(self, key, fn):
        """Run step ``fn``: directly without capture; else the first time
        uncaptured and then captured as ``key``'s graph, later replayed."""
        if not self.capture:
            fn()
            return
        graph = self.graphs.get(key)
        if graph is None:
            with profiling._span("step-warmup"):
                fn()
            self._capture(key, fn)
            return
        graph.replay()
        for name, n in self.launches[key].items():
            self.counters[name].launches += n
        if self.posted[key]:
            profiling._replayed(self.posted[key])
        self.replays[key] = self.replays.get(key, 0) + 1

    def _capture(self, key, fn):
        counters = self.counters
        before = {k: f.launches for k, f in counters.items()}
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        posted, kept = {}, []
        keep = (contextlib.nullcontext() if self.sharding is None
                else self.sharding.keep_alive(kept))
        failure = None
        with profiling._span("graph-capture"):
            # capture_begin/end rather than torch.cuda.graph, whose entry
            # synchronizes the card and runs the garbage collector each
            # time; a sharded step's capture is thread-local (see the
            # module docstring: NCCL's watchdog thread)
            graph.capture_begin(pool=self._pool, capture_error_mode=(
                "global" if self.sharding is None else "thread_local"))
            try:
                with profiling._captured(posted), keep:
                    fn()
            except Exception as exc:        # re-raised below, with the step
                failure = exc
            try:
                graph.capture_end()
            except RuntimeError as exc:
                failure = failure or exc
        self.capture_s += time.perf_counter() - t0
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        added = {k: f.launches - before[k] for k, f in counters.items()}
        for k, f in counters.items():
            f.launches = before[k]      # a capture launches nothing
        if failure is not None:
            raise GraphCaptureError(
                f"capturing solver step {key!r} as a CUDA graph failed: "
                f"{failure}") from failure
        self.graphs[key] = graph
        self.launches[key] = {k: n for k, n in added.items() if n}
        self.posted[key] = posted
        self.kept[key] = kept


# ---- the route switch the solvers share ----

# the unrolled passes of a captured branch step: ortho_vs_x's projection
# passes, ortho_cd's refinement passes and the Cholesky shift retries (a
# step whose loops need more is run again uncaptured)
_UNROLL = {"vs": 2, "cd": 3, "shift": 0}
_ROUTES = ("graphs", "eager", "unrolled")
# a private route and pass budget in force (see _recording)
_RECORDING = [None]


class _recording:
    """Private: run the solvers whose iterations are steps (davidson,
    gen_david, lobpcg, caslr, caslr_eff, nonsym, and so their ladders) on
    ``route`` ("graphs": the steps captured and replayed as CUDA graphs;
    "eager": the same steps called directly, the ortho loops reading their
    predicates; "unrolled": called directly with the captured route's
    fixed passes and rare-branch reruns) with the pass ``budgets``; None
    keeps the solve's own choice.  ``solves`` holds the records of the
    solves run under it, from a ``profiling.solve_log`` it keeps open,
    each with every flag the solve read, in order (``flag_history``)."""

    def __init__(self, route=None, budgets=None):
        if route is not None and route not in _ROUTES:
            raise ValueError(f"route must be one of {_ROUTES}, got {route!r}")
        self.route, self.budgets = route, budgets

    def __enter__(self):
        self.prev = _RECORDING[0]
        _RECORDING[0] = self
        self._log = profiling.solve_log()
        self.log = self._log.__enter__()
        self.log._flags = True
        return self

    def __exit__(self, *exc):
        self._log.__exit__(*exc)
        _RECORDING[0] = self.prev

    @property
    def solves(self) -> list:
        return self.log.records


def _on_route(fn, route=None, budgets=None):
    """Private: ``fn()`` under ``_recording(route, budgets)``, every launch
    count at 0 before it (and a device barrier after it once CUDA is in
    use).  Returns (its result, the records of its solves, the launches by
    kernel)."""
    counters = kernel_counters()
    for f in counters.values():
        f.launches = 0
    with _recording(route, budgets) as rec:
        out = fn()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    return out, rec.solves, {k: f.launches for k, f in counters.items()}


def _read_flags(flags: torch.Tensor) -> list:
    """The host's one read of the device an iteration: the packed flags
    of the ritz step, (ok, n_frozen, finished, ortho_ok, stall), finished
    and ortho_ok of the branch step before it.  ``observer``, when set, is
    called after each read."""
    _read_flags.count += 1
    out = flags.tolist()
    if _read_flags.observer is not None:
        _read_flags.observer()
    return out


_read_flags.count = 0
_read_flags.observer = None


def _route(dev, sharding) -> str:
    """The route of a solve on ``dev`` under ``sharding``: the private one
    in force, else "graphs" on CUDA tensors, unsharded or sharded over an
    NCCL group, and "eager" otherwise (CPU tensors, a gloo group)."""
    capturable = dev.type == "cuda" and (sharding is None
                                         or sharding.backend == "nccl")
    rec = _RECORDING[0]
    route = rec.route if rec is not None and rec.route else (
        "graphs" if capturable else "eager")
    if route == "graphs" and not capturable:
        raise ValueError("the captured route needs CUDA tensors, unsharded "
                         "or sharded over an NCCL group")
    return route


def _budgets(route: str):
    """The pass budgets of the branch steps on ``route``: None (the eager
    loops) on "eager", else the private ones in force or :data:`_UNROLL`."""
    if route == "eager":
        return None
    rec = _RECORDING[0]
    return rec.budgets if rec is not None and rec.budgets else _UNROLL


# ---- the state and the host loop the solvers share ----

class StepState:
    """The part of a solve's fixed device state that every solver's steps
    keep alike.  A subclass allocates its buffers, then calls
    :meth:`_init_steps` (or :meth:`_alloc_steps`, and
    :meth:`_start_steps` at the start of each solve when the state is
    kept for the next); its ritz step calls :meth:`keep_ritz` first and
    :meth:`pack_flags` last; each branch step keeps its inputs and runs
    its body inside :meth:`_ortho`, then calls :meth:`_close`.
    ``BODIES`` maps each branch to the method that runs it from the kept
    inputs, which :meth:`rerun` calls with the eager loops.
    ``CALLABLES`` names the attributes that hold the solve's callables,
    which :meth:`release` drops when the state is kept between solves."""

    # what a ritz step changes and the steps read back, put back by
    # undo_ritz before an iteration is run again
    RITZ_KEPT = ("done", "rms", "rmx", "eig", "it")
    BODIES: dict = {}
    CALLABLES: tuple = ()

    def _init_steps(self, ortho_ok, budgets, device):
        self._alloc_steps(budgets, device)
        self._start_steps(ortho_ok)

    def _alloc_steps(self, budgets, device):
        self.budgets = budgets
        i64 = torch.int64
        self.ortho_ok = torch.empty((), dtype=torch.bool, device=device)
        self.ok = torch.empty((), dtype=torch.bool, device=device)
        self.flags = torch.empty(5, dtype=i64, device=device)
        # whether the residuals stopped falling: set by a ritz step that
        # watches them (a ladder's float32 Davidson stage), else False
        self.stall = torch.empty((), dtype=torch.bool, device=device)
        # the last branch step's outcome: whether its loops finished, and
        # ortho_ok before it (for a rerun)
        self.finished3 = torch.empty((), dtype=torch.bool, device=device)
        self.ortho_ok3 = torch.empty((), dtype=torch.bool, device=device)
        self.kept = {name: torch.empty_like(getattr(self, name))
                     for name in self.RITZ_KEPT}

    def _start_steps(self, ortho_ok):
        """A solve's starting values of what :meth:`_alloc_steps` made."""
        self.passes = eager_passes()
        self.ortho_ok0 = bool(ortho_ok)     # the prologue's, on the host
        self.ortho_ok.fill_(self.ortho_ok0)
        self.ok.zero_()
        self.flags.zero_()
        self.stall.zero_()
        self.finished3.fill_(True)
        self.ortho_ok3.zero_()
        for kept in self.kept.values():
            kept.zero_()

    def release(self):
        """Drop the solve's callables (the state is kept for the next)."""
        for name in self.CALLABLES:
            setattr(self, name, None)

    def keep_ritz(self):
        for name, kept in self.kept.items():
            kept.copy_(getattr(self, name))

    def undo_ritz(self):
        for name, kept in self.kept.items():
            getattr(self, name).copy_(kept)

    def pack_flags(self):
        self.flags.copy_(torch.stack([
            self.ok.to(torch.int64), self.n_frozen,
            self.finished3.to(torch.int64), self.ortho_ok.to(torch.int64),
            self.stall.to(torch.int64)]))

    def _ortho(self):
        """The ortho loops of a branch step: unrolled to the budgets, or
        eager with their passes counted."""
        return (unrolled(self.budgets) if self.budgets is not None
                else self.passes)

    def _close(self, step_ok, rec):
        """ortho_ok and the finished bit of a branch step."""
        self.ortho_ok3.copy_(self.ortho_ok)
        self.ortho_ok.copy_(self.ortho_ok & step_ok)
        if isinstance(rec, unrolled) and rec.finished is not None:
            self.finished3.copy_(rec.finished)
        else:
            self.finished3.fill_(True)

    def rerun(self, branch: str):
        """Run the last branch step (``branch``) again from its kept
        inputs, with the eager ortho loops: the loops' own result."""
        self.ortho_ok.copy_(self.ortho_ok3)
        budgets, self.budgets = self.budgets, None
        try:
            getattr(self, self.BODIES[branch])()
        finally:
            self.budgets = budgets


class StepLoop:
    """The host side of a solve run in steps over a :class:`StepState`
    ``st``, on ``route`` ("graphs" captures each step once and replays
    it); use as a context around the loop.  ``graphs``: the
    :class:`StepGraphs` kept with ``st`` from an earlier solve (the
    record's ``reused``), or None for new ones.

    :meth:`iterate` runs the first step (``st.matvec``), the reduced solve
    between the steps (its argument, uncaptured) and the ritz step
    (``st.ritz``), and reads the flags; when the branch step before them
    did not finish its unrolled loops it undoes the ritz step, reruns that
    branch step with the eager loops and runs the iteration again.
    :meth:`branch` runs a branch step; :meth:`close` settles the last one
    after the loop; :meth:`record` files the solve's record.  ``scopes``
    names the phase scope of each step (None: no scope).  ``ok`` and
    ``stalled`` are the last iteration's converged and stall bits."""

    def __init__(self, name, st, device, route, scopes, graphs=None):
        self.name, self.st, self.route, self.scopes = name, st, route, scopes
        # graphs kept with st from an earlier solve (StepCache), else new
        self.reused = graphs is not None
        if graphs is None:
            graphs = StepGraphs(device, capture=route == "graphs",
                                sharding=current_sharding())
        else:
            graphs.new_solve()
        self.graphs = graphs
        self.reads0 = _read_flags.count
        self.flag_history = []      # every flag read, as the host saw it
        self.reruns = dict.fromkeys(st.BODIES, 0)
        self.pending = None     # the branch step whose finished bit is unread
        self.ortho_ok = st.ortho_ok0
        self.ok = self.stalled = False

    def __enter__(self):
        self.graphs.__enter__()
        # the solve's record, summed as it runs (None with no log open)
        self.sums = profiling._begin_solve(self.name, self.route)
        return self

    def __exit__(self, *exc):
        profiling._end_solve(self.sums)
        return self.graphs.__exit__(*exc)

    def _scope(self, step):
        name = self.scopes.get(step)
        return profiling._span(name) if name else profiling._NULL

    def _run(self, step):
        with self._scope(step):
            self.graphs.run(step, getattr(self.st, step))

    def _read(self, flags):
        out = _read_flags(flags)
        self.flag_history.append(out)
        return out

    def _steps(self, reduce):
        self._run("matvec")
        with self._scope("ritz"):
            with profiling._span("reduced-solve"):
                reduce()
            self.graphs.run("ritz", self.st.ritz)
        return self._read(self.st.flags)

    def _rerun(self, branch):
        # a rare branch: the unrolled ortho loops of that step fell short
        # (more passes, a shift retry, the QR fallback or the SVD rescue);
        # its inputs were kept, so it runs again uncaptured with the eager
        # loops, which gives the loops' own result
        self.reruns[branch] += 1
        with self._scope(branch), profiling._span("step-rerun"):
            self.st.rerun(branch)

    def iterate(self, reduce):
        """One iteration's steps 1-2 and its flag read; returns (ok,
        n_frozen) and keeps ``ok`` and ``stalled``."""
        ok, n_frozen, finished, ortho_ok, stall = self._steps(reduce)
        if self.pending and not finished:
            self.st.undo_ritz()
            self._rerun(self.pending)
            ok, n_frozen, finished, ortho_ok, stall = self._steps(reduce)
        self.pending = None
        self.ortho_ok = bool(ortho_ok)
        self.ok, self.stalled = bool(ok), bool(stall)
        return self.ok, n_frozen

    def branch(self, name):
        """Run the branch step ``name``; its finished bit is read with the
        next iteration's flags (or by :meth:`close`)."""
        self.pending = name
        self._run(name)

    def close(self) -> bool:
        """After the loop: a branch step run last (max_iter ran out after
        it) is settled, since its ortho_ok still counts.  Returns
        ortho_ok."""
        if self.pending:
            finished, ortho_ok = self._read(
                torch.stack([self.st.finished3, self.st.ortho_ok]))
            if not finished:
                self._rerun(self.pending)
                ortho_ok = bool(self.st.ortho_ok)
            self.ortho_ok = bool(ortho_ok)
            self.pending = None
        return self.ortho_ok

    def record(self, iterations, dtype, verbose):
        """File the solve's record into the open logs, and print it when
        ``verbose``.  Its ``end``: "tol" when the last iteration converged,
        "stall" when its residuals had stopped falling, else "max_iter"."""
        g = self.graphs
        rec = self.sums
        end = "tol" if self.ok else "stall" if self.stalled else "max_iter"
        if rec is not None:
            rec.update(dtype=str(dtype).split(".")[-1], iterations=iterations,
                       end=end,
                       flag_reads=_read_flags.count - self.reads0,
                       reruns=dict(self.reruns),
                       passes=dict(self.st.passes.most),
                       capture_s=g.capture_s, pool_bytes=g.pool_bytes,
                       replays=dict(g.replays), reused=self.reused)
            profiling._file(rec, self.flag_history)
        if verbose:
            print(f"{self.name} route={self.route} iterations={iterations} "
                  f"end={end} rare-branch reruns {self.reruns} eager ortho "
                  f"passes at most {dict(self.st.passes.most)} graph capture "
                  f"{g.capture_s:.3f} s", flush=True)


# ---- the states and graphs kept from one solve to the next ----

# the most entries (a state and its graphs) the cache keeps a device: a
# Davidson ladder of one shape takes two, one a stage
STEP_CACHE_SIZE = 4

# the callables marked by replayable
_REPLAYABLE = weakref.WeakSet()


def replayable(fn):
    """Mark ``fn``, a function that reads only tensors and numbers fixed
    when it was made, as one whose captured steps a later solve may
    replay (:class:`StepCache`); returns ``fn``.  A replay reads the
    device memory and the numbers the capture saw: a tensor changed in
    place is read anew, a tensor or number rebound is not.  The port's
    operator constructors (``problems.dense_matvec``, ``diag_precnd``,
    the ``ops`` matvecs) mark the closures they return; any other
    callable is captured anew each solve."""
    _REPLAYABLE.add(fn)
    return fn


def _marked(fn) -> bool:
    try:
        return fn in _REPLAYABLE
    except TypeError:           # no hash
        return False


class StepCache:
    """The step states and their :class:`StepGraphs` kept from one solve
    to the next (the module docstring): ``take`` the entry of a key before
    a solve, ``put`` it back after.  A solve runs on the entry it took, so
    one that fails takes its entry with it.  ``size`` entries a device at
    most, the least recently used dropped first.  :meth:`clear` frees
    them all."""

    def __init__(self, size: int):
        self.size = size
        self._devices: dict = {}    # device -> OrderedDict(key -> entry)

    def key(self, solver: str, callables, *fixed):
        """The key of a solve by ``solver`` with ``callables`` (None where
        the solve has none), and ``fixed``: everything else its captured
        steps bind (dict values are frozen).  The callables are held
        weakly; their collection drops every entry keyed by them.  None
        (nothing kept) when a callable is not marked :func:`replayable`
        or the key cannot be hashed."""
        if not all(fn is None or _marked(fn) for fn in callables):
            return None
        refs = tuple(fn if fn is None else weakref.ref(fn, self._drop_dead)
                     for fn in callables)
        key = (solver, refs) + tuple(
            tuple(sorted(v.items())) if isinstance(v, dict) else v
            for v in fixed)
        try:
            hash(key)
        except TypeError:
            return None
        return key

    def take(self, key, device):
        """(state, graphs) kept under ``key`` on ``device``, taken out of
        the cache; (None, None) on a miss, with no key, or while another
        solve runs on a state of the entry's arena."""
        entries = self._devices.get(torch.device(device))
        entry = None if key is None or entries is None else entries.get(key)
        arena = None if entry is None else getattr(entry[0], "arena", None)
        if entry is None or (arena is not None and arena.busy):
            return None, None
        del entries[key]
        return entry

    def put(self, key, device, state, graphs):
        """Keep ``state`` (its callables released, its arena free) and
        ``graphs`` under ``key`` (None: keep nothing), as the most recently
        used entry."""
        if key is None:
            return
        state.release()
        if getattr(state, "arena", None) is not None:
            state.arena.busy = False
        entries = self._devices.setdefault(torch.device(device),
                                           collections.OrderedDict())
        entries[key] = (state, graphs)
        while len(entries) > self.size:
            entries.popitem(last=False)

    def __len__(self):
        return sum(len(e) for e in self._devices.values())

    def clear(self):
        self._devices.clear()

    def _drop_dead(self, _ref=None):
        for entries in self._devices.values():
            for key in [k for k in list(entries)
                        if any(r is not None and r() is None for r in k[1])]:
                entries.pop(key, None)


STEP_CACHE = StepCache(STEP_CACHE_SIZE)


class Arena:
    """Device bytes that the buffers of the two step states made by one
    ladder call share (:meth:`ladder`): its stages run one after the
    other, each writing every buffer its steps read before they read it.
    ``busy`` while a solve runs on a state in the arena, from the solver's
    taking the state until :meth:`StepCache.put`: the cache hands out no
    other state of the arena meanwhile (a solve run from inside another,
    or on another thread, makes its own state).  A solve that fails
    leaves its arena busy, so the other stage's state is made anew."""

    ALIGN = 512         # each buffer starts on a multiple of it

    # the arena of the ladder call running, in a one-item list, or None
    _LADDER = contextvars.ContextVar("ladder_arena", default=None)

    def __init__(self, nbytes: int, device):
        self.bytes = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.busy = False

    @classmethod
    def nbytes(cls, shapes, itemsize: int) -> int:
        """Bytes that buffers of ``shapes`` take at ``itemsize``."""
        return sum(cls._aligned(math.prod(s) * itemsize) for s in shapes)

    @classmethod
    def _aligned(cls, nbytes: int) -> int:
        return -(-nbytes // cls.ALIGN) * cls.ALIGN

    @classmethod
    @contextlib.contextmanager
    def ladder(cls):
        """Around one ladder call: the states its stages make share the
        arena that :meth:`of_ladder` makes for the first of them."""
        token = cls._LADDER.set([None])
        try:
            yield
        finally:
            cls._LADDER.reset(token)

    @classmethod
    def of_ladder(cls, nbytes: int, device):
        """The arena of the running ladder call, of ``nbytes`` at least
        (a new one when the call has none that large); None outside a
        ladder call."""
        slot = cls._LADDER.get()
        if slot is None:
            return None
        if slot[0] is None or slot[0].bytes.numel() < nbytes:
            slot[0] = cls(nbytes, device)
        return slot[0]

    def buffers(self, shapes, dtype) -> list:
        """Uninitialized buffers of ``shapes`` in ``dtype``, in order."""
        out, at = [], 0
        for shape in shapes:
            nbytes = math.prod(shape) * dtype.itemsize
            out.append(self.bytes[at:at + nbytes].view(dtype).view(shape))
            at += self._aligned(nbytes)
        return out
