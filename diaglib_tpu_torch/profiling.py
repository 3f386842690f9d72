"""Tracing and timing (port of ``diaglib_tpu/profiling.py``).

* :func:`trace` records a block of work with ``torch.profiler`` (CPU
  activity, and the card's kernels when there is a card) and writes a
  Chrome trace into a directory.  The solvers mark their phases with
  spans (``matvec``, ``rayleigh-ritz``, ``expand-ortho``), as the
  reference's ``jax.named_scope`` annotations, so the trace attributes
  time to them.
* :func:`wall` and :func:`phase_timings` time a call on the host's clock,
  with a device barrier after it.
* :func:`collective_inventory` counts the collectives of one run: parsed
  from compiled HLO text, as the reference does, or recorded from the
  port's ``torch.distributed`` calls.
* :func:`solve_log` keeps the solves run under it: one record a solver
  call (a ladder's stage is a call of its own), summed while the solve
  runs, and the spans the solvers opened, on the host's clock.

Every span the port opens (the phase scopes, and the step loop's leaf
spans :data:`LEAF_SPANS`, ``utils/graphs.py``) goes through one helper:
under a running ``torch.profiler`` it is a ``record_function`` of its
name, in an open :func:`solve_log` it is appended to the log, and with
neither it is a shared null context and costs nothing more.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import re
import socket
import time
import typing

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ._tree import leaves

__all__ = ["trace", "wall", "phase_timings", "collective_inventory",
           "solve_log", "SolveLog", "Span", "LEAF_SPANS"]

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4,
                "u32": 4, "s8": 1, "u8": 1, "pred": 1, "s64": 8, "u64": 8}
_COLL_RE = re.compile(
    r"=\s*(?:\()?([a-z0-9]+)\[([\d,]*)\][^ ]*\s+"
    r"(all-reduce|all-gather|reduce-scatter|collective-permute|all-to-all)"
    r"(-start)?\(")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _hlo_inventory(hlo_text: str):
    """The reference's parse of compiled HLO: the op kind, count and output
    bytes of every collective (async -start/-done pairs counted once)."""
    inv = {}
    for m in _COLL_RE.finditer(hlo_text):
        dt, dims, kind, _ = m.groups()
        n_elems = 1
        for d in dims.split(","):
            if d.strip():
                n_elems *= int(d)
        rec = inv.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += n_elems * _DTYPE_BYTES.get(dt, 4)
    return inv


# the collectives the port issues (parallel/sharding.py): name -> (kind,
# the output tensors of a call's positional arguments)
_RECORDED = {
    "all_reduce": ("all-reduce", lambda a: [a[0]]),
    "all_gather": ("all-gather", lambda a: a[0]),
}


# the inventories recording now, outermost first: each collective the
# port issues is counted into every one of them
_LIVE: list = []


def _note(kind, nbytes):
    for inv in _LIVE:
        rec = inv.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += nbytes


@contextlib.contextmanager
def _patched():
    """torch.distributed's collectives counted into the live inventories
    (patched once however deep the recordings nest); a ring permute's
    send/receive pair (``dist.batch_isend_irecv``) counts once, by its
    received bytes."""
    if _patched.on:
        yield
        return

    def wrap(name, kind, outputs):
        real = getattr(dist, name)

        def call(*args, **kwargs):
            _note(kind, _nbytes(outputs(args)))
            return real(*args, **kwargs)

        return real, call

    saved = {}
    for name, (kind, outputs) in _RECORDED.items():
        saved[name], patched = wrap(name, kind, outputs)
        setattr(dist, name, patched)
    real_batch = dist.batch_isend_irecv

    def batch(p2p_op_list):
        for op in p2p_op_list:
            if op.op is dist.irecv:
                _note("collective-permute", _nbytes([op.tensor]))
        return real_batch(p2p_op_list)

    saved["batch_isend_irecv"] = real_batch
    dist.batch_isend_irecv = batch
    _patched.on = True
    try:
        yield
    finally:
        _patched.on = False
        for name, real in saved.items():
            setattr(dist, name, real)


_patched.on = False


@contextlib.contextmanager
def _recording(inv):
    """Count every collective the port issues through torch.distributed
    into ``inv`` (and into the recordings around it)."""
    _LIVE.append(inv)
    try:
        with _patched():
            yield inv
    finally:
        _LIVE.remove(inv)


@contextlib.contextmanager
def _captured(posted):
    """A CUDA graph capture (``utils.graphs.StepGraphs``): what it posts
    is recorded into ``posted`` alone, since a capture runs nothing; the
    graph's replays count it (:func:`_replayed`)."""
    live = _LIVE[:]
    _LIVE.clear()
    try:
        with _recording(posted):
            yield posted
    finally:
        _LIVE[:] = live


def _replayed(posted):
    """A replay of a captured graph that posted ``posted``: counted into
    the live inventories as if its collectives ran again."""
    for inv in _LIVE:
        for kind, rec in posted.items():
            mine = inv.setdefault(kind, {"count": 0, "bytes": 0})
            mine["count"] += rec["count"]
            mine["bytes"] += rec["bytes"]


def collective_inventory(hlo_text, *args, **kwargs):
    """``{op_kind: {"count": N, "bytes": B}}`` of the collectives of a
    program, B summing output bytes.

    Given a ``str``, it parses compiled HLO text exactly as the reference
    does.  Given a callable, it runs ``hlo_text(*args, **kwargs)`` once
    and records the ``torch.distributed`` calls made under it, the eager
    counterpart of reading a compiled program: ``all_reduce`` counts as
    "all-reduce", ``all_gather`` as "all-gather", and each ring permute's
    send/receive pair as one "collective-permute".  An extra collective in
    a sharded solver step changes it deterministically.  A solver step
    captured as a CUDA graph (the sharded solves under NCCL) counts its
    collectives at each replay, as its warm-up call counted them, and its
    capture counts none: the inventory is the collectives that ran.
    """
    if isinstance(hlo_text, str):
        return _hlo_inventory(hlo_text)
    inv = {}
    with _recording(inv):
        hlo_text(*args, **kwargs)
    return inv


# ---- spans and the solve log ----

# the step loop's spans (utils/graphs.py), none inside another: a step's
# first, uncaptured call; its capture (capture_begin to capture_end,
# instantiation included); a branch step run again with the eager ortho
# loops; the host's reduced solve between the steps (inside rayleigh-ritz)
LEAF_SPANS = ("step-warmup", "graph-capture", "step-rerun", "reduced-solve")
# the record's (count, host ms) fields that a leaf span adds to
_SUMS = {"step-warmup": ("warmups", "warmup_ms"),
         "graph-capture": ("captures", "capture_ms"),
         "reduced-solve": ("reduced", "reduced_ms")}
# the span :func:`trace` opens to place a log's clock on the trace's
_ANCHOR = "solve-log-anchor"
SPAN_CAP = 65536        # a log keeps its newest SPAN_CAP spans

_NULL = contextlib.nullcontext()
_LOGS: list = []        # the open logs, outermost first
_OPEN: list = []        # the ids of the logged spans open now
_SOLVES: list = []      # the records of the solves running now
_SPAN_IDS = itertools.count(1)
_SOLVE_IDS = itertools.count(1)


class Span(typing.NamedTuple):
    """One span of a :class:`SolveLog`: ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns()``'s clock, the id of the logged span it was
    opened in (``parent``, None at the top) and the id of the solve it ran
    in (``solve``, a record's ``"solve"``; None outside a solve)."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    solve: int | None


class SolveLog:
    """What :func:`solve_log` keeps.

    ``records``: one dict a solver call, in the order the calls ended.
    A ladder's stages are calls of their own, each with its record.
    Every record is summed while its solve runs:

    * ``solve`` (its id), ``solver``, ``route`` ("graphs", "eager",
      "unrolled") and ``dtype``;
    * ``iterations`` and ``flag_reads`` (the host's reads of the packed
      flags: one an iteration and one a rerun); ``end``, how the loop
      ended: "tol" (converged), "stall" (a Davidson ladder's float32
      stage whose residuals stopped falling) or "max_iter";
    * ``reruns``, rare-branch reruns by step; ``passes``, the most passes
      the eager ortho loops took;
    * ``warmups`` / ``warmup_ms`` and ``captures`` / ``capture_ms``: the
      count and host ms of the ``step-warmup`` and ``graph-capture``
      spans, one each a step key on the captured route, none elsewhere;
      ``capture_s``, the graphs' own capture clock (the pool's handle
      included), kept with no log too;
    * ``pool_bytes``, the device memory the graphs' pool reserved while
      capturing; ``replays``, the replays by step key (all of these
      count this solve only, also on graphs kept from earlier solves);
    * ``reused``: whether the solve ran on a state and graphs kept from an
      earlier solve of the same shape (``utils.graphs.StepCache``; then
      no warm-up and no capture of the keys that solve ran);
    * ``reduced`` / ``reduced_ms``: the count and host ms of the
      ``reduced-solve`` spans (the host's wait for the matvec step the
      reduced solve reads is in them).

    ``spans``: the newest :data:`SPAN_CAP` (65536) spans
    (:class:`Span`), each phase scope and leaf span the solvers opened, in
    the order they closed.  ``offset_us``: after a :func:`trace` that
    began with this log open, the trace's clock less the log's, in
    microseconds (:meth:`on_trace`); None before."""

    def __init__(self):
        self.records: list = []
        self.spans: collections.deque = collections.deque(maxlen=SPAN_CAP)
        self.offset_us: float | None = None
        self._flags = False     # records keep their flag_history

    def on_trace(self, span: Span) -> tuple:
        """(start, end) of ``span`` on the trace's clock, in microseconds,
        as the Chrome trace's ``ts`` of the same span."""
        if self.offset_us is None:
            raise ValueError("no trace has placed this log's clock")
        return (span.start_ns / 1e3 + self.offset_us,
                span.end_ns / 1e3 + self.offset_us)


@contextlib.contextmanager
def solve_log():
    """Keep the solves run in the block: ``with solve_log() as log:
    solve()``, then ``log.records`` and ``log.spans`` (:class:`SolveLog`).
    Logs nest; each open one keeps everything.  The open logs are the
    process's: run the solves they keep from one thread."""
    log = SolveLog()
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


class _Span:
    """A span: a ``record_function`` of its name under a running profiler,
    and, with a log open, appended to every open log when it closes (and
    added to the running solve's record, for a leaf span in ``_SUMS``)."""

    __slots__ = ("name", "scope", "id", "parent", "start")

    def __init__(self, name, profiled):
        self.name = name
        self.scope = record_function(name) if profiled else None
        self.id = None

    # the log's clock is read right inside the record_function's bounds,
    # its bookkeeping (which may run the garbage collector) kept outside
    def __enter__(self):
        if _LOGS:
            self.id = next(_SPAN_IDS)
            self.parent = _OPEN[-1] if _OPEN else None
            _OPEN.append(self.id)
        if self.scope is not None:
            self.scope.__enter__()
        if self.id is not None:
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.scope is not None:
            self.scope.__exit__(*exc)
        if self.id is not None:
            _OPEN.remove(self.id)
            rec = _SOLVES[-1] if _SOLVES else None
            span = Span(self.id, self.name, self.start, end, self.parent,
                        rec["solve"] if rec is not None else None)
            for log in _LOGS:
                log.spans.append(span)
            if rec is not None and self.name in _SUMS:
                count, ms = _SUMS[self.name]
                rec[count] += 1
                rec[ms] += (end - self.start) / 1e6
        return False


def _span(name: str):
    """The context every span of the port opens (the module docstring):
    the shared null context when no profiler runs and no log is open."""
    profiled = torch._C._autograd._profiler_enabled()
    if not (profiled or _LOGS):
        return _NULL
    return _Span(name, profiled)


def _begin_solve(solver: str, route: str):
    """A solve's record, summed while it runs (``utils.graphs.StepLoop``),
    or None with no log open."""
    if not _LOGS:
        return None
    rec = dict(solve=next(_SOLVE_IDS), solver=solver, route=route,
               dtype=None, iterations=0, flag_reads=0, reruns={}, passes={},
               warmups=0, warmup_ms=0.0, captures=0, capture_ms=0.0,
               capture_s=0.0, pool_bytes=0, replays={}, reused=False,
               reduced=0, reduced_ms=0.0)
    _SOLVES.append(rec)
    return rec


def _end_solve(rec) -> None:
    if rec is not None:
        _SOLVES.remove(rec)


def _file(rec, flag_history) -> None:
    """File a finished solve's record into the open logs; the private
    route switch's logs (``utils.graphs._recording``) keep every flag the
    solve read, too."""
    for log in _LOGS:
        log.records.append(dict(rec, flag_history=flag_history)
                           if log._flags else rec)


def _anchor():
    """(logs, start ns, end ns) of an anchor span opened under the running
    profiler, for the logs open now: the bounds of the start of the second
    of two (a first ``record_function`` may take a millisecond to open)."""
    for _ in range(2):
        t0 = time.perf_counter_ns()
        with record_function(_ANCHOR):
            t1 = time.perf_counter_ns()
    return list(_LOGS), t0, t1


def _place(path, anchored) -> None:
    """Each anchored log's ``offset_us``: the anchor's ``ts`` in the
    Chrome trace at ``path`` less the middle of its start's bounds on the
    log's clock (off by at most half their distance, a few
    microseconds)."""
    logs, t0, t1 = anchored
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ts = max(e["ts"] for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == _ANCHOR)
    for log in logs:
        log.offset_us = ts - (t0 + t1) / 2e3


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block of work: ``with trace("/tmp/prof") as prof: solve()``.

    Records CPU activity, and CUDA activity when a card is present, and
    writes a Chrome trace (``*.pt.trace.json``) into ``log_dir``.  Yields
    the ``torch.profiler.profile`` (its ``key_averages()`` and ``events()``
    stay readable after the block).  The solvers' spans are
    ``record_function`` scopes in it.  The :func:`solve_log` logs open
    when it begins get the offset of the trace's clock from theirs
    (``SolveLog.offset_us``), from an anchor span read on both.
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    anchored = None
    with torch.profiler.profile(activities=acts) as prof:
        if _LOGS:
            anchored = _anchor()
        yield prof
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
    path = os.path.join(log_dir, name + ".pt.trace.json")
    prof.export_chrome_trace(path)
    if anchored is not None:
        _place(path, anchored)


def _sync(tree) -> None:
    """A device barrier on the card of every CUDA tensor in a result."""
    devs = {t.device for t in leaves(tree)
            if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devs:
        torch.cuda.synchronize(dev)


def wall(fn, *args, **kwargs):
    """(result, seconds) of one call, with a device barrier after it on the
    card of every CUDA tensor in the result."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync(out)
    return out, time.perf_counter() - t0


def phase_timings(matvec, x, reps: int = 10):
    """Seconds a call of an operator application (the reference's t_mv):
    one warm-up call, then ``reps`` calls and a device barrier."""
    _sync(matvec(x))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = matvec(x)
    _sync(out)
    return (time.perf_counter() - t0) / reps
