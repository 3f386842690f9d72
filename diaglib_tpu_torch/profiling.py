"""Tracing and timing (port of ``diaglib_tpu/profiling.py``).

* :func:`trace` records a block of work with ``torch.profiler`` (CPU
  activity, and the card's kernels when there is a card) and writes a
  Chrome trace into a directory.  The solvers mark their phases with
  ``torch.profiler.record_function`` (``matvec``, ``rayleigh-ritz``,
  ``expand-ortho`` in ``davidson``), as the reference's
  ``jax.named_scope`` annotations, so the trace attributes time to them.
* :func:`wall` and :func:`phase_timings` time a call on the host's clock,
  with a device barrier after it.
* :func:`collective_inventory` counts the collectives of one run: parsed
  from compiled HLO text, as the reference does, or recorded from the
  port's ``torch.distributed`` calls.
"""

from __future__ import annotations

import contextlib
import os
import re
import socket
import time

import torch
import torch.distributed as dist

from ._tree import leaves

__all__ = ["trace", "wall", "phase_timings", "collective_inventory"]

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


@contextlib.contextmanager
def _recording(inv):
    """Count every collective the port issues through torch.distributed
    into ``inv``; a ring permute's send/receive pair
    (``dist.batch_isend_irecv``) counts once, by its received bytes."""
    def note(kind, tensors):
        rec = inv.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += _nbytes(tensors)

    def wrap(name, kind, outputs):
        real = getattr(dist, name)

        def call(*args, **kwargs):
            note(kind, outputs(args))
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
                note("collective-permute", [op.tensor])
        return real_batch(p2p_op_list)

    saved["batch_isend_irecv"] = real_batch
    dist.batch_isend_irecv = batch
    try:
        yield inv
    finally:
        for name, real in saved.items():
            setattr(dist, name, real)


def collective_inventory(hlo_text, *args, **kwargs):
    """``{op_kind: {"count": N, "bytes": B}}`` of the collectives of a
    program, B summing output bytes.

    Given a ``str``, it parses compiled HLO text exactly as the reference
    does.  Given a callable, it runs ``hlo_text(*args, **kwargs)`` once
    and records the ``torch.distributed`` calls made under it, the eager
    counterpart of reading a compiled program: ``all_reduce`` counts as
    "all-reduce", ``all_gather`` as "all-gather", and each ring permute's
    send/receive pair as one "collective-permute".  An extra collective in
    a sharded solver step changes it deterministically.
    """
    if isinstance(hlo_text, str):
        return _hlo_inventory(hlo_text)
    inv = {}
    with _recording(inv):
        hlo_text(*args, **kwargs)
    return inv


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block of work: ``with trace("/tmp/prof") as prof: solve()``.

    Records CPU activity, and CUDA activity when a card is present, and
    writes a Chrome trace (``*.pt.trace.json``) into ``log_dir``.  Yields
    the ``torch.profiler.profile`` (its ``key_averages()`` and ``events()``
    stay readable after the block).
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(log_dir, name + ".pt.trace.json"))


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
