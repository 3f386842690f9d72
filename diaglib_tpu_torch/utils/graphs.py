"""Capture and replay of a solver's iteration steps as CUDA graphs.

This is the port's counterpart of the reference's ``jax.jit`` around a
``lax.while_loop`` (``diaglib_tpu/utils/compile.py`` and the solvers'
loops): XLA compiles the whole loop into one device program, so the host
launches it once and reads nothing back until it ends.  PyTorch runs
eagerly, so the Davidson iteration (``solvers/davidson.py``) is cut into
steps over fixed buffers, each step is captured once per solve as a CUDA
graph and then replayed: one launch a step instead of a few hundred, and
no read of the device inside a step.

:class:`StepGraphs` holds one solve's graphs, one a step key (the caller
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
* a failed capture raises :class:`GraphCaptureError`; nothing falls back
  to the uncaptured loop.

Without capture (CPU tensors, ``sharding=`` runs, or on request) a step
is called directly.
"""

from __future__ import annotations

import time

import torch

__all__ = ["StepGraphs", "GraphCaptureError", "kernel_counters"]


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
    """One solve's CUDA graphs, made once and replayed (see the module
    docstring), or, with ``capture`` false, none.  Use as a context around
    the solve's loop; ``run(key, fn)`` runs the step ``fn`` (no arguments,
    results written into buffers that outlive the solve's loop).

    ``capture_s`` is the host time spent capturing, ``pool_bytes`` the
    device memory the graphs' shared pool reserved while capturing,
    ``replays`` the replays by key."""

    def __init__(self, device: torch.device, capture: bool = True):
        self.device = torch.device(device)
        self.capture = capture
        if capture and self.device.type != "cuda":
            raise ValueError(f"no CUDA graphs on {self.device}")
        self.stream = _capture_stream(self.device) if capture else None
        self.counters = kernel_counters() if capture else {}
        self.graphs: dict = {}
        self.launches: dict = {}
        self.replays: dict = {}
        self.capture_s = 0.0
        self.pool_bytes = 0
        self._pool = None

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
            fn()
            self._capture(key, fn)
            return
        graph.replay()
        for name, n in self.launches[key].items():
            self.counters[name].launches += n
        self.replays[key] = self.replays.get(key, 0) + 1

    def _capture(self, key, fn):
        counters = self.counters
        before = {k: f.launches for k, f in counters.items()}
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # capture_begin/end rather than torch.cuda.graph, whose entry
        # synchronizes the card and runs the garbage collector each time
        graph.capture_begin(pool=self._pool)
        failure = None
        try:
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
