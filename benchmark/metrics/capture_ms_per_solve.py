"""``capture_ms_per_solve`` (ms/solve, program span; layer: step loop):
host ms of the program's ``step-warmup`` and ``graph-capture`` spans (each
step's first, uncaptured call, and its CUDA graph capture with the
graph's instantiation) a solve, both ladder stages, averaged over the
window's solves after the traced ones (``benchmark/step_loop.py``)."""

from benchmark import step_loop


def read(run):
    solves = step_loop.window_records(run)
    if solves is None:
        return None
    return sum(r["warmup_ms"] + r["capture_ms"] for recs in solves
               for r in recs) / len(solves)
