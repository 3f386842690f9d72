"""``reruns_per_solve`` (rerun/solve, program counter; layer: step loop):
rare-branch reruns a solve (a branch step whose unrolled ortho loops fell
short, run again uncaptured with the eager loops, and its iteration run
again), both ladder stages, averaged over the window's solves after the
traced ones (``benchmark/step_loop.py``)."""

from benchmark import step_loop


def read(run):
    solves = step_loop.window_records(run)
    if solves is None:
        return None
    return sum(sum(r["reruns"].values()) for recs in solves
               for r in recs) / len(solves)
