"""``reduced_host_ms_per_iter`` (ms/iter, program span; layer: reduced
solve): host ms of the program's ``reduced-solve`` spans over the
iterations, both ladder stages, summed over the window's solves after the
traced ones (``benchmark/step_loop.py``).  The span holds the host's wait
for the matvec step whose results the reduced solve reads, and an
iteration run again after a rerun counts its second reduced solve."""

from benchmark import step_loop


def read(run):
    solves = step_loop.window_records(run)
    if solves is None:
        return None
    iters = sum(r["iterations"] for recs in solves for r in recs)
    if not iters:
        return None
    return sum(r["reduced_ms"] for recs in solves for r in recs) / iters
