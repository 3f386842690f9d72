"""``lo_iters_per_solve`` (iter/solve, program counter; layer: ladder):
the iterations of the ladder's float32 stage (its records of dtype
float32) a solve, averaged over the window's solves after the traced ones
(``benchmark/step_loop.py``); None where no solve ran a float32 stage."""

from benchmark import step_loop


def read(run):
    solves = step_loop.window_records(run)
    if solves is None or not any(r["dtype"] == "float32" for recs in solves
                                 for r in recs):
        return None
    return sum(r["iterations"] for recs in solves for r in recs
               if r["dtype"] == "float32") / len(solves)
