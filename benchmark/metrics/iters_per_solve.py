"""``iters_per_solve`` (iter/solve, program counter; layer: ladder): both
stages' iterations (the ladder's ``n_iter``), averaged over the traced
solves."""


def read(run):
    if run.trace is None or not run.trace["solves"]:
        return None
    solves = run.trace["solves"]
    return sum(s.n_iter for s in solves) / len(solves)
