"""``reduced_dev_ms_per_iter`` (ms/iter, device trace; layer: reduced
solve): device ms of the kernels launched under the program's
``reduced-solve`` spans (the eigensolve of the reduced matrix and the
products around it) over the traced solves' iterations
(``trace["leaf_scopes"]``, ``benchmark/step_loop.py``)."""


def read(run):
    if run.trace is None or "leaf_scopes" not in run.trace:
        return None
    _, _, dev_ms = run.trace["leaf_scopes"]["reduced-solve"]
    iters = sum(s.n_iter for s in run.trace["solves"])
    if dev_ms <= 0 or not iters:
        return None
    return dev_ms / iters
