"""``ortho_dev_ms_per_iter`` (ms/iter, device trace; layer: ortho): device
ms of the kernels launched under the solver's ``expand-ortho`` scope over
the traced solves' iterations."""


def read(run):
    if run.trace is None:
        return None
    _, _, dev_ms = run.trace["scopes"]["expand-ortho"]
    iters = sum(s.n_iter for s in run.trace["solves"])
    if dev_ms <= 0 or not iters:
        return None
    return dev_ms / iters
