"""``ritz_host_ms_per_iter`` (ms/iter, program span; layer: reduced
solve): host ms under the solver's ``rayleigh-ritz`` scope over the
traced solves' iterations: the reduced solve, the ritz step's replay,
and the host's wait for the matvec step the reduced solve reads."""


def read(run):
    if run.trace is None:
        return None
    count, host_ms, _ = run.trace["scopes"]["rayleigh-ritz"]
    iters = sum(s.n_iter for s in run.trace["solves"])
    if not count or not iters:
        return None
    return host_ms / iters
