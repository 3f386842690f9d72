"""``capture_idle_pct`` (%, device trace; layer: step loop): the share of
the traced window's device idle time during which the host was in one of
the program's ``step-warmup``, ``graph-capture`` and ``step-rerun``
spans (``trace["leaf_idle"]``, ``benchmark/step_loop.py``)."""

from benchmark import step_loop


def read(run):
    if run.trace is None or "leaf_idle" not in run.trace:
        return None
    idle = dict(run.trace["leaf_idle"])
    total = sum(idle.values())
    if total <= 0:
        return None
    return 100.0 * sum(idle.get(k, 0.0) for k in step_loop.CAPTURE_SPANS) \
        / total
