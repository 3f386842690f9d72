"""``device_idle_pct`` (%, device trace; layer: device): 100 minus the
share of the traced window (the traced solves, back to back) in which the
device ran a kernel, a copy or a fill."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
