"""``matvec_roofline`` (%, device trace; layer: operator and
kernels): the least time of the traced solves' operator applications
(``benchmark/work.py``, from the configuration's shapes at the traffic's
block width ``n_max``) over the device time the operator took.

The operator route (``operators/<operator>.py::operator_time``) says
which applications and which device time are its own: the sliced route
counts its kernels by name (K2 once an application, K1) wherever the
solver launched them."""

from benchmark import work


def read(run):
    if run.trace is None:
        return None
    count, device_s = run.operator.operator_time(run.trace)
    if device_s <= 0 or not count:
        return None
    least = work.least_application_s(run.shapes, run.traffic["n_max"])
    return 100.0 * count * least / device_s
