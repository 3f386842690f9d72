#!/usr/bin/env python3
"""The step loop's readings: graph capture, rare-branch reruns and the
reduced solve, from the program's per-solve records
(``diaglib_tpu_torch.profiling.solve_log``) and its leaf spans in the
trace.

The six readers (``metrics/capture_ms_per_solve.py``,
``reruns_per_solve.py``, ``reduced_host_ms_per_iter.py``,
``reduced_dev_ms_per_iter.py``, ``lo_iters_per_solve.py``,
``capture_idle_pct.py``) read a :class:`~benchmark.harness.Run` whose
solves carry their records (``Solve.records``: the records the solve
filed, one a ladder stage) and whose trace summary carries the leaf
spans' breakdown (``trace["leaf_scopes"]``, ``trace["leaf_idle"]``, by
:func:`leaf_trace`).  A run without them reads None.

Run as a script, it measures one cell as ``run.py`` does and adds what the
readers need:

    python3 benchmark/step_loop.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1> [--log 0|1]

Each solve runs inside a solve log of its own (``--log 0``: none), the
traced run's trace summary gains the leaf spans (the harness's summary is
wrapped), and the last line of standard output is ``run.py``'s result:
with ``--trace 1`` the six readings are added to its ``metrics`` and the
leaf spans' breakdown beside them; ``records_sum_to_n_iter`` says whether
every solve's records add up to its ``n_iter``, and ``stages`` splits the
records by ladder stage (:func:`stages`).  ``--trace 0 --log 0``
and ``--log 1`` give ``solve_s`` with the log closed and open.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

# the program's leaf spans (profiling.LEAF_SPANS), none inside another, so
# that tracing.scope_breakdown and tracing.idle_by_scope read them as one
# set; frozen here, as tracing.SCOPES is
LEAF_SPANS = ("step-warmup", "graph-capture", "step-rerun", "reduced-solve")
# the spans whose device idle time capture_idle_pct counts
CAPTURE_SPANS = ("step-warmup", "graph-capture", "step-rerun")
# the readers, with their units
READERS = {"capture_ms_per_solve": "ms/solve",
           "reruns_per_solve": "rerun/solve",
           "reduced_host_ms_per_iter": "ms/iter",
           "reduced_dev_ms_per_iter": "ms/iter",
           "lo_iters_per_solve": "iter/solve", "capture_idle_pct": "%"}


def window_records(run):
    """The records of each of the window's solves after the traced ones
    (all of them in an untraced run), or None where a solve has none."""
    from benchmark import harness

    solves = run.solves[harness.TRACE_SOLVES:] if run.trace else run.solves
    out = [getattr(s, "records", None) for s in solves]
    if not out or any(r is None for r in out):
        return None
    return out


def leaf_trace(events, t_window) -> dict:
    """What a trace summary adds for the leaf spans: ``leaf_scopes``,
    {name: [count, host ms, device ms of the kernels launched under
    it]}, and ``leaf_idle``, [[name, seconds]] of the window's device idle
    time by the leaf span the host was in ("outside" where none was)."""
    from benchmark import tracing

    t0, t1 = t_window
    _, _, host, _, _ = tracing.scope_breakdown(events, LEAF_SPANS)
    idle = tracing.idle_by_scope(events, LEAF_SPANS, t0, t1)
    return {"leaf_scopes": host, "leaf_idle": [[k, v] for k, v in idle]}


def stages(run) -> dict:
    """The window's records after the traced ones summed by stage (by
    dtype), a solve each: iterations, reruns, warm-up, capture and
    reduced-solve host ms; {} where the solves carry no records."""
    solves = window_records(run) or []
    out = {}
    for recs in solves:
        for r in recs:
            st = out.setdefault(r["dtype"], dict.fromkeys(
                ("iterations", "reruns", "warmup_ms", "capture_ms",
                 "reduced_ms"), 0.0))
            st["iterations"] += r["iterations"]
            st["reruns"] += sum(r["reruns"].values())
            for k in ("warmup_ms", "capture_ms", "reduced_ms"):
                st[k] += r[k]
    return {d: {k: v / len(solves) for k, v in st.items()}
            for d, st in out.items()}


def _logged(solve, records):
    """``solve`` with each call inside a solve log of its own, its
    records appended to ``records``."""
    from diaglib_tpu_torch import profiling

    def run(gen):
        with profiling.solve_log() as log:
            res = solve(gen)
        records.append(log.records)
        return res

    return run


def measure(catalog, name, seed, seconds, trace, device, t_start,
            log=True):
    """One run of cell ``name`` by ``harness.run_cell``, each solve in a
    solve log of its own when ``log``, the trace summary with the leaf
    spans: (result, :class:`~benchmark.harness.Run`), the result's
    ``metrics`` with the six readings where they read something."""
    from benchmark import harness

    read_trace = harness._read_trace

    def with_leaves(events, t_window, solves):
        return dict(read_trace(events, t_window, solves),
                    **leaf_trace(events, t_window))

    records = []
    harness._read_trace = with_leaves
    try:
        result, check, run = harness.run_cell(
            catalog, name, seed, seconds, trace, device, t_start,
            wrap_solve=(lambda s: _logged(s, records)) if log else None)
    finally:
        harness._read_trace = read_trace
    if log:
        # the warm-up solve filed the first
        for solve, recs in zip(run.solves, records[1:]):
            solve.records = recs
        result["records_sum_to_n_iter"] = all(
            sum(r["iterations"] for r in s.records) == s.n_iter
            for s in run.solves)
        result["stages"] = stages(run)
    if trace:
        for metric, unit in READERS.items():
            value = catalog.module("metrics", metric).read(run)
            if value is not None:
                result["metrics"][metric] = {"value": value, "unit": unit}
        result["leaf_idle"] = run.trace["leaf_idle"]
        result["leaf_scopes"] = run.trace["leaf_scopes"]
    result["check"] = {k: c["value"] for k, c in check.items()}
    result["log"] = bool(log)
    return result, run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--log", type=int, choices=(0, 1), default=1)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"

    import torch

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from benchmark import harness

    result, _ = measure(harness.Catalog(), args.workload, args.seed,
                        args.seconds, bool(args.trace), "cuda:0", T_START,
                        bool(args.log))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
