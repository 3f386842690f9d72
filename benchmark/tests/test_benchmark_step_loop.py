"""The step loop's readers (``benchmark/step_loop.py`` and its six metric
files) against hand counts, the five per-layer metrics unmoved by the
program's leaf spans, and the measuring tool on the CPU at a small
size."""

import math
import time

import pytest

from benchmark import harness, step_loop, tracing
from benchmark.harness import Run, Solve

from .test_benchmark_arithmetic import FLAGSHIP, _ev

FIVE = ("iters_per_solve", "ritz_host_ms_per_iter", "ortho_dev_ms_per_iter",
        "matvec_roofline", "device_idle_pct")
SEED = 2 ** 31 + 11


def _load(name):
    return harness.Catalog().module("metrics", name)


def _rec(dtype, iterations, reruns=0, warm=0.0, cap=0.0, red=0.0):
    return {"dtype": dtype, "iterations": iterations,
            "reruns": {"expand": reruns, "restart": 0}, "warmup_ms": warm,
            "capture_ms": cap, "reduced_ms": red}


def _solve(records, n_iter=None):
    s = Solve(1.0, n_iter if n_iter is not None else
              sum(r["iterations"] for r in records), True)
    s.records = records
    return s


def _run(solves, trace=None):
    return Run({}, {}, {"n_max": 15}, FLAGSHIP, 1.0, 10.0, solves, None,
               trace=trace)


def test_leaf_spans_are_the_programs():
    from diaglib_tpu_torch import profiling

    assert step_loop.LEAF_SPANS == profiling.LEAF_SPANS
    assert set(step_loop.CAPTURE_SPANS) < set(step_loop.LEAF_SPANS)
    assert set(step_loop.READERS) == {
        "capture_ms_per_solve", "reruns_per_solve",
        "reduced_host_ms_per_iter", "reduced_dev_ms_per_iter",
        "lo_iters_per_solve", "capture_idle_pct"}


def test_new_readers_hand_counts():
    traced = [_solve([_rec("float32", 35, 9, 99.0, 99.0, 99.0),
                      _rec("float64", 5)])
              for _ in range(harness.TRACE_SOLVES)]
    window = [_solve([_rec("float32", 35, 1, 10.0, 20.0, 70.0),
                      _rec("float64", 5, 0, 4.0, 6.0, 10.0)]),
              _solve([_rec("float32", 35, 0, 12.0, 18.0, 60.0),
                      _rec("float64", 6, 2, 5.0, 5.0, 12.0)])]
    trace = {"solves": traced[:2],
             "leaf_scopes": {"step-warmup": [4, 9.0, 1.0],
                             "graph-capture": [4, 30.0, 0.0],
                             "step-rerun": [1, 2.0, 0.5],
                             "reduced-solve": [80, 160.0, 8.0]},
             "leaf_idle": [["outside", 0.3], ["graph-capture", 0.05],
                           ["step-warmup", 0.1], ["reduced-solve", 0.5],
                           ["step-rerun", 0.05]]}
    run = _run(traced + window, trace)
    assert _load("capture_ms_per_solve").read(run) == pytest.approx(40.0)
    assert _load("reruns_per_solve").read(run) == 1.5
    assert _load("reduced_host_ms_per_iter").read(run) == \
        pytest.approx(152.0 / 81)
    # device ms under reduced-solve over the traced solves' iterations
    assert _load("reduced_dev_ms_per_iter").read(run) == \
        pytest.approx(8.0 / 80)
    assert _load("lo_iters_per_solve").read(run) == 35.0
    assert _load("capture_idle_pct").read(run) == pytest.approx(20.0)
    assert step_loop.stages(run) == {
        "float32": {"iterations": 35.0, "reruns": 0.5, "warmup_ms": 11.0,
                    "capture_ms": 19.0, "reduced_ms": 65.0},
        "float64": {"iterations": 5.5, "reruns": 1.0, "warmup_ms": 4.5,
                    "capture_ms": 5.5, "reduced_ms": 11.0}}
    # an untraced run reads every solve's records
    plain = _run(window)
    assert _load("reruns_per_solve").read(plain) == 1.5
    assert _load("capture_idle_pct").read(plain) is None
    # the float64 solver alone has no float32 stage
    f64 = _run([_solve([_rec("float64", 9)])])
    assert _load("lo_iters_per_solve").read(f64) is None
    assert _load("capture_ms_per_solve").read(f64) == 0.0


def test_new_readers_read_nothing_without_the_programs_records():
    """A run as the harness makes it of a program without the log: no
    records on the solves, no leaf spans in the trace summary."""
    trace = {"busy_s": 0.5, "window_s": 1.0, "solves": [Solve(1.0, 4, True)],
             "scopes": {k: [1, 1.0, 1.0] for k in tracing.SCOPES},
             "by_kernel": {}, "kernels": [], "idle": [["outside", 0.5]]}
    for t in (None, trace):
        run = _run([Solve(1.0, 4, True) for _ in range(5)], t)
        for name in step_loop.READERS:
            assert _load(name).read(run) is None, name
        assert step_loop.stages(run) == {}
    # a traced run whose window held only the traced solves
    run = _run([_solve([_rec("float64", 4)])], trace)
    assert _load("reruns_per_solve").read(run) is None


def _events(leaves: bool):
    """A fixed trace: a window of 1000 us, the three scopes, kernels
    launched under each and one outside, idle gaps; with ``leaves`` the
    program's leaf spans nested inside the scopes (a warm-up and a capture
    inside expand-ortho, the reduced solve inside rayleigh-ritz) and one
    capture outside every scope (the restart step's)."""
    ev = [
        _ev("user_annotation", "benchmark-window", 0, 1000),
        _ev("user_annotation", "matvec", 10, 90),
        _ev("user_annotation", "rayleigh-ritz", 100, 300),
        _ev("user_annotation", "expand-ortho", 420, 400),
        _ev("cuda_runtime", "cudaGraphLaunch", 20, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 5, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 450, 5, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 880, 5, corr=4),
        _ev("kernel", "void ns::sym_spmm_kernel<8>(int)", 30, 60, corr=1),
        _ev("kernel", "slice_rows_kernel", 20, 5, corr=1),
        _ev("kernel", "syevbj_batch_32x16", 160, 100, corr=2),
        _ev("kernel", "wide_mm_kernel", 460, 40, corr=3),
        _ev("gpu_memcpy", "Memcpy DtoH", 560, 10),
        _ev("kernel", "late", 890, 50, corr=4),
    ]
    if leaves:
        ev += [
            _ev("user_annotation", "reduced-solve", 110, 200),
            _ev("user_annotation", "step-warmup", 430, 120),
            _ev("user_annotation", "graph-capture", 600, 200),
            _ev("user_annotation", "graph-capture", 850, 30),
        ]
    return ev


def _summary(events):
    window = tracing.window_us(events, "benchmark-window")
    solves = [Solve(1.0, 4, True), Solve(1.0, 6, True)]
    return harness._read_trace(events, window, solves), window


def test_leaf_spans_leave_the_five_metrics_as_they_were():
    catalog = harness.Catalog()
    reads = []
    for leaves in (False, True):
        summary, _ = _summary(_events(leaves))
        run = _run([Solve(1.0, 5, True)], summary)
        run.operator = catalog.module("operators", "sym_sliced")
        reads.append({n: _load(n).read(run) for n in FIVE})
        reads.append({"kernels": summary["kernels"], "idle": summary["idle"],
                      "scopes": summary["scopes"]})
    assert reads[0] == reads[2] and reads[1] == reads[3]
    assert all(v is not None for v in reads[0].values())


def test_capture_idle_counts_under_expand_ortho_too():
    events = _events(True)
    summary, window = _summary(events)
    leaf = step_loop.leaf_trace(events, window)
    idle = dict(leaf["leaf_idle"])
    by_scope = dict(summary["idle"])
    # the device idles over [500, 560) and [570, 820) inside expand-ortho
    # (and [420, 460)); of it [600, 800) under the capture inside it, and
    # [430, 460) and [500, 550) under the warm-up; the restart's capture
    # [850, 880) is outside every scope, and the device idles all through
    assert idle["graph-capture"] == pytest.approx(230e-6)
    assert idle["step-warmup"] == pytest.approx(80e-6)
    assert idle["reduced-solve"] == pytest.approx(100e-6)
    assert by_scope["expand-ortho"] == pytest.approx(350e-6)
    assert by_scope["outside"] == pytest.approx(160e-6)
    total = sum(idle.values())
    assert total == pytest.approx(735e-6)
    assert math.isclose(total, sum(by_scope.values()))
    run = _run([Solve(1.0, 5, True)], dict(summary, **leaf))
    assert _load("capture_idle_pct").read(run) == pytest.approx(
        100 * 310 / 735)
    # device ms under the reduced solve: the Jacobi kernel launched in it
    assert leaf["leaf_scopes"]["reduced-solve"] == \
        pytest.approx([1, 0.2, 0.1])
    assert _load("reduced_dev_ms_per_iter").read(run) == \
        pytest.approx(0.1 / 10)


@pytest.mark.parametrize("name, seconds", [("sym-davidson", 14.0),
                                           ("sym-davidson-f64", 6.0)])
def test_measure_on_the_cpu(small, name, seconds):
    # the window holds the traced solves and the trace's export: on the
    # CPU the profiler records every operation
    result, run = step_loop.measure(small, name, SEED, seconds, True, "cpu",
                                    time.perf_counter())
    assert result["correct"] and result["records_sum_to_n_iter"]
    assert len(run.solves) > harness.TRACE_SOLVES
    m = result["metrics"]
    dtypes = {r["dtype"] for s in run.solves for r in s.records}
    assert dtypes == ({"float32", "float64"} if name == "sym-davidson"
                      else {"float64"})
    # no capture on the CPU; the reduced solve runs every iteration
    assert m["capture_ms_per_solve"]["value"] == 0.0
    assert m["reduced_host_ms_per_iter"]["value"] > 0
    assert ("lo_iters_per_solve" in m) == (name == "sym-davidson")
    # the profiler saw no device on the CPU
    assert "reduced_dev_ms_per_iter" not in m
    # the harness's own reading is left as it was
    assert harness._read_trace.__name__ == "_read_trace"
