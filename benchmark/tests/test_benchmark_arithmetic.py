"""The metrics' arithmetic against hand counts."""

import math

import numpy as np
import pytest

from benchmark import harness, stats, tracing, work
from benchmark.harness import Run, Solve

FLAGSHIP = {"a": {"n": 32768, "block": 512, "stored_blocks": 4096,
                  "distinct_blocks": 2080}}


def _load(name):
    return harness.Catalog().module("metrics", name)


def test_percentile_hand_counts():
    assert stats.percentile(range(1, 11), 90) == pytest.approx(9.1)
    assert stats.percentile([0.5], 90) == 0.5
    assert stats.percentile([3.0, 1.0], 50) == 2.0
    rng = np.random.default_rng(0)
    for size in (2, 7, 31, 70):
        xs = rng.random(size).tolist()
        assert stats.percentile(xs, 90) == pytest.approx(
            float(np.percentile(xs, 90)), rel=1e-12)


def test_rate_and_spread():
    assert stats.rate(10.0, 4) == 2.5
    with pytest.raises(ValueError):
        stats.rate(10.0, 0)
    # quartiles of 1..5 (exclusive method): 1.5 and 4.5; median 3
    assert stats.spread([1, 2, 3, 4, 5]) == pytest.approx(1.0)


def _run(walls, window_s=None, trace=None):
    solves = [Solve(w, 60, True) for w in walls]
    return Run({}, {}, {"n_max": 15}, FLAGSHIP, 12.5,
               window_s if window_s is not None else sum(walls), solves,
               3 * 2 ** 30, trace=trace)


def test_end_to_end_readers():
    run = _run([0.5, 0.4, 0.6, 0.5], window_s=2.2)
    assert _load("solve_s").read(run) == pytest.approx(0.55)
    assert _load("solve_p90_s").read(run) == pytest.approx(
        0.5 + 0.7 * 0.1)
    assert _load("peak_mem_GiB").read(run) == 3.0
    assert _load("setup_s").read(run) == 12.5


def test_application_work_of_the_flagship():
    op = FLAGSHIP["a"]
    x_y = 2 * 15 * 32768 * 4
    assert work.application_bytes(op, 15) == 2080 * 512 ** 2 * 4 + x_y
    assert work.application_flops(op, 15) == 2 * 32768 ** 2 * 15
    least = work.least_application_s(FLAGSHIP, 15)
    assert least == pytest.approx((2080 * 512 ** 2 * 4 + x_y) / 3.35e12)
    assert work.application_flops(op, 15) / 67e12 < least    # bytes bound
    # two operators, applied in turn: the second, with half the distinct
    # blocks, is bound by its operations
    two = {k: dict(op, distinct_blocks=d) for k, d in (("p", 2080),
                                                        ("q", 1040))}
    assert work.least_application_s(two, 15) == pytest.approx(
        (least + 2 * 32768 ** 2 * 15 / 67e12) / 2)


def test_trace_readers():
    catalog = harness.Catalog()
    least = work.least_application_s(FLAGSHIP, 15)
    trace = {"busy_s": 0.6, "window_s": 1.0,
             "scopes": {"matvec": [10, 12.0, 10.0],
                        "rayleigh-ritz": [10, 40.0, 2.0],
                        "expand-ortho": [9, 5.0, 4.0]},
             "by_kernel": {"slice_rows_kernel": (10, 0.1),
                           "sym_spmm_kernel": (20, 15.9),
                           "wide_mm_kernel": (40, 3.0)},
             "solves": [Solve(1.0, 4, True), Solve(1.0, 6, True)]}
    run = _run([0.5], trace=trace)
    roof = _load("matvec_roofline")
    # the sliced route: K2's launches and K2 + K1 time, wherever launched
    run.operator = catalog.module("operators", "sym_sliced")
    assert roof.read(run) == pytest.approx(100 * 10 * least / 16e-3)
    assert _load("device_idle_pct").read(run) == pytest.approx(40.0)
    assert _load("iters_per_solve").read(run) == 5.0
    assert _load("ritz_host_ms_per_iter").read(run) == 4.0
    assert _load("ortho_dev_ms_per_iter").read(run) == 0.4
    # a run without a trace, or a trace with no device time, reads nothing
    for name in ("matvec_roofline", "device_idle_pct",
                 "ortho_dev_ms_per_iter", "iters_per_solve"):
        assert _load(name).read(_run([0.5])) is None
    dry = dict(trace, busy_s=0.0, by_kernel={},
               scopes={k: [c, h, 0.0] for k, (c, h, _) in
                       trace["scopes"].items()})
    dry_run = _run([0.5], trace=dry)
    dry_run.operator = catalog.module("operators", "sym_sliced")
    for name in ("matvec_roofline", "device_idle_pct",
                 "ortho_dev_ms_per_iter"):
        assert _load(name).read(dry_run) is None


def _ev(cat, name, ts, dur, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_arithmetic_hand_counts():
    events = [
        _ev("user_annotation", "benchmark-window", 0, 1000),
        _ev("user_annotation", "matvec", 10, 90),
        _ev("user_annotation", "rayleigh-ritz", 100, 500),
        _ev("cuda_runtime", "cudaGraphLaunch", 20, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 150, 5, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 800, 5, corr=3),
        _ev("kernel", "void ns::sym_spmm_kernel<8>(int)", 30, 100, corr=1),
        _ev("kernel", "wide_mm_kernel", 100, 50, corr=1),
        _ev("kernel", "eigh", 160, 40, corr=2),
        _ev("gpu_memcpy", "Memcpy DtoH", 900, 20),
        _ev("kernel", "late", 990, 30, corr=3),
    ]
    busy, n_kernels, host, outside, top = tracing.scope_breakdown(
        events, tracing.SCOPES)
    assert n_kernels == 4
    assert host["matvec"] == pytest.approx([1, 0.09, 0.15])
    assert host["rayleigh-ritz"] == pytest.approx([1, 0.5, 0.04])
    assert outside == pytest.approx(0.03)
    assert top[0] == ("sym_spmm_kernel", 1, 0.1)
    t0, t1 = tracing.window_us(events, "benchmark-window")
    # [30, 150) + [160, 200) + [900, 920) + [990, 1000)
    assert tracing.busy_s(events, t0, t1) == pytest.approx(190e-6)
    idle = dict(tracing.idle_by_scope(events, tracing.SCOPES, t0, t1))
    # gaps: [0, 30), of it [10, 30) under matvec; [150, 160) and
    # [200, 600) under rayleigh-ritz; [600, 900) and [920, 990) outside
    assert idle["matvec"] == pytest.approx(20e-6)
    assert idle["rayleigh-ritz"] == pytest.approx(410e-6)
    assert idle["outside"] == pytest.approx(380e-6)
    assert math.isclose(sum(idle.values()) + 190e-6, 1000e-6)
