"""The port's spans and its per-solve record (``profiling.solve_log``), on
the CPU: a float64 ``davidson`` on symm_matrix(400) (4 roots, n_max 6,
max_dav 10, tol 1e-10: the restart path) and a ``davidson_ladder`` on the
symmetric store of random_bsr_spd(1024, 64, 4) (6 roots, n_max 8).

CPU tensors take the "eager" route (no capture, so no ``step-warmup`` or
``graph-capture`` span); the "unrolled" route at one pass a loop forces
rare-branch reruns.  Spans are placed on the trace by the offset the
trace notes, within 1 ms.
"""

import collections
import glob
import json

import numpy as np
import pytest
import torch

from diaglib_tpu_torch import (
    SolverOptions,
    davidson,
    davidson_ladder,
    profiling,
)
from diaglib_tpu_torch.ops import bsr_sliced_sym as sym
from diaglib_tpu_torch.ops.bsr import random_bsr_spd
from diaglib_tpu_torch.problems import dense_matvec, diag_precnd, symm_matrix
from diaglib_tpu_torch.utils import graphs

N = 400
RESTART = dict(n_targ=4, n_max=6, max_iter=150, tol=1e-10, max_dav=10)
LADDER = dict(n_targ=6, n_max=8, max_iter=150, tol=1e-10, max_dav=10)
SCOPES = ("matvec", "rayleigh-ritz", "expand-ortho")
ONE_PASS = {"vs": 1, "cd": 1, "shift": 0}
# the fields every record of the private route switch had before the log
OLD_FIELDS = {"solver", "route", "dtype", "iterations", "flag_reads",
              "reruns", "passes", "capture_s", "pool_bytes", "replays",
              "flag_history"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def solve():
    a = symm_matrix(N, device="cpu")
    guess = torch.from_numpy(
        np.random.default_rng(2).uniform(-0.5, 0.5, (6, N)))

    def run():
        return davidson(dense_matvec(a), diag_precnd(torch.diagonal(a)),
                        guess, SolverOptions(**RESTART))

    return run


@pytest.fixture(scope="module")
def ladder():
    st = sym.slice_bsr_sym(random_bsr_spd(1024, 64, 4, seed=0, device="cpu"))
    f32 = torch.float32
    z = torch.zeros((8, 1024), dtype=torch.float64)

    def run():
        return davidson_ladder(
            sym.sym_sliced_matvec(st, dtype=f32),
            diag_precnd(st.diagonal.float()), sym.sym_sliced_matvec(st),
            diag_precnd(st.diagonal), z, SolverOptions(**LADDER),
            lo_tol=2e-6, lo_iter=35,
            generator=torch.Generator().manual_seed(1))

    return run


def _names(spans):
    return collections.Counter(s.name for s in spans)


def _traced(tmp_path, run, log=True):
    """``run()`` under profiling.trace (inside a solve log when ``log``):
    (result, the log or None, the trace's user annotations)."""
    with profiling.solve_log() if log else profiling._NULL as lg:
        with profiling.trace(str(tmp_path)):
            res = run()
    path, = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return res, lg, [e for e in events if e.get("cat") == "user_annotation"]


def test_one_record_a_solve(solve):
    with profiling.solve_log() as log:
        res = solve()
    rec, = log.records
    assert (rec["solver"], rec["route"], rec["dtype"]) == \
        ("davidson", "eager", "float64")
    assert rec["iterations"] == res.n_iter and res.ok
    assert rec["flag_reads"] == res.n_iter
    assert rec["reruns"] == {"expand": 0, "restart": 0}
    # no capture on the CPU
    assert (rec["warmups"], rec["captures"], rec["replays"]) == (0, 0, {})
    assert rec["warmup_ms"] == rec["capture_ms"] == 0.0
    assert "flag_history" not in rec


def test_one_record_a_ladder_stage(ladder):
    with profiling.solve_log() as log:
        res = ladder()
    assert [(r["solver"], r["dtype"]) for r in log.records] == \
        [("davidson", "float32"), ("davidson", "float64")]
    assert sum(r["iterations"] for r in log.records) == res.n_iter
    assert len({r["solve"] for r in log.records}) == 2


@pytest.mark.parametrize("which", ["davidson", "davidson_ladder"])
def test_reduced_solves_span_the_iterations(solve, ladder, which):
    with profiling.solve_log() as log:
        (solve if which == "davidson" else ladder)()
    for rec in log.records:
        mine = [s for s in log.spans if s.solve == rec["solve"]
                and s.name == "reduced-solve"]
        assert rec["reduced"] == len(mine) >= rec["iterations"]
        ms = sum(s.end_ns - s.start_ns for s in mine) / 1e6
        assert rec["reduced_ms"] == pytest.approx(ms, rel=1e-12)
        assert rec["reduced_ms"] > 0


@pytest.mark.parametrize("route", ["eager", "unrolled one pass"])
def test_spans_nest_in_their_parents(solve, route):
    """Every span's parent is a logged span of the same solve that holds
    it; a leaf span holds no other span; the reduced solve sits inside
    rayleigh-ritz and a rerun inside its step's scope, if it has one."""
    args = ("eager",) if route == "eager" else ("unrolled", ONE_PASS)
    with graphs._recording(*args) as rec, profiling.solve_log() as log:
        solve()
    ids = {r["solve"] for r in log.records}
    assert ids == {r["solve"] for r in rec.solves}
    by_id = {s.id: s for s in log.spans}
    assert len(by_id) == len(log.spans)
    for s in log.spans:
        assert s.solve in ids and s.start_ns <= s.end_ns
        if s.parent is None:
            assert s.name in SCOPES or s.name == "step-rerun"
            continue
        p = by_id[s.parent]
        assert p.solve == s.solve
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert p.name not in profiling.LEAF_SPANS
        if s.name == "reduced-solve":
            assert p.name == "rayleigh-ritz"
        if s.name == "step-rerun":
            assert p.name == "expand-ortho"


def test_nothing_kept_without_a_log_or_a_profiler(solve, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert profiling._span("matvec") is profiling._NULL
    made = []
    real = profiling._begin_solve
    monkeypatch.setattr(profiling, "_begin_solve",
                        lambda *a: made.append(real(*a)) or made[-1])
    res = solve()
    assert res.ok and made == [None]
    assert profiling._LOGS == profiling._OPEN == profiling._SOLVES == []


def test_trace_holds_the_logs_leaf_spans(ladder, tmp_path):
    """The trace names the same leaf spans as the log, as often (reruns
    forced at one pass a loop).  Placed by the noted offset, each logged
    span lies within the trace's, give or take 1 ms: the log reads its
    clock inside the record_function's bounds, so a pause of the process
    between the two reads (the collector, the scheduler) can lengthen the
    trace's span but never the log's.  Most spans start and end within
    1 ms of the trace's."""
    def run():
        with graphs._recording("unrolled", ONE_PASS):
            return ladder()

    res, log, notes = _traced(tmp_path, run)
    assert res.ok and log.offset_us is not None
    assert _names(log.spans)["step-rerun"] > 0
    for name in profiling.LEAF_SPANS + SCOPES:
        traced = sorted((e["ts"], e["ts"] + e["dur"]) for e in notes
                        if e["name"] == name)
        logged = sorted(log.on_trace(s) for s in log.spans if s.name == name)
        assert len(traced) == len(logged), name
        for (a, b), (c, d) in zip(traced, logged):
            assert a - 1000 < c and d < b + 1000, name
        if traced:
            assert np.median([abs(a - c) for (a, _), (c, _) in
                              zip(traced, logged)]) < 1000, name
            assert np.median([abs(b - d) for (_, b), (_, d) in
                              zip(traced, logged)]) < 1000, name
    assert _names(log.spans)["reduced-solve"] >= res.n_iter


def test_old_scopes_keep_their_counts(solve, tmp_path):
    """The three phase scopes land in the trace as often with the log open
    as without it: one matvec and one rayleigh-ritz an iteration, one
    expand-ortho an expansion."""
    counts = []
    for i, log in enumerate((False, True)):
        (tmp_path / str(i)).mkdir()
        res, _, notes = _traced(tmp_path / str(i), solve, log)
        c = collections.Counter(e["name"] for e in notes)
        counts.append({k: c[k] for k in SCOPES})
    assert counts[0] == counts[1]
    assert counts[0]["matvec"] == counts[0]["rayleigh-ritz"] == res.n_iter
    assert 0 < counts[0]["expand-ortho"] < res.n_iter


def test_recording_solves_keep_their_fields(solve):
    with graphs._recording("eager") as rec:
        res = solve()
    s, = rec.solves
    assert OLD_FIELDS <= set(s)
    assert s["iterations"] == res.n_iter
    assert len(s["flag_history"]) == s["flag_reads"] == res.n_iter
    assert s["route"] == "eager" and s["dtype"] == "float64"
    # the private switch's log is closed with it
    assert profiling._LOGS == []


def test_forced_rerun_counts_one_span_and_one_rerun(solve):
    """At one pass a loop on the "unrolled" route the expansions' loops
    fall short and are run again: each rerun is one step-rerun span and
    one rerun in the record, and one more reduced solve."""
    with graphs._recording("unrolled", ONE_PASS) as rec, \
            profiling.solve_log() as log:
        res = solve()
    r, = log.records
    reruns = sum(r["reruns"].values())
    spans = _names(log.spans)
    assert reruns > 0 and r["reruns"]["expand"] == reruns
    assert spans["step-rerun"] == reruns
    assert r["flag_reads"] == res.n_iter + reruns
    assert r["reduced"] == spans["reduced-solve"] == res.n_iter + reruns
    assert rec.solves[0]["reruns"] == r["reruns"]


def test_logs_nest_and_keep_the_newest_spans(solve, monkeypatch):
    with profiling.solve_log() as full:
        solve()
    monkeypatch.setattr(profiling, "SPAN_CAP", 10)
    with profiling.solve_log() as outer:
        with profiling.solve_log() as inner:
            solve()
    assert outer.records == inner.records and len(outer.records) == 1
    assert len(inner.spans) == 10 < len(full.spans)
    assert [s.id for s in inner.spans] == [s.id for s in outer.spans]
    # the last ten to close, as in the uncapped log of the same solve
    newest = [(s.name, s.parent is None) for s in list(full.spans)[-10:]]
    assert [(s.name, s.parent is None) for s in inner.spans] == newest
    with pytest.raises(ValueError):
        inner.on_trace(inner.spans[0])
