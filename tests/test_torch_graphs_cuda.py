"""The captured routes on the card (davidson, lobpcg, caslr, caslr_eff,
nonsym, and a sharded davidson over a one-rank NCCL group):
each iteration's steps replayed as CUDA graphs, against the same steps
called directly, the captured solves' records (profiling.solve_log: one
warm-up and one capture a step key) and the float64 BSR sums called
twice.

These tests need an NVIDIA GPU with nvcc and skip elsewhere.  They import
no JAX:

    python -m pytest --noconftest tests/test_torch_graphs_cuda.py -q

The flagship ladder (random_bsr_spd(65536, 512, 8), its symmetric store,
10 roots, n_max 15, tol 1e-10, max_dav 10, lo_iter 35) captured and
uncaptured in one process gives the same bits in every returned tensor and
the same counts: both routes run the same arithmetic (an unrolled ortho
pass past its loop's end is masked out, and launches K3 all the same).
A second captured ladder on the same callables runs on the state and
graphs the first kept (``utils.graphs.StepCache``): no warm-up, no
capture, the first one's bits; over 20 back-to-back ladders on the same
callables the reserved device memory stays within 1 % of the second's,
over the symmetric store and over the plain-BSR route (K4, then the
float64 segment product, at n = 8192).
On the upstream test matrix (symm_matrix(8192), dense) the ladder's
float32 stage ends by its stall bit at the same iteration on the captured,
unrolled and eager routes; a bound-method operator whose matrix is
rebound between two solves is captured anew each solve, and the second
solve finds the new matrix's eigenvalues.
The same holds for the flagship's lobpcg_ladder (lo_iter 70), and for
caslr_eff_ladder and caslr_ladder algorithm 0 on bsr_casida_tdscf(65536,
512, 4) (lo_iter 60, a zero (15, 131072) paired guess), and for the
two-sided nonsym_ladder on bsr_nonsym_similarity(65536, 512, 8) (side
"c", n_max 10, lo_iter 60), whose matvecs launch K2, K1 and K5 as often
on both routes.  The flagship's davidson_ladder with sharding= over
dist_sliced_matvec of its general store, under a one-rank NCCL group
(each step's all-reduces captured with it), gives the same bits captured
and uncaptured, and the unsharded ladder's counts.  Two calls of the
float64 plain-BSR and distributed-BSR segment products at n = 65536 give
the same bits.  A step that reads the device cannot be captured, and the
solve raises instead of running uncaptured, sharded or not (last: a
failed capture leaves the process as it was, but is run after the rest).
"""

import dataclasses
import importlib

import pytest
import torch
import torch.distributed as dist

from diaglib_tpu_torch import (
    SolverOptions,
    caslr_eff_ladder,
    caslr_ladder,
    davidson,
    davidson_ladder,
    lobpcg,
    lobpcg_ladder,
    nonsym,
    nonsym_ladder,
)
from diaglib_tpu_torch.ops import bsr_sliced as bs
from diaglib_tpu_torch.ops import bsr_sliced_sym as sym
from diaglib_tpu_torch.ops import dist_sliced as dsl
from diaglib_tpu_torch.ops.bsr import (
    BSRMatrix,
    bsr_diagonal,
    bsr_matvec,
    random_bsr_spd,
)
from diaglib_tpu_torch.ops.bsr import row_slots
from diaglib_tpu_torch.ops.dist_bsr import _segment_spmm
from diaglib_tpu_torch.problems import (
    bsr_casida_tdscf,
    bsr_nonsym_similarity,
    casida_tdscf_ops,
    diag_precnd,
    nonsym_similarity_ops,
    symm_matrix,
)
from diaglib_tpu_torch.parallel import multihost
from diaglib_tpu_torch.utils import graphs
from diaglib_tpu_torch.utils.graphs import GraphCaptureError

pytestmark = pytest.mark.cuda

dmod = importlib.import_module("diaglib_tpu_torch.solvers.davidson")
N, B, BPR = 65536, 512, 8
FIELDS = ("eig", "evec", "done", "rms_history", "max_history",
          "eig_history")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def flagship(dev):
    m = random_bsr_spd(N, B, BPR, seed=0, dtype=torch.float32, device=dev)
    return m, sym.slice_bsr_sym(m)


OPTS = dict(n_targ=10, n_max=15, max_iter=150, tol=1e-10, max_dav=10)


def _seeded():
    return torch.Generator(device="cuda").manual_seed(1)


def _symmetric_ladder(ladder, store, lo_iter):
    """``run(generator)`` of the flagship's ``ladder`` on its store."""
    f32 = torch.float32
    guess = torch.zeros((15, N), dtype=torch.float64, device="cuda")
    return lambda gen: ladder(
        sym.sym_sliced_matvec(store, dtype=f32),
        diag_precnd(store.diagonal.to(f32)), sym.sym_sliced_matvec(store),
        diag_precnd(store.diagonal), guess, SolverOptions(**OPTS),
        lo_tol=2e-6, lo_iter=lo_iter, generator=gen)


def _captured_equals_uncaptured(run, solver):
    """The ladder ``run`` on the captured route against the uncaptured
    one: every returned tensor bit for bit, the same counts, the same K2
    and K1 launches; returns the captured solves' records."""
    eager, e_solves, e_launches = graphs._on_route(
        lambda: run(_seeded()), "eager")
    captured, c_solves, c_launches = graphs._on_route(
        lambda: run(_seeded()), None)
    assert [(s["solver"], s["route"]) for s in c_solves] == \
        [(solver, "graphs")] * 2
    assert [s["route"] for s in e_solves] == ["eager", "eager"]
    assert captured.ok and eager.ok
    assert (captured.n_iter, captured.n_matvec, captured.ortho_ok) == \
        (eager.n_iter, eager.n_matvec, eager.ortho_ok)
    for f in FIELDS:
        assert torch.equal(getattr(captured, f), getattr(eager, f)), f
    # the replays count what they launch: the matvec steps' K2 and K1 as
    # uncaptured (but for a rare-branch rerun, which runs them again), and
    # more K3, since an unrolled ortho pass launches its products whether
    # or not its loop has stopped
    reruns = sum(sum(s["reruns"].values()) for s in c_solves)
    for k in ("peel_rows", "sym_spmm"):
        assert c_launches[k] >= e_launches[k]
        assert reruns or c_launches[k] == e_launches[k]
    assert c_launches["sym_spmm"] == 2 * c_launches["peel_rows"] > 0
    assert c_launches["sliced_wide_mm"] >= e_launches["sliced_wide_mm"] > 0
    # each step's graph made once a stage and replayed
    for s in c_solves:
        assert s["capture_s"] > 0 and s["pool_bytes"] >= 0
        assert sum(s["replays"].values()) > 0
        assert s["warmups"] == s["captures"] >= len(s["replays"]) > 0
    assert all(s["warmups"] == s["captures"] == 0 for s in e_solves)
    return c_solves


def test_captured_ladder_bit_equal_to_uncaptured(flagship):
    _, store = flagship
    _captured_equals_uncaptured(
        _symmetric_ladder(davidson_ladder, store, 35), "davidson")


def test_captured_lobpcg_ladder_bit_equal_to_uncaptured(flagship):
    _, store = flagship
    _captured_equals_uncaptured(
        _symmetric_ladder(lobpcg_ladder, store, 70), "lobpcg")


def test_captured_solve_records_one_capture_a_step_key(flagship,
                                                        monkeypatch):
    """Each stage of the captured ladder, in profiling.solve_log, files a
    record with one warm-up and one capture a step key, every other call
    of a key a replay; its spans hold one step-warmup and one
    graph-capture a key, neither inside the other, and the stages'
    iterations sum to the ladder's."""
    from diaglib_tpu_torch import profiling

    _, store = flagship
    keys, seen = [], []         # (stage, step key) of every step run
    real = graphs.StepGraphs.run

    def run(self, key, fn):
        if not any(self is g for g in seen):
            seen.append(self)
        keys.append(([g is self for g in seen].index(True), key))
        return real(self, key, fn)

    monkeypatch.setattr(graphs.StepGraphs, "run", run)
    with profiling.solve_log() as log:
        res = _symmetric_ladder(davidson_ladder, store, 35)(
            torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    assert res.ok
    assert [(r["route"], r["dtype"]) for r in log.records] == \
        [("graphs", "float32"), ("graphs", "float64")]
    assert sum(r["iterations"] for r in log.records) == res.n_iter
    assert len(seen) == 2
    for stage, rec in enumerate(log.records):
        mine = [k for h, k in keys if h == stage]
        assert rec["warmups"] == rec["captures"] == len(set(mine))
        assert sum(rec["replays"].values()) == len(mine) - len(set(mine))
        assert rec["warmup_ms"] > 0 and rec["capture_ms"] > 0
        spans = [s for s in log.spans if s.solve == rec["solve"]]
        for name in ("step-warmup", "graph-capture"):
            assert sum(s.name == name for s in spans) == len(set(mine))
        leaf = sorted((s.start_ns, s.end_ns) for s in spans
                      if s.name in profiling.LEAF_SPANS)
        assert all(a[1] <= b[0] for a, b in zip(leaf, leaf[1:]))


def _kept_ladder(mv_lo, pc_lo, mv_hi, pc_hi, n, lo_iter=35):
    """``run(generator)`` of a davidson_ladder over fixed callables, from
    a random start of width ``n``."""
    guess = torch.zeros((15, n), dtype=torch.float64, device="cuda")
    opts = SolverOptions(**OPTS)
    return lambda gen: davidson_ladder(mv_lo, pc_lo, mv_hi, pc_hi, guess,
                                       opts, lo_tol=2e-6, lo_iter=lo_iter,
                                       generator=gen)


def _store_ops(store):
    f32 = torch.float32
    return (sym.sym_sliced_matvec(store, dtype=f32),
            diag_precnd(store.diagonal.to(f32)), sym.sym_sliced_matvec(store),
            diag_precnd(store.diagonal))


def test_kept_ladder_replays_with_no_capture(flagship):
    """The second ladder on the same callables reuses both stages' states
    and graphs: no warm-up, no capture, no pool reserved, only replays;
    every returned tensor bit-equal to the first, freshly captured one
    from the same start."""
    _, store = flagship
    graphs.STEP_CACHE.clear()
    run = _kept_ladder(*_store_ops(store), N)
    first, f_solves, f_launches = graphs._on_route(
        lambda: run(_seeded()), None)
    second, s_solves, s_launches = graphs._on_route(
        lambda: run(_seeded()), None)
    assert [s["reused"] for s in f_solves] == [False, False]
    assert [s["reused"] for s in s_solves] == [True, True]
    assert first.ok and second.ok
    assert (second.n_iter, second.n_matvec, second.ortho_ok) == \
        (first.n_iter, first.n_matvec, first.ortho_ok)
    for f in FIELDS:
        assert torch.equal(getattr(second, f), getattr(first, f)), f
    for f, s in zip(f_solves, s_solves):
        assert f["warmups"] == f["captures"] > 0
        assert (s["warmups"], s["captures"], s["capture_s"],
                s["pool_bytes"]) == (0, 0, 0.0, 0)
        assert s["iterations"] == f["iterations"]
        assert sum(s["replays"].values()) == \
            sum(f["replays"].values()) + f["captures"]
    # a replay counts what its capture launched
    assert s_launches == f_launches


@pytest.mark.parametrize("route", ["sliced", "bsr"])
def test_back_to_back_ladders_hold_reserved_memory(flagship, route):
    """20 ladders on one set of callables: the reserved device memory
    after the 20th lies within 1 % of the 2nd's (the plain-BSR route grew
    0.79 GiB a solve when every solve captured anew)."""
    if route == "sliced":
        n, ops = N, _store_ops(flagship[1])
    else:
        n = 8192
        m64 = random_bsr_spd(n, B, BPR, seed=0, dtype=torch.float64,
                             device="cuda")
        m32 = dataclasses.replace(m64, blocks_t=m64.blocks_t.float())
        d = bsr_diagonal(m64)
        ops = (bsr_matvec(m32), diag_precnd(d.float()), bsr_matvec(m64),
               diag_precnd(d))
    graphs.STEP_CACHE.clear()
    run = _kept_ladder(*ops, n)
    reserved = []
    for i in range(20):
        res = run(torch.Generator(device="cuda").manual_seed(i))
        torch.cuda.synchronize()
        assert res.ok
        reserved.append(torch.cuda.memory_reserved())
    print(f"[reserved] {route} n={n}: after solve 2 {reserved[1]} B, "
          f"after solve 20 {reserved[-1]} B, "
          f"{(reserved[-1] - reserved[1]) / reserved[1]:+.4%}")
    assert abs(reserved[-1] - reserved[1]) <= 0.01 * reserved[1]


@pytest.fixture(scope="module")
def hilbert(dev):
    """The upstream test matrix at n = 8192, dense on the card, and the
    upstream strategy-6 guess: its float32 noise floor lies above the
    ladders' lo_tol 2e-6, so the float32 stage ends by its stall bit."""
    n = 8192
    a = symm_matrix(n, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    guess = 0.01 * torch.rand((15, n), generator=g, dtype=torch.float64,
                              device=dev)
    rows = torch.argsort(torch.diagonal(a), stable=True)[:15]
    guess[torch.arange(15, device=dev), rows] += 1.0
    return a, guess


def test_rebound_operator_is_captured_anew(hilbert):
    """A bound-method operator whose matrix the caller rebinds between two
    solves (its diagonal shifted by 0.5, the old one freed): the methods
    are not marked replayable, so neither solve is kept, and the second
    solves the new matrix, its eigenvalues within 1e-10 of eigvalsh's (a
    replay over the old matrix would be 0.5 off)."""
    a, guess = hilbert
    opts = SolverOptions(n_targ=10, n_max=15, max_iter=100, tol=1e-8,
                         max_dav=20)

    class Op:
        def matvec(self, x):
            return x @ self.h.T

        def precnd(self, fac, x):
            return diag_precnd(torch.diagonal(self.h))(fac, x)

    op = Op()
    graphs.STEP_CACHE.clear()
    for shift in (0.0, 0.5):
        op.h = a.clone()
        op.h.diagonal().add_(shift)
        with graphs._recording(None) as rec:
            res = davidson(op.matvec, op.precnd, guess, opts)
        torch.cuda.synchronize()
        assert [(s["route"], s["reused"]) for s in rec.solves] == \
            [("graphs", False)]
        assert res.ok
        want = torch.linalg.eigvalsh(op.h)[:10]
        err = (res.eig[:10] - want).abs().max().item()
        print(f"[rebound] shift {shift}: max eigenvalue error {err:.3e}")
        assert err <= 1e-10
    assert len(graphs.STEP_CACHE) == 0


def test_stall_on_every_route_at_the_same_iteration(hilbert):
    """The captured route, the same steps uncaptured with the captured
    route's fixed passes ("unrolled") and the eager loops end the float32
    stage by its stall bit at the same iteration, with the same bits in
    every returned tensor; the captured and unrolled routes read the same
    flags, and the eager route the same but for a rerun's extra read
    (finished bit 0)."""
    a, guess = hilbert
    a32 = a.float()
    opts = SolverOptions(n_targ=10, n_max=15, max_iter=100, tol=1e-8,
                         max_dav=20)

    def run(gen):
        return davidson_ladder(
            lambda x: x @ a32, diag_precnd(torch.diagonal(a32)),
            lambda x: x @ a, diag_precnd(torch.diagonal(a)), guess, opts,
            lo_tol=2e-6, lo_iter=35, generator=gen)

    out = {route: graphs._on_route(lambda: run(_seeded()), route)[:2]
           for route in (None, "unrolled", "eager")}
    captured, c_solves = out[None]
    assert [s["route"] for s in c_solves] == ["graphs", "graphs"]
    assert [s["end"] for s in c_solves] == ["stall", "tol"]
    assert c_solves[0]["iterations"] < 35 and captured.ok
    for route in ("unrolled", "eager"):
        res, solves = out[route]
        for f in FIELDS:
            assert torch.equal(getattr(res, f), getattr(captured, f)), \
                (route, f)
        assert [(s["iterations"], s["end"]) for s in solves] == \
            [(s["iterations"], s["end"]) for s in c_solves], route
    for c, u, e in zip(c_solves, out["unrolled"][1], out["eager"][1]):
        assert c["flag_history"] == u["flag_history"]
        assert [f for f in c["flag_history"] if f[2]] == e["flag_history"]
    assert c_solves[0]["flag_history"][-1][4] == 1


@pytest.fixture(scope="module")
def casida(dev):
    _, _, _, (apb, amb) = bsr_casida_tdscf(N, B, 4, seed=0, device=dev)
    return apb, amb


@pytest.mark.parametrize("prec", ["eff", "std"])
def test_captured_casida_ladders_bit_equal_to_uncaptured(casida, prec):
    ops = casida_tdscf_ops(*casida, prec=prec)
    guess = torch.zeros((15, 2 * N), dtype=torch.float64, device="cuda")
    opts = SolverOptions(**OPTS)
    if prec == "eff":
        _captured_equals_uncaptured(lambda gen: caslr_eff_ladder(
            *ops, guess, opts, lo_tol=2e-6, lo_iter=60, generator=gen),
            "caslr_eff")
    else:
        _captured_equals_uncaptured(lambda gen: caslr_ladder(
            *ops, guess, opts, algorithm=0, lo_tol=2e-6, lo_iter=60,
            generator=gen), "caslr")


NS_FIELDS = ("eig", "evec_r", "evec_l", "done", "rms_history_r",
             "max_history_r", "rms_history_l", "max_history_l",
             "eig_history")


def test_captured_nonsym_ladder_bit_equal_to_uncaptured(dev):
    stores, diag = bsr_nonsym_similarity(N, B, BPR, seed=0, device=dev)
    f32 = torch.float32
    guess = torch.zeros((10, N), dtype=torch.float64, device=dev)
    opts = SolverOptions(n_targ=10, n_max=10, max_iter=150, tol=1e-10,
                         max_dav=10)

    def run(gen):
        return nonsym_ladder(
            *nonsym_similarity_ops(stores, dtype=f32),
            diag_precnd(diag.to(f32)), *nonsym_similarity_ops(stores),
            diag_precnd(diag), guess, opts, side="c", lo_tol=2e-6,
            lo_iter=60, generator=gen)

    eager, e_solves, e_launches = graphs._on_route(
        lambda: run(_seeded()), "eager")
    captured, c_solves, c_launches = graphs._on_route(
        lambda: run(_seeded()), None)
    # the float32 stage's right pass, the float64 stage's two passes
    assert [(s["solver"], s["route"]) for s in c_solves] == \
        [("nonsym", "graphs")] * 3
    assert [s["route"] for s in e_solves] == ["eager"] * 3
    assert captured.ok and eager.ok
    assert (captured.n_iter, captured.n_matvec, captured.ortho_ok) == \
        (eager.n_iter, eager.n_matvec, eager.ortho_ok)
    for f in NS_FIELDS:
        assert torch.equal(getattr(captured, f), getattr(eager, f)), f
    reruns = sum(sum(s["reruns"].values()) for s in c_solves)
    for k in ("peel_rows", "sym_spmm", "sliced_spmm"):
        assert c_launches[k] > 0
        assert reruns or c_launches[k] == e_launches[k]
    assert c_launches["sliced_wide_mm"] >= e_launches["sliced_wide_mm"] > 0
    for s in c_solves:
        assert s["capture_s"] > 0 and sum(s["replays"].values()) > 0


@pytest.fixture
def nccl_rank(dev):
    """A one-rank NCCL group in this process, torn down after the test."""
    multihost.initialize(f"tcp://127.0.0.1:{multihost.free_port()}", 1, 0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_sharded_ladder_captured_bit_equal_to_uncaptured(flagship,
                                                         nccl_rank):
    """The flagship's sharded davidson_ladder over dist_sliced_matvec (K2
    and K6 in the matvec step, its all-reduces inside the captured
    steps) on a one-rank NCCL group: the captured route by default, the
    same bits and counts as the uncaptured route, the same K2 / K6
    launches, and the unsharded ladder's counts (64 iterations, 954
    matvecs, PERF.md)."""
    m, _ = flagship
    general = bs.slice_bsr(m)
    sh = multihost.global_sharding(N)
    one = dsl.distribute_sliced_bsr(general, 1, rank=sh.rank)
    f32 = torch.float32
    guess = torch.zeros((15, N), dtype=torch.float64, device="cuda")

    def run(gen):
        return davidson_ladder(
            dsl.dist_sliced_matvec(one, sh, dtype=f32),
            diag_precnd(one.diagonal.to(f32)), dsl.dist_sliced_matvec(one, sh),
            diag_precnd(one.diagonal), guess, SolverOptions(**OPTS),
            lo_tol=2e-6, lo_iter=35, generator=gen, sharding=sh)

    eager, e_solves, e_launches = graphs._on_route(
        lambda: run(_seeded()), "eager")
    captured, c_solves, c_launches = graphs._on_route(
        lambda: run(_seeded()), None)
    assert [(s["solver"], s["route"]) for s in c_solves] == \
        [("davidson", "graphs")] * 2
    assert captured.ok and eager.ok
    assert (captured.n_iter, captured.n_matvec, captured.ortho_ok) == \
        (eager.n_iter, eager.n_matvec, eager.ortho_ok)
    assert (captured.n_iter, captured.n_matvec) == (64, 954)
    for f in FIELDS:
        assert torch.equal(getattr(captured, f), getattr(eager, f)), f
    reruns = sum(sum(s["reruns"].values()) for s in c_solves)
    for k in ("peel_rows", "group_spmm"):
        assert c_launches[k] > 0
        assert reruns or c_launches[k] == e_launches[k]
    assert c_launches["sym_spmm"] == c_launches["sliced_spmm"] == 0
    for s in c_solves:
        assert s["capture_s"] > 0 and sum(s["replays"].values()) > 0


def test_float64_bsr_sums_bit_equal(flagship, dev):
    m, _ = flagship
    m64 = BSRMatrix(m.blocks_t.double(), m.rows, m.cols, m.row_start, m.n,
                    m.block)
    x = torch.randn((15, N), dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    mv = bsr_matvec(m64)
    y1, y2 = mv(x), mv(x)
    assert torch.equal(y1, y2)
    nbr = N // B
    xb = x.reshape(15, nbr, B).transpose(0, 1)
    slots = row_slots(m.rows, nbr)
    outs = []
    for _ in range(2):
        y = torch.zeros((nbr, 15, B), dtype=torch.float64, device=dev)
        outs.append(_segment_spmm(xb, m.cols, m.blocks_t, y, slots))
    assert torch.equal(outs[0], outs[1])
    y = outs[0].transpose(0, 1).reshape(15, N)
    assert float((y - y1).abs().max()) <= 1e-14 * float(y1.abs().max())


def test_capture_failure_raises(dev):
    a = symm_matrix(256, device=dev)

    def reading_matvec(x):
        if float(x.abs().sum()) < 0:        # a read of the device
            raise AssertionError
        return x @ a.T

    opts = SolverOptions(n_targ=2, n_max=4, max_iter=100, tol=1e-8)
    guess = torch.rand((4, 256), dtype=torch.float64, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(2))
    with pytest.raises(GraphCaptureError):
        davidson(reading_matvec, diag_precnd(torch.diagonal(a)), guess, opts)
    torch.cuda.synchronize()
    # the same solve runs uncaptured only when asked for privately
    with dmod._recording("eager"):
        res = davidson(reading_matvec, diag_precnd(torch.diagonal(a)),
                       guess, opts)
    assert res.ok


def test_lobpcg_capture_failure_raises(dev):
    a = symm_matrix(256, device=dev)

    def reading_matvec(x):
        if float(x.abs().sum()) < 0:        # a read of the device
            raise AssertionError
        return x @ a.T

    opts = SolverOptions(n_targ=2, n_max=4, max_iter=100, tol=1e-8)
    guess = torch.rand((4, 256), dtype=torch.float64, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(2))
    with pytest.raises(GraphCaptureError, match="'matvec'"):
        lobpcg(reading_matvec, diag_precnd(torch.diagonal(a)), guess, opts)
    torch.cuda.synchronize()
    with graphs._recording("eager"):
        res = lobpcg(reading_matvec, diag_precnd(torch.diagonal(a)), guess,
                     opts)
    assert res.ok


def test_nonsym_capture_failure_raises(dev):
    a = symm_matrix(256, device=dev)

    def reading_matvec(x):
        if float(x.abs().sum()) < 0:        # a read of the device
            raise AssertionError
        return x @ a.T

    opts = SolverOptions(n_targ=2, n_max=4, max_iter=100, tol=1e-8)
    guess = torch.rand((4, 256), dtype=torch.float64, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(2))
    args = (reading_matvec, reading_matvec, diag_precnd(torch.diagonal(a)),
            guess, opts)
    with pytest.raises(GraphCaptureError, match="'matvec'"):
        nonsym(*args, side="r")
    torch.cuda.synchronize()
    with graphs._recording("eager"):
        res = nonsym(*args, side="r")
    assert res.ok


def test_sharded_capture_failure_raises(dev, nccl_rank):
    """A sharded step that reads the device fails to capture on a one-rank
    NCCL group: the solve raises, it does not fall back to the eager loop;
    the same solve runs uncaptured only when asked for privately."""
    a = symm_matrix(256, device=dev)
    sh = multihost.global_sharding(256)

    def reading_matvec(x):
        if float(x.abs().sum()) < 0:        # a read of the device
            raise AssertionError
        return sh.all_gather(x) @ a.T

    opts = SolverOptions(n_targ=2, n_max=4, max_iter=100, tol=1e-8)
    guess = torch.rand((4, 256), dtype=torch.float64, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(2))
    with pytest.raises(GraphCaptureError, match="'matvec'"):
        davidson(reading_matvec, diag_precnd(torch.diagonal(a)), guess, opts,
                 sharding=sh)
    torch.cuda.synchronize()
    with graphs._recording("eager"):
        res = davidson(reading_matvec, diag_precnd(torch.diagonal(a)), guess,
                       opts, sharding=sh)
    assert res.ok
