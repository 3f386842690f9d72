"""The Davidson family's state and graphs kept from one solve to the next
of the same shape (``utils.graphs.StepCache``), on the CPU: the private
"unrolled" route keeps and resets the state as the captured route does,
with no graphs.

Protocol: the upstream test matrix symm_matrix(1024) (and the metric
S = M^T M / n + I for gen_david), 10 roots, n_max 15, tol 1e-8, max_dav
20, guesses by the upstream strategy 6 (unit vectors at the smallest
diagonal entries plus 0.01 uniform noise, from a seed); the ladder with
lo_tol 2e-6 and lo_iter 35.  Torch runs on one thread.  A solve on a kept
state gives the bits of a solve on a new one (the same arithmetic on
buffers reset to a new state's values); the ladder's eigenvalues are held
to numpy's eigvalsh within 1e-10.
"""

import gc
import importlib
import weakref

import numpy as np
import pytest
import torch

from diaglib_tpu_torch import (
    SolverOptions,
    davidson,
    davidson_ladder,
    gen_david,
    lobpcg,
)
from diaglib_tpu_torch.parallel import VectorSharding, initialize
from diaglib_tpu_torch.problems import (
    dense_matvec,
    diag_precnd,
    metric_matrix,
    symm_matrix,
)
from diaglib_tpu_torch.utils import graphs

dmod = importlib.import_module("diaglib_tpu_torch.solvers.davidson")

N = 1024
OPTS = dict(n_targ=10, n_max=15, max_iter=100, tol=1e-8, max_dav=20)
SHORT = dict(OPTS, max_iter=3)
FIELDS = ("eig", "evec", "done", "rms_history", "max_history",
          "eig_history")
KINDS = ("davidson", "gen_david", "davidson_ladder")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_cache():
    graphs.STEP_CACHE.clear()
    yield
    graphs.STEP_CACHE.clear()


@pytest.fixture(scope="module")
def problem():
    a = symm_matrix(N, device="cpu")
    s = metric_matrix(N, torch.Generator().manual_seed(4), device="cpu") / N
    s += torch.eye(N, dtype=torch.float64)
    return a, s


def _guess(a, seed, dtype=torch.float64, n=N):
    k = OPTS["n_max"]
    g = torch.Generator().manual_seed(seed)
    guess = 0.01 * torch.rand((k, n), generator=g, dtype=torch.float64)
    rows = torch.argsort(torch.diagonal(a)[:n], stable=True)[:k]
    guess[torch.arange(k), rows] += 1.0
    return guess.to(dtype)


class _Ops:
    """The callables of a solve, made anew for each instance."""

    def __init__(self, problem):
        a, s = problem
        self.mv_lo, self.mv_hi = dense_matvec(a.float()), dense_matvec(a)
        d = torch.diagonal(a)
        self.pc_lo, self.pc_hi = diag_precnd(d.float()), diag_precnd(d)
        self.bv_hi = dense_matvec(s)


def _run(kind, ops, guess, opts=OPTS, route="unrolled", **kw):
    """(result, the solve's records) of ``kind`` on ``route``."""
    options = SolverOptions(**opts)
    with graphs._recording(route) as rec:
        if kind == "davidson":
            res = davidson(ops.mv_hi, ops.pc_hi, guess, options, **kw)
        elif kind == "gen_david":
            res = gen_david(ops.mv_hi, ops.pc_hi, ops.bv_hi, guess, options,
                            **kw)
        else:
            res = davidson_ladder(ops.mv_lo, ops.pc_lo, ops.mv_hi,
                                  ops.pc_hi, guess, options, lo_tol=2e-6,
                                  lo_iter=35, **kw)
    return res, rec.solves


def _same(a, b):
    assert (a.ok, a.n_iter, a.n_matvec, a.ortho_ok) == \
        (b.ok, b.n_iter, b.n_matvec, b.ortho_ok)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("kind", KINDS)
def test_kept_state_gives_a_new_states_bits(problem, kind):
    """Solves from guesses 1, 2, then 1 again on one set of callables: the
    first makes the state, the next two reuse it, and each returns every
    tensor bit-equal to a solve on a new state from the same guess."""
    a, _ = problem
    seeds = (1, 2, 1)
    fresh = []
    for seed in seeds:
        graphs.STEP_CACHE.clear()
        fresh.append(_run(kind, _Ops(problem), _guess(a, seed))[0])
    graphs.STEP_CACHE.clear()
    ops = _Ops(problem)
    stages = 2 if kind == "davidson_ladder" else 1
    for seed, want, reused in zip(seeds, fresh, (False, True, True)):
        res, solves = _run(kind, ops, _guess(a, seed))
        assert res.ok
        _same(res, want)
        assert [s["reused"] for s in solves] == [reused] * stages
        assert [s["route"] for s in solves] == ["unrolled"] * stages
    assert len(graphs.STEP_CACHE) == stages


@pytest.mark.parametrize("kind", KINDS)
def test_held_result_survives_the_next_solve(problem, kind):
    """A result held from one solve is not the kept state's: the next
    solve on that state leaves it as it was."""
    a, _ = problem
    ops = _Ops(problem)
    held, _ = _run(kind, ops, _guess(a, 1))
    copy = {f: getattr(held, f).clone() for f in FIELDS}
    _, solves = _run(kind, ops, _guess(a, 2))
    assert all(s["reused"] for s in solves)
    for f in FIELDS:
        assert torch.equal(getattr(held, f), copy[f]), f


def _generic(a):
    """A matvec and a preconditioner for any leading n and dtype, marked
    replayable: they read only ``a``."""
    def mv(x):
        n = x.shape[1]
        return x @ a[:n, :n].T.to(x.dtype)

    def pc(fac, x):
        return diag_precnd(torch.diagonal(a)[:x.shape[1]].to(x.dtype))(fac,
                                                                        x)
    return graphs.replayable(mv), graphs.replayable(pc)


def test_another_key_misses(problem):
    """Another option, dtype, n or callable is another entry; the same
    ones again hit it."""
    a, _ = problem
    mv, pc = _generic(a)

    def run(mv=mv, opts=SHORT, dtype=torch.float64, n=N):
        with graphs._recording("unrolled") as rec:
            davidson(mv, pc, _guess(a, 1, dtype, n), SolverOptions(**opts))
        return rec.solves[0]["reused"]

    assert not run()
    assert run()
    misses = [run(opts=dict(SHORT, tol=1e-9)), run(dtype=torch.float32),
              run(n=N // 2)]
    assert misses == [False, False, False]
    assert len(graphs.STEP_CACHE) == 4
    other = _generic(a)[0]
    assert not run(mv=other)
    assert len(graphs.STEP_CACHE) == graphs.STEP_CACHE_SIZE == 4
    assert run(n=N // 2) and run(mv=other)
    # an unmarked callable keys nothing: a closure, a callable with no
    # weak reference or no hash, a bound method
    class NoRef:
        __slots__ = ()

        def __call__(self, x):
            return mv(x)

    class Unhashable:
        __eq__ = object.__eq__
        __hash__ = None

        def __call__(self, x):
            return mv(x)

    class Op:
        def matvec(self, x):
            return mv(x)

    for fn in (lambda x: mv(x), NoRef(), Unhashable(), Op().matvec):
        assert graphs.STEP_CACHE.key("davidson", (fn, pc), N) is None
    with pytest.raises(TypeError):
        graphs.replayable(NoRef())
    with graphs._recording("unrolled") as rec:
        davidson(Unhashable(), pc, _guess(a, 1), SolverOptions(**SHORT))
    assert not rec.solves[0]["reused"]


def test_unmarked_callables_are_captured_each_solve(problem):
    """A bound method over a matrix the caller rebinds between solves is
    not keyed: each solve makes its state anew and solves the matrix it
    was called with, bit-equal to a solve with marked closures over it."""
    a, _ = problem
    b = a.clone()
    b.diagonal().add_(0.5)

    class Op:
        def __init__(self, h):
            self.h = h

        def matvec(self, x):
            return x @ self.h.T

        def precnd(self, fac, x):
            return diag_precnd(torch.diagonal(self.h))(fac, x)

    op = Op(a)
    for h in (a, b):
        op.h = h
        with graphs._recording("unrolled") as rec:
            res = davidson(op.matvec, op.precnd, _guess(a, 1),
                           SolverOptions(**OPTS))
        assert not rec.solves[0]["reused"]
        want, _ = _run("davidson", _Ops((h, None)), _guess(a, 1))
        _same(res, want)
    gc.collect()
    assert len(graphs.STEP_CACHE) == 0      # nothing keyed by op


def test_bound_drops_the_least_recently_used(problem, monkeypatch):
    a, _ = problem
    monkeypatch.setattr(graphs.STEP_CACHE, "size", 2)
    ops = [_Ops(problem) for _ in range(3)]

    def run(i):
        _, solves = _run("davidson", ops[i], _guess(a, 1), SHORT)
        return solves[0]["reused"]

    assert [run(0), run(1), run(2)] == [False, False, False]
    assert len(graphs.STEP_CACHE) == 2
    assert not run(0)           # the oldest went: 1, 2 -> 2, 0
    assert run(2)               # 0, 2
    assert not run(1)           # 2, 1
    assert run(2) and not run(0)


def test_collected_callables_drop_their_entry(problem):
    """The cache holds the callables weakly: when they go, the entry goes
    with its state and arena."""
    a, _ = problem
    ops = _Ops(problem)
    res, _ = _run("davidson_ladder", ops, _guess(a, 1))
    kept = _kept()
    assert len(kept) == 2
    assert all(st.matvec_fn is None and st.precnd is None for st in kept)
    arena = weakref.ref(kept[0].arena)
    del ops, kept
    gc.collect()
    assert len(graphs.STEP_CACHE) == 0 and arena() is None
    assert res.ok       # the result is the caller's


def _kept():
    return [st for entries in graphs.STEP_CACHE._devices.values()
            for st, _ in entries.values()]


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, torn down after the test."""
    initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, backend="gloo")
    try:
        yield VectorSharding(N)
    finally:
        torch.distributed.destroy_process_group()


def test_eager_and_sharded_solves_keep_nothing(problem, one_rank):
    """The eager route and a sharding= solve make a new state every
    solve, as before: nothing is kept, nothing is reused."""
    a, _ = problem
    ops = _Ops(problem)
    for _ in range(2):
        for kw in (dict(route="eager"), dict(sharding=one_rank)):
            _, solves = _run("davidson", ops, _guess(a, 1), SHORT, **kw)
            assert not solves[0]["reused"]
    assert len(graphs.STEP_CACHE) == 0


def test_other_solvers_keep_nothing(problem):
    a, _ = problem
    ops = _Ops(problem)
    for _ in range(2):
        with graphs._recording("unrolled") as rec:
            lobpcg(ops.mv_hi, ops.pc_hi, _guess(a, 1),
                   SolverOptions(**SHORT))
        assert [s["reused"] for s in rec.solves] == [False]
    assert len(graphs.STEP_CACHE) == 0


def test_ladder_stages_share_one_arena(problem):
    """A ladder call's two stages keep their (rows, n) buffers in one
    arena, sized for the float64 stage; another ladder call makes its own,
    a solve outside a ladder keeps buffers of its own, and no state of a
    busy arena is handed out.  The kept ladder's eigenvalues match
    eigvalsh."""
    a, _ = problem
    ops = _Ops(problem)
    for seed, reused in ((1, False), (2, True)):
        res, solves = _run("davidson_ladder", ops, _guess(a, seed))
        assert [s["reused"] for s in solves] == [reused, reused]
        assert [s["dtype"] for s in solves] == ["float32", "float64"]
    kept = _kept()
    assert {st.space.dtype for st in kept} == {torch.float32, torch.float64}
    names, shapes = dmod._Iteration.wide(SolverOptions(**OPTS), N, False)
    arena = kept[0].arena
    assert arena.bytes.numel() == graphs.Arena.nbytes(shapes, 8)
    assert not arena.busy
    base = arena.bytes.untyped_storage().data_ptr()
    for st in kept:
        assert st.arena is arena
        for name in names:
            assert getattr(st, name).untyped_storage().data_ptr() == base
    ref = np.linalg.eigvalsh(a.numpy())[:OPTS["n_targ"]]
    np.testing.assert_allclose(res.eig[:OPTS["n_targ"]].numpy(), ref,
                               rtol=0, atol=1e-10)
    # while a state of the arena is in use, its partner is not handed out
    (key, (st, _)), = [(k, e) for k, e in next(
        iter(graphs.STEP_CACHE._devices.values())).items() if not k[-3]]
    arena.busy = True
    assert graphs.STEP_CACHE.take(key, "cpu") == (None, None)
    arena.busy = False
    assert graphs.STEP_CACHE.take(key, "cpu")[0] is st
    graphs.STEP_CACHE.clear()
    # another ladder's stages, and a solve outside a ladder (with other
    # options: with the float64 stage's, it would take that stage's state)
    other = _Ops(problem)
    _run("davidson_ladder", other, _guess(a, 1))
    _run("davidson", other, _guess(a, 1), SHORT)
    arenas = [st.arena for st in _kept()]
    assert arenas[2] is None and arenas[0] is arenas[1] is not arena
