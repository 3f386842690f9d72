"""The Davidson ladders' float32 stage ends when its residuals stall.

The upstream test matrix (``symm_matrix``: a(i,i) = i+1, a(i,j) =
1/(i+j)) at n = 1024 has a float32 noise floor near 1e-5 rms, above the
ladders' default ``lo_tol`` 2e-6: a float32 Davidson on it runs out
``lo_iter`` without reaching ``lo_tol``.  The ladders' float32 stage ends
there by its stall bit instead (``solvers/davidson.py``), and the float64
stage still reaches ``tol``.  Standalone ``davidson`` and ``gen_david``
never take that exit, and the other ladders do not watch for it.

The guess is the upstream strategy 6: unit vectors at the smallest
diagonal entries plus 0.01 uniform noise from a seeded generator.  Torch
runs on one thread, so the counts are reproducible; the routes run the
same arithmetic and are compared bit for bit.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import scipy.linalg
import torch

from diaglib_tpu_torch import (
    SolverOptions,
    davidson,
    davidson_ladder,
    gen_david,
    gen_david_ladder,
    lobpcg_ladder,
)
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
LO_TOL, LO_ITER = 2e-6, 35
ONE_PASS = {"vs": 1, "cd": 1, "shift": 0}
STALL = 4       # the stall bit's place in the packed flags


def _stall_bits(record):
    """The stall bit of each flag read of a solve (a branch step's close
    read after the loop has none)."""
    return [f[STALL] for f in record["flag_history"] if len(f) > STALL]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    a = symm_matrix(N, device="cpu")
    # a well-conditioned SPD metric: S = M^T M / n + I
    s = metric_matrix(N, torch.Generator().manual_seed(4), device="cpu") / N
    s += torch.eye(N, dtype=torch.float64)
    g = torch.Generator().manual_seed(3)
    guess = 0.01 * torch.rand((OPTS["n_max"], N), generator=g,
                              dtype=torch.float64)
    rows = torch.argsort(torch.diagonal(a), stable=True)[:OPTS["n_max"]]
    guess[torch.arange(OPTS["n_max"]), rows] += 1.0
    return a, s, guess


def _tiers(m):
    return dense_matvec(m.float()), dense_matvec(m)


def _precnds(a):
    d = torch.diagonal(a)
    return diag_precnd(d.float()), diag_precnd(d)


def _ladder(problem, gen=False, route=None, budgets=None):
    """The ladder and the records of its two stages."""
    a, s, guess = problem
    mv_lo, mv_hi = _tiers(a)
    pc_lo, pc_hi = _precnds(a)
    kw = dict(lo_tol=LO_TOL, lo_iter=LO_ITER,
              generator=torch.Generator().manual_seed(1))
    with graphs._recording(route, budgets) as rec:
        if gen:
            bv_lo, bv_hi = _tiers(s)
            res = gen_david_ladder(mv_lo, pc_lo, bv_lo, mv_hi, pc_hi, bv_hi,
                                   guess, SolverOptions(**OPTS), **kw)
        else:
            res = davidson_ladder(mv_lo, pc_lo, mv_hi, pc_hi, guess,
                                  SolverOptions(**OPTS), **kw)
    return res, rec.solves


def _float32_alone(problem, gen=False):
    """The float32 stage's solve as a standalone call, with the options
    the ladders give the stage."""
    a, s, guess = problem
    opts = SolverOptions(**dict(OPTS, tol=LO_TOL, max_iter=LO_ITER))
    mv, _ = _tiers(a)
    pc, _ = _precnds(a)
    g = torch.Generator().manual_seed(1)
    with graphs._recording() as rec:
        if gen:
            res = gen_david(mv, pc, _tiers(s)[0], guess.float(), opts,
                            generator=g)
        else:
            res = davidson(mv, pc, guess.float(), opts, generator=g)
    return res, rec.solves


@pytest.mark.parametrize("gen", [False, True], ids=["davidson", "gen_david"])
def test_float32_alone_runs_out_lo_iter_and_never_stalls(problem, gen):
    """On this matrix float32 cannot reach lo_tol: the stage as a
    standalone solve (the ladder's stage before the stall exit) spends all
    of lo_iter, its residuals flat above lo_tol, and never sets the stall
    bit."""
    res, solves = _float32_alone(problem, gen)
    assert not res.ok and res.n_iter == LO_ITER
    (s,) = solves
    assert s["end"] == "max_iter" and s["iterations"] == LO_ITER
    assert not any(_stall_bits(s))
    k = OPTS["n_targ"]
    worst = res.rms_history[:LO_ITER, :k].double().amax(dim=1)
    assert float(worst.min()) > LO_TOL
    # a plateau: its last 20 iterations gain less than a decade
    assert float(worst[15:].min()) > 0.1 * float(worst[:15].min())


@pytest.mark.parametrize("gen", [False, True], ids=["davidson", "gen_david"])
def test_ladder_float32_stage_ends_by_stall(problem, gen):
    a, s, _ = problem
    res, solves = _ladder(problem, gen)
    lo, hi = solves
    assert (lo["dtype"], lo["end"]) == ("float32", "stall")
    assert 3 < lo["iterations"] < LO_ITER
    assert _stall_bits(lo) == [0] * (lo["iterations"] - 1) + [1]
    assert (hi["dtype"], hi["end"]) == ("float64", "tol")
    assert not any(_stall_bits(hi))
    assert res.ok and res.ortho_ok
    assert res.n_iter == lo["iterations"] + hi["iterations"]
    # both stages together take fewer iterations than lo_iter alone
    assert res.n_iter < LO_ITER and hi["iterations"] <= 10
    # the float64 result against a float64 reference
    k = OPTS["n_targ"]
    ref = (scipy.linalg.eigh(a.numpy(), s.numpy(), eigvals_only=True)
           if gen else np.linalg.eigvalsh(a.numpy()))[:k]
    np.testing.assert_allclose(res.eig[:k].numpy(), ref, rtol=1e-10, atol=0)
    assert res.eig.dtype == torch.float64


@pytest.mark.parametrize("route,budgets", [
    ("unrolled", None), ("unrolled", ONE_PASS)],
    ids=["unrolled", "unrolled-one-pass"])
def test_stall_on_every_route_at_the_same_iteration(problem, route,
                                                    budgets):
    """The eager loops and the captured route's logic (fixed passes, and
    with one-pass budgets forced reruns) end the float32 stage at the same
    iteration, reading the same flags: a rerun's extra read is the one
    whose finished bit is 0, and the rest are the eager route's."""
    eager, eager_solves = _ladder(problem, route="eager")
    got, solves = _ladder(problem, route=route, budgets=budgets)
    for f in dataclasses.fields(eager):
        a, b = getattr(eager, f.name), getattr(got, f.name)
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a == b), f.name
    for e, s in zip(eager_solves, solves, strict=True):
        assert (s["iterations"], s["end"]) == (e["iterations"], e["end"])
        kept = [f for f in s["flag_history"] if f[2]]
        assert kept == e["flag_history"]
    if budgets is not None:
        assert sum(solves[0]["reruns"].values()) > 0


def test_lobpcg_ladder_keeps_its_float32_stage(problem):
    """The LOBPCG ladder does not watch for a stall: its stages pack a 0
    there and end on their tolerance or their cap as before."""
    a, _, guess = problem
    mv_lo, mv_hi = _tiers(a)
    pc_lo, pc_hi = _precnds(a)
    with graphs._recording() as rec:
        res = lobpcg_ladder(mv_lo, pc_lo, mv_hi, pc_hi, guess,
                            SolverOptions(**OPTS), lo_tol=LO_TOL, lo_iter=20,
                            generator=torch.Generator().manual_seed(1))
    lo, hi = rec.solves
    assert lo["end"] in ("max_iter", "tol") and lo["dtype"] == "float32"
    assert not any(b for s in rec.solves for b in _stall_bits(s))
    assert res.ok


def test_stall_rule_on_histories():
    """The rule on hand-made histories of the largest targeted rms: it
    ignores the first iterations, a slow start above the drop, a root
    entering late (a jump up, then a fast descent), and steady descent by
    more than the factor over the window; it fires on a flat tail below
    the drop."""
    w, f, drop = dmod.STALL_WINDOW, dmod.STALL_FACTOR, dmod.STALL_DROP

    def fires(worst):
        st = _stub(worst)
        return [bool(st.stalled_at(i)) for i in range(len(worst))]

    flat = [1.0, 1e-2, 1e-4] + [1.1e-5, 1.3e-5, 1.2e-5, 1.0e-5, 1.2e-5]
    got = fires(flat)
    assert not any(got[:w]) and got[-1]
    first = got.index(True)
    assert first == 3 + w - 1 or first == 3 + w
    slow = [0.07, 0.05, 0.045, 0.04, 0.04, 0.039]
    assert not any(fires(slow))
    jump = [1.0, 1e-2, 1e-4, 5e-5, 0.5, 1e-2, 1e-4, 5e-5, 3e-6]
    assert not any(fires(jump))
    steady = [10 ** -(i * 0.4) for i in range(20)]
    assert 10 ** (0.4 * w) > f and not any(fires(steady))
    assert drop > 1


class _stub:
    """The stall rule of ``_Iteration.stalled`` over a given history."""

    def __init__(self, worst):
        m = len(worst)
        self.targ = torch.tensor([True, True, False])
        self.rms_h = torch.full((m, 3), torch.inf)
        self.rms_h[:, 0] = torch.tensor(worst)
        self.rms_h[:, 1] = torch.tensor(worst) / 3
        self.iters = torch.arange(m)

    def stalled_at(self, it):
        self.it = torch.tensor(it)
        return dmod._Iteration.stalled(self)
