"""The Davidson iteration as steps over fixed device state (the captured
route's logic, run on the CPU without capture) against the JAX package and
against the eager loop it replaced.

Protocol: symm_matrix(400) (and a numpy metric m^T m / n + I for
gen_david), 10 roots, n_max 15, tol 1e-8, a numpy guess; the restart path
at n_targ 4, n_max 6, max_dav 10, tol 1e-10; the ladders on the port's
random_bsr_spd(1024, 64, 4) and bsr_gen_problem(1024, 64, 4) stores, 6
roots, n_max 8.  Torch runs on one thread here, so the counts are
reproducible; the pinned counts are those of the eager loop before the
restructuring on this protocol.

Tolerances: eigenvalues within 1e-10 of JAX's, counts within the +-2 band
of tests/test_iteration_parity.py; the routes of the port against each
other bit for bit (they run the same arithmetic); the deterministic BSR
sums within 1e-14 max|y| of the reference's segment sum.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.ops.bsr import bsr_matvec as j_bsr_matvec
from diaglib_tpu.ops.bsr import random_bsr_spd as j_random_bsr_spd
from diaglib_tpu.problems import dense_matvec as j_dense_matvec
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.solvers import davidson as j_davidson
from diaglib_tpu.solvers import gen_david as j_gen_david
from diaglib_tpu_torch import (
    SolverOptions,
    davidson,
    davidson_ladder,
    gen_david,
    gen_david_ladder,
)
from diaglib_tpu_torch.ops import bsr_sliced_sym as sym
from diaglib_tpu_torch.ops.bsr import (
    bsr_from_arrays,
    bsr_matvec,
    bsr_spmm_plain,
    random_bsr_spd,
    row_slots,
)
from diaglib_tpu_torch.ops.dist_bsr import _segment_spmm
from diaglib_tpu_torch.problems import (
    bsr_gen_problem,
    dense_matvec,
    diag_precnd,
    symm_matrix,
)
from diaglib_tpu_torch.utils import graphs
from diaglib_tpu_torch.utils.masking import (
    gather_rows,
    masked_cholesky,
    prefix_mask,
    scatter_rows,
)

dmod = importlib.import_module("diaglib_tpu_torch.solvers.davidson")

N = 400
TOY = dict(n_targ=10, n_max=15, max_iter=100, tol=1e-8)
RESTART = dict(n_targ=4, n_max=6, max_iter=150, tol=1e-10, max_dav=10)
LADDER = dict(n_targ=6, n_max=8, max_iter=150, tol=1e-10, max_dav=10)
FIELDS = ("eig", "evec", "done", "rms_history", "max_history",
          "eig_history")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    a = symm_matrix(N, device="cpu")
    m = np.random.default_rng(2).uniform(size=(N, N))
    s = m.T @ m / N + np.eye(N)
    return a, s


def _guess(k, seed=1):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (k, N))


def _solve(problem, gen, opts, guess, route=None, budgets=None):
    a, s = problem
    args = (dense_matvec(a), diag_precnd(torch.diagonal(a)))
    if gen:
        args += (dense_matvec(torch.from_numpy(s)),)
    with dmod._recording(route, budgets) as rec:
        res = (gen_david if gen else davidson)(
            *args, torch.from_numpy(guess), SolverOptions(**opts))
    return res, rec.solves


def _same(a, b):
    assert (a.ok, a.n_iter, a.n_matvec, a.ortho_ok) == \
        (b.ok, b.n_iter, b.n_matvec, b.ortho_ok)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---- against the JAX package ----

@pytest.mark.parametrize("gen", [False, True], ids=["davidson", "gen_david"])
def test_unrolled_route_against_jax(problem, gen):
    a, s = problem
    opts = dict(TOY, max_dav=20) if gen else TOY
    res, solves = _solve(problem, gen, opts, _guess(15), "unrolled")
    ja = jnp.asarray(a.numpy())
    jargs = (j_dense_matvec(ja), j_diag_precnd(jnp.diagonal(ja)))
    if gen:
        ref = j_gen_david(*jargs, j_dense_matvec(jnp.asarray(s)),
                          jnp.asarray(_guess(15)), JOptions(**opts),
                          key=jax.random.PRNGKey(1))
    else:
        ref = j_davidson(*jargs, jnp.asarray(_guess(15)), JOptions(**opts),
                         key=jax.random.PRNGKey(1))
    assert res.ok and bool(ref.ok) and res.ortho_ok
    np.testing.assert_allclose(res.eig[:10].numpy(), np.asarray(ref.eig[:10]),
                               rtol=0, atol=1e-10)
    assert abs(res.n_iter - int(ref.n_iter)) <= 2
    assert abs(res.n_matvec - int(ref.n_matvec)) <= 2 * 15
    assert [r["route"] for r in solves] == ["unrolled"]


# ---- against the eager loop it replaced ----

# (ok, n_iter, n_matvec) of the eager loop before the restructuring, on
# this module's protocol (one thread)
PINNED = {"davidson": (True, 14, 199), "davidson restart": (True, 29, 168),
          "davidson max_iter 3": (False, 3, 45), "gen_david": (True, 10, 134),
          "gen_david restart": (True, 14, 75)}
CASES = {"davidson": (False, TOY, 1), "davidson restart": (False, RESTART, 2),
         "davidson max_iter 3": (False, dict(TOY, max_iter=3), 1),
         "gen_david": (True, dict(TOY, max_dav=20), 1),
         "gen_david restart": (True, RESTART, 2)}


@pytest.mark.parametrize("case", list(CASES))
def test_routes_bit_equal_and_pinned(problem, case):
    """The eager route, the unrolled route with the default passes and the
    unrolled route at one pass a loop (every expand whose loops need more
    is run again eagerly) give the pinned counts and the same bits."""
    gen, opts, seed = CASES[case]
    guess = _guess(opts["n_max"], seed)
    eager, _ = _solve(problem, gen, opts, guess, "eager")
    assert (eager.ok, eager.n_iter, eager.n_matvec) == PINNED[case]
    unrolled, solves = _solve(problem, gen, opts, guess, "unrolled")
    _same(eager, unrolled)
    assert solves[0]["reruns"] == {"expand": 0, "restart": 0}
    short, solves = _solve(problem, gen, opts, guess, "unrolled",
                           {"vs": 1, "cd": 1, "shift": 0})
    _same(eager, short)
    # the forced rare branch is counted: at one pass a loop nearly every
    # expand needs its eager rerun
    if eager.n_iter > 3:
        assert solves[0]["reruns"]["expand"] > 0


def test_restart_path_restarts(problem):
    res, solves = _solve(problem, False, RESTART, _guess(6, 2), "unrolled")
    # past dim_dav iterations the space was collapsed at least once
    assert res.ok and res.n_iter > SolverOptions(**RESTART).dim_dav
    assert solves[0]["iterations"] == res.n_iter
    assert solves[0]["reruns"] == {"expand": 0, "restart": 0}


def test_nonconvergence_reports_not_ok(problem):
    res, _ = _solve(problem, False, dict(TOY, max_iter=3), _guess(15),
                    "unrolled")
    assert not res.ok and res.n_iter == 3 and res.n_matvec == 3 * 15
    assert np.isinf(res.rms_history[3:].numpy()).all()


@pytest.mark.parametrize("route", ["eager", "unrolled"])
def test_one_flag_read_an_iteration(problem, route):
    """The host reads the device once an iteration through the one read
    function, and once more for each rerun of a rare branch."""
    before = dmod._read_flags.count
    res, solves = _solve(problem, False, RESTART, _guess(6, 2), route)
    reruns = sum(solves[0]["reruns"].values())
    assert dmod._read_flags.count - before == res.n_iter + reruns
    assert solves[0]["flag_reads"] == res.n_iter + reruns
    _, solves = _solve(problem, False, RESTART, _guess(6, 2), "unrolled",
                       {"vs": 1, "cd": 1, "shift": 0})
    s = solves[0]
    assert s["flag_reads"] == s["iterations"] + sum(s["reruns"].values())


@pytest.mark.parametrize("gen", [False, True], ids=["davidson", "gen_david"])
@pytest.mark.parametrize("branch", ["expand", "restart"])
def test_rerun_repeats_the_step_from_its_kept_inputs(problem, gen, branch):
    """A step 3 run again (as after a rare branch) from the inputs it kept,
    with the eager loops, writes what the unrolled step wrote when its
    loops finished."""
    a, s = problem
    opts = SolverOptions(**dict(TOY, max_dav=20))
    guess = torch.from_numpy(_guess(15))
    bvec = dense_matvec(torch.from_numpy(s)) if gen else None
    bguess = bvec(guess) if gen else None
    if gen:
        guess, bguess, _ = dmod.b_ortho(guess, bguess)
    st = dmod._Iteration(dense_matvec(a), diag_precnd(torch.diagonal(a)),
                         bvec, guess, bguess, True, opts, N ** 0.5,
                         dmod._UNROLL)
    for step in range(3):       # two expansions, then the branch
        st.matvec()
        st.reduced(int(st.ldu_new), "device")
        st.ritz()
        getattr(st, "expand" if step < 2 else branch)()
    names = ("space", "aspace", "bspace", "a_red", "ortho_ok", "ldu",
             "n_act", "n_rst", "finished3")
    once = {k: getattr(st, k).clone() for k in names
            if getattr(st, k) is not None}
    assert bool(st.finished3)
    st.rerun(branch)
    for k, v in once.items():
        assert torch.equal(getattr(st, k), v), k


# ---- the ladders ----

@pytest.fixture(scope="module")
def stores():
    m = random_bsr_spd(1024, 64, 4, seed=0, device="cpu")
    ga, gb = bsr_gen_problem(1024, 64, 4, seed=0, device="cpu")
    return sym.slice_bsr_sym(m), ga, gb


def _ladder(stores, gen, route):
    st, ga, gb = stores
    f32 = torch.float32
    z = torch.zeros((8, 1024), dtype=torch.float64)
    opts = SolverOptions(**LADDER)
    with dmod._recording(route) as rec:
        if gen:
            res = gen_david_ladder(
                sym.sliced_matvec_any(ga, dtype=f32),
                diag_precnd(ga.diagonal.float()),
                sym.sliced_matvec_any(gb, dtype=f32),
                sym.sliced_matvec_any(ga), diag_precnd(ga.diagonal),
                sym.sliced_matvec_any(gb), z, opts, lo_tol=2e-6, lo_iter=60,
                generator=torch.Generator().manual_seed(1))
        else:
            res = davidson_ladder(
                sym.sym_sliced_matvec(st, dtype=f32),
                diag_precnd(st.diagonal.float()), sym.sym_sliced_matvec(st),
                diag_precnd(st.diagonal), z, opts, lo_tol=2e-6, lo_iter=35,
                generator=torch.Generator().manual_seed(1))
    return res, rec.solves


@pytest.mark.parametrize("gen,pinned", [(False, (True, 42, 332)),
                                        (True, (True, 27, 197))],
                         ids=["davidson_ladder", "gen_david_ladder"])
def test_ladders_pinned_and_bit_equal(stores, gen, pinned):
    eager, _ = _ladder(stores, gen, "eager")
    assert (eager.ok, eager.n_iter, eager.n_matvec) == pinned
    unrolled, solves = _ladder(stores, gen, "unrolled")
    _same(eager, unrolled)
    # both stages take the route, each with its own steps
    assert [s["dtype"] for s in solves] == ["float32", "float64"]
    assert sum(s["iterations"] for s in solves) == unrolled.n_iter


# ---- the helpers the steps stand on ----

def test_masking_takes_device_scalars_and_writes_in_place():
    x = torch.arange(24.0).reshape(8, 3)
    start, count = torch.tensor(2), torch.tensor(3)
    got = gather_rows(x, start, 4, count=count)
    assert torch.equal(got[:3], x[2:5]) and float(got[3:].abs().max()) == 0
    buf = torch.zeros(8, 3)
    same = scatter_rows(buf, torch.ones(4, 3), torch.tensor(6))
    assert same is buf                      # in place, clamped to fit
    assert float(buf[4:].min()) == 1.0 and float(buf[:4].abs().max()) == 0
    assert torch.equal(prefix_mask(5, torch.tensor(2)),
                       torch.tensor([True, True, False, False, False]))
    _, failed = masked_cholesky(-torch.eye(3), torch.ones(3, dtype=torch.bool))
    assert isinstance(failed, torch.Tensor) and failed.ndim == 0
    assert bool(failed)


def test_step_graphs_on_the_cpu_call_the_step():
    calls = []
    g = graphs.StepGraphs(torch.device("cpu"), capture=False)
    with g:
        for _ in range(3):
            g.run("step", lambda: calls.append(1))
    assert len(calls) == 3 and not g.graphs and g.capture_s == 0.0
    with pytest.raises(ValueError):
        graphs.StepGraphs(torch.device("cpu"))
    assert set(graphs.kernel_counters()) == {
        "peel_rows", "sym_spmm", "sliced_wide_mm", "bsr_spmm",
        "sliced_spmm", "group_spmm"}


def test_captured_route_refused_without_a_card(problem):
    with pytest.raises(ValueError, match="captured route"):
        _solve(problem, False, TOY, _guess(15), "graphs")


# ---- the deterministic float64 BSR sums ----

@pytest.fixture(scope="module")
def bsr64():
    jm = j_random_bsr_spd(1024, 64, 6, jax.random.PRNGKey(3),
                          dtype=jnp.float64)
    x = np.random.default_rng(4).standard_normal((5, 1024))
    ref = np.asarray(j_bsr_matvec(jm, force_reference=True)(jnp.asarray(x)))
    return bsr_from_arrays(jm, device="cpu"), x, ref


def test_plain_bsr_sum_against_reference(bsr64):
    m, x, ref = bsr64
    tol = 1e-14 * np.abs(ref).max()
    y = bsr_matvec(m)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, ref, rtol=0, atol=tol)
    again = bsr_spmm_plain(m, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(y, again)


def test_distributed_segment_sum_against_reference(bsr64):
    m, x, ref = bsr64
    nbr = m.n // m.block
    xb = torch.from_numpy(x).reshape(5, nbr, m.block).transpose(0, 1)
    y = torch.zeros((nbr, 5, m.block), dtype=torch.float64)
    _segment_spmm(xb, m.cols, m.blocks_t, y, row_slots(m.rows, nbr))
    y = y.transpose(0, 1).reshape(5, m.n).numpy()
    np.testing.assert_allclose(y, ref, rtol=0,
                               atol=1e-14 * np.abs(ref).max())


def test_row_slots_order_entries_by_row():
    rows = torch.tensor([2, 0, 2, 1, 2], dtype=torch.int32)
    assert row_slots(rows, 4).tolist() == [[1, 5, 5], [3, 5, 5],
                                           [0, 2, 4], [5, 5, 5]]
