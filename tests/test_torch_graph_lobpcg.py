"""The LOBPCG iteration as steps over fixed device state (the captured
route's logic, run on the CPU without capture) against the JAX package and
against the eager loop it replaced.

Protocol: symm_matrix(400) (and a numpy metric m^T m / n + I for the
generalized path), 10 roots, n_max 15, tol 1e-8, a numpy guess; a
narrower solve at n_targ 4, n_max 6, tol 1e-10; the ladder on the port's
random_bsr_spd(1024, 64, 4) store, 6 roots, n_max 8, lo_iter 70.  Torch
runs on one thread here, so the counts are reproducible; the pinned counts
are those of the eager loop before the restructuring on this protocol.

Tolerances: eigenvalues within 1e-10 of JAX's, counts within the +-2 band
of tests/test_iteration_parity.py; the routes of the port against each
other bit for bit (they run the same arithmetic).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.problems import dense_matvec as j_dense_matvec
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.solvers import lobpcg as j_lobpcg
from diaglib_tpu_torch import SolverOptions, lobpcg, lobpcg_ladder
from diaglib_tpu_torch.ops import bsr_sliced_sym as sym
from diaglib_tpu_torch.ops.bsr import random_bsr_spd
from diaglib_tpu_torch.problems import dense_matvec, diag_precnd, symm_matrix
from diaglib_tpu_torch.utils import graphs

lmod = importlib.import_module("diaglib_tpu_torch.solvers.lobpcg")

N = 400
TOY = dict(n_targ=10, n_max=15, max_iter=100, tol=1e-8)
NARROW = dict(n_targ=4, n_max=6, max_iter=150, tol=1e-10)
LADDER = dict(n_targ=6, n_max=8, max_iter=150, tol=1e-10, max_dav=10)
SHORT = {"vs": 1, "cd": 1, "shift": 0}
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


def _solve(problem, gen, opts, route=None, budgets=None):
    a, s = problem
    bvec = dense_matvec(torch.from_numpy(s)) if gen else None
    with graphs._recording(route, budgets) as rec:
        res = lobpcg(dense_matvec(a), diag_precnd(torch.diagonal(a)),
                     torch.from_numpy(_guess(opts["n_max"])),
                     SolverOptions(**opts), bvec=bvec)
    return res, rec.solves


def _same(a, b):
    assert (a.ok, a.n_iter, a.n_matvec, a.ortho_ok) == \
        (b.ok, b.n_iter, b.n_matvec, b.ortho_ok)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---- against the JAX package ----

@pytest.mark.parametrize("gen", [False, True], ids=["lobpcg", "generalized"])
def test_unrolled_route_against_jax(problem, gen):
    a, s = problem
    res, solves = _solve(problem, gen, TOY, "unrolled")
    ja = jnp.asarray(a.numpy())
    ref = j_lobpcg(j_dense_matvec(ja), j_diag_precnd(jnp.diagonal(ja)),
                   jnp.asarray(_guess(15)), JOptions(**TOY),
                   key=jax.random.PRNGKey(1),
                   bvec=j_dense_matvec(jnp.asarray(s)) if gen else None)
    assert res.ok and bool(ref.ok) and res.ortho_ok
    np.testing.assert_allclose(res.eig[:10].numpy(), np.asarray(ref.eig[:10]),
                               rtol=0, atol=1e-10)
    assert abs(res.n_iter - int(ref.n_iter)) <= 2
    assert abs(res.n_matvec - int(ref.n_matvec)) <= 2 * 15
    assert [(r["solver"], r["route"]) for r in solves] == [
        ("lobpcg", "unrolled")]


# ---- against the eager loop it replaced ----

# (ok, n_iter, n_matvec) of the eager loop before the restructuring, on
# this module's protocol (one thread)
PINNED = {"lobpcg": (True, 16, 236), "generalized": (True, 12, 167),
          "max_iter 3": (False, 3, 60), "narrow": (True, 25, 154)}
CASES = {"lobpcg": (False, TOY), "generalized": (True, TOY),
         "max_iter 3": (False, dict(TOY, max_iter=3)),
         "narrow": (False, NARROW)}


@pytest.mark.parametrize("case", list(CASES))
def test_routes_bit_equal_and_pinned(problem, case):
    """The eager route, the unrolled route with the default passes and the
    unrolled route at one pass a loop (every update whose loops need more
    is run again eagerly) give the pinned counts and the same bits."""
    gen, opts = CASES[case]
    eager, solves = _solve(problem, gen, opts, "eager")
    assert (eager.ok, eager.n_iter, eager.n_matvec) == PINNED[case]
    # the eager loops' passes are recorded
    assert solves[0]["passes"]["vs"] >= 1 and solves[0]["passes"]["cd"] >= 1
    unrolled, solves = _solve(problem, gen, opts, "unrolled")
    _same(eager, unrolled)
    assert solves[0]["reruns"] == {"update": 0}
    short, solves = _solve(problem, gen, opts, "unrolled", SHORT)
    _same(eager, short)
    # the forced rare branch is counted: at one pass a loop nearly every
    # update needs its eager rerun
    if eager.n_iter > 3:
        assert solves[0]["reruns"]["update"] > 0


def test_nonconvergence_reports_not_ok(problem):
    res, solves = _solve(problem, False, dict(TOY, max_iter=3), "unrolled")
    assert not res.ok and res.n_iter == 3 and res.n_matvec == 4 * 15
    assert np.isinf(res.rms_history[3:].numpy()).all()
    assert solves[0]["iterations"] == 3


@pytest.mark.parametrize("route", ["eager", "unrolled", "short"])
def test_one_flag_read_an_iteration(problem, route):
    """The host reads the device once an iteration through the one read
    function, and once more for each rerun of a rare branch."""
    budgets = SHORT if route == "short" else None
    before = graphs._read_flags.count
    res, solves = _solve(problem, False, NARROW,
                         "unrolled" if budgets else route, budgets)
    reruns = solves[0]["reruns"]["update"]
    assert graphs._read_flags.count - before == res.n_iter + reruns
    assert solves[0]["flag_reads"] == res.n_iter + reruns
    assert (reruns > 0) == (route == "short")


@pytest.mark.parametrize("gen", [False, True], ids=["lobpcg", "generalized"])
def test_update_reruns_from_its_kept_inputs(problem, gen):
    """An update run again (as after a rare branch) from the inputs it
    kept, with the eager loops, writes what the unrolled update wrote when
    its loops finished, though the next iteration's steps ran between."""
    a, s = problem
    opts = SolverOptions(**TOY)
    bvec = dense_matvec(torch.from_numpy(s)) if gen else None
    st = lmod._start(dense_matvec(a), diag_precnd(torch.diagonal(a)), bvec,
                     torch.from_numpy(_guess(15)), opts, None, "device",
                     N ** 0.5, graphs._UNROLL)
    for _ in range(3):
        st.matvec()
        st.reduced("device")
        st.ritz()
        st.update()
    names = ("space", "aspace", "bspace", "ortho_ok", "n_act", "p_count",
             "finished3")
    once = {k: getattr(st, k).clone() for k in names
            if getattr(st, k) is not None}
    assert bool(st.finished3)
    # the next iteration's steps 1-2 overwrite what the update read
    st.matvec()
    st.reduced("device")
    st.ritz()
    st.undo_ritz()
    st.rerun("update")
    for k, v in once.items():
        assert torch.equal(getattr(st, k), v), k


# ---- the ladder ----

@pytest.fixture(scope="module")
def store():
    return sym.slice_bsr_sym(random_bsr_spd(1024, 64, 4, seed=0,
                                            device="cpu"))


def _ladder(store, route):
    f32 = torch.float32
    z = torch.zeros((8, 1024), dtype=torch.float64)
    with graphs._recording(route) as rec:
        res = lobpcg_ladder(
            sym.sym_sliced_matvec(store, dtype=f32),
            diag_precnd(store.diagonal.float()), sym.sym_sliced_matvec(store),
            diag_precnd(store.diagonal), z, SolverOptions(**LADDER),
            lo_tol=2e-6, lo_iter=70,
            generator=torch.Generator().manual_seed(1))
    return res, rec.solves


def test_ladder_pinned_and_bit_equal(store):
    eager, _ = _ladder(store, "eager")
    assert (eager.ok, eager.n_iter, eager.n_matvec) == (True, 89, 576)
    unrolled, solves = _ladder(store, "unrolled")
    _same(eager, unrolled)
    # both stages take the route, each with its own steps
    assert [s["dtype"] for s in solves] == ["float32", "float64"]
    assert sum(s["iterations"] for s in solves) == unrolled.n_iter


def test_captured_route_refused_without_a_card(problem):
    with pytest.raises(ValueError, match="captured route"):
        _solve(problem, False, TOY, "graphs")
