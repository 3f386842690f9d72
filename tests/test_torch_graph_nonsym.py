"""The two-sided nonsymmetric Davidson pass as steps over fixed device
state (the captured route's logic, run on the CPU without capture) against
the JAX package and against the eager loop it replaced.

Protocol: nonsym_matrix(200) (variant 4, the sides of tests/test_nonsym.py;
variant 1 for a restart whose ortho_cd needs a second pass), 5 roots,
n_max 5, max_dav 10, a guess from guess_evec; a restarting solve at tol
1e-12, a narrower one at n_targ 3, n_max 4; the ladder on the flagship's
similarity stores carried from JAX's bsr_nonsym_similarity(1024, 64, 4),
4 roots, n_max 6.  Inputs are made once in numpy and handed to both
packages.  Torch runs on one thread here, so the counts are reproducible;
the pinned counts are those of the eager loop before the restructuring on
this protocol.

Tolerances: eigenvalues within 1e-10 of JAX's, counts within the +-2 band
of tests/test_iteration_parity.py; the routes of the port against each
other bit for bit (they run the same arithmetic).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.problems import bsr_nonsym_similarity as j_bsr_nonsym
from diaglib_tpu.problems import dense_matvec as j_dense_matvec
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.problems import nonsym_matrix as j_nonsym_matrix
from diaglib_tpu.solvers import nonsym as j_nonsym
from diaglib_tpu.utils.guess import guess_evec
from diaglib_tpu_torch import (
    SolverOptions,
    nonsym,
    nonsym_finalize,
    nonsym_ladder,
    nonsym_pass,
    nonsym_seed_left,
)
from diaglib_tpu_torch.ops.bsr_sliced import sliced_store_from_arrays
from diaglib_tpu_torch.ops.bsr_sliced_sym import sym_store_from_arrays
from diaglib_tpu_torch.problems import (
    dense_matvec,
    diag_precnd,
    nonsym_similarity_ops,
)
from diaglib_tpu_torch.utils import graphs
from diaglib_tpu_torch.utils.guess import check_guess

nmod = importlib.import_module("diaglib_tpu_torch.solvers.nonsym")

N, N_WANT = 200, 5
BASE = dict(n_targ=N_WANT, n_max=N_WANT, max_iter=200, tol=1e-8,
            max_dav=10)
SHORT = {"vs": 1, "cd": 1, "shift": 0}
FIELDS = ("eig", "evec_r", "evec_l", "done", "rms_history_r",
          "max_history_r", "rms_history_l", "max_history_l", "eig_history")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _problem(variant):
    a = j_nonsym_matrix(N, jax.random.PRNGKey(1), variant=variant)
    guess = guess_evec(6, jax.random.PRNGKey(7), N, N_WANT,
                       diagonal=jnp.diagonal(a))
    return np.asarray(a), np.asarray(guess)


@pytest.fixture(scope="module")
def problems():
    return {4: _problem(4), 1: _problem(1)}


def _ops(a):
    ta = torch.from_numpy(a)
    return (dense_matvec(ta), dense_matvec(ta.T),
            diag_precnd(torch.diagonal(ta)))


def _solve(problems, case, route=None, budgets=None):
    side, kw, driver, variant = CASES[case]
    a, guess = problems[variant]
    opts = SolverOptions(**kw)
    with graphs._recording(route, budgets) as rec:
        res = nonsym(*_ops(a), torch.from_numpy(guess[:opts.n_max].copy()),
                     opts, side=side, driver=driver)
    return res, rec.solves


def _same(a, b):
    assert (a.ok, a.n_iter, a.n_matvec, a.ortho_ok) == \
        (b.ok, b.n_iter, b.n_matvec, b.ortho_ok)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# (side, options, driver, matrix variant) of each case
CASES = {
    "r": ("r", BASE, "auto", 4),
    "l": ("l", BASE, "auto", 4),
    "c": ("c", BASE, "auto", 4),
    "max_iter 3": ("c", dict(BASE, max_iter=3), "auto", 4),
    "restart": ("c", dict(BASE, tol=1e-12), "auto", 4),
    "narrow": ("c", dict(BASE, n_targ=3, n_max=4, tol=1e-10, max_dav=4),
               "auto", 4),
    "restart rerun": ("c", dict(BASE, tol=1e-12), "auto", 1),
    "device": ("c", BASE, "device", 4),
}
# (ok, n_iter, n_matvec) of the eager loop before the restructuring, on
# this module's protocol (one thread)
PINNED = {"r": (True, 9, 35), "l": (True, 9, 35), "c": (True, 16, 64),
          "max_iter 3": (False, 6, 30), "restart": (True, 23, 97),
          "narrow": (True, 17, 60), "restart rerun": (True, 38, 164),
          "device": (True, 16, 64)}


# ---- against the JAX package ----

@pytest.mark.parametrize("side", ["r", "l", "c"])
def test_unrolled_route_against_jax(problems, side):
    a, guess = problems[4]
    res, solves = _solve(problems, side, "unrolled")
    ja = jnp.asarray(a)
    ref = j_nonsym(j_dense_matvec(ja), j_dense_matvec(ja.T),
                   j_diag_precnd(jnp.diagonal(ja)), jnp.asarray(guess),
                   JOptions(**BASE), side=side, key=jax.random.PRNGKey(2),
                   driver="host")
    assert res.ok and bool(ref.ok) and res.ortho_ok
    np.testing.assert_allclose(res.eig[:N_WANT].numpy(),
                               np.asarray(ref.eig[:N_WANT]), rtol=0,
                               atol=1e-10)
    it_ref, mv_ref = int(ref.n_iter), int(ref.n_matvec)
    band = max(1, round(mv_ref * 2.5 / max(it_ref, 1)))
    assert abs(res.n_iter - it_ref) <= 2
    assert abs(res.n_matvec - mv_ref) <= band
    passes = 2 if side == "c" else 1
    assert [(r["solver"], r["route"]) for r in solves] == \
        [("nonsym", "unrolled")] * passes


# ---- against the eager loop it replaced ----

@pytest.mark.parametrize("case", list(CASES))
def test_routes_bit_equal_and_pinned(problems, case):
    """The eager route, the unrolled route with the default passes and the
    unrolled route at one pass a loop (every step 3 whose loops need more
    is run again eagerly) give the pinned counts and the same bits."""
    eager, solves = _solve(problems, case, "eager")
    assert (eager.ok, eager.n_iter, eager.n_matvec) == PINNED[case]
    assert solves[0]["passes"]["vs"] >= 1
    unrolled, solves = _solve(problems, case, "unrolled")
    _same(eager, unrolled)
    assert all(s["reruns"] == {"expand": 0, "restart": 0} for s in solves)
    short, solves = _solve(problems, case, "unrolled", SHORT)
    _same(eager, short)
    # the forced rare branch is counted: at one pass a loop nearly every
    # expansion needs its eager rerun
    assert sum(s["reruns"]["expand"] for s in solves) > 0


def test_restarts_and_their_forced_rerun(problems):
    """The restarting solves restart; the variant-1 restart's ortho_cd
    needs a second pass, so at one pass it is run again, and counted."""
    for case in ("restart", "restart rerun"):
        _, solves = _solve(problems, case, "unrolled")
        assert max(s["iterations"] for s in solves) > 10    # dim_dav
    _, solves = _solve(problems, "restart rerun", "unrolled", SHORT)
    assert solves[0]["reruns"]["restart"] == 1
    # the reruns' eager loops count their passes
    assert solves[0]["passes"]["cd"] >= 2
    _, solves = _solve(problems, "restart rerun", "eager")
    assert solves[0]["passes"]["cd"] >= 2


def test_an_iteration_run_again_homes_onto_the_same_vectors(problems,
                                                           monkeypatch):
    """An iteration run again after a rerun solves its reduced problem
    with the homing vectors it had the first time, not with those of the
    solve it undid."""
    calls = []
    solve = nmod._host_reduced_eig

    def recorded(g, ldu, n_sort, homing, copy_r, copy_l, *args, **kw):
        calls.append((ldu, n_sort, homing, copy_r.copy(), copy_l.copy()))
        return solve(g, ldu, n_sort, homing, copy_r, copy_l, *args, **kw)

    monkeypatch.setattr(nmod, "_host_reduced_eig", recorded)
    _, solves = _solve(problems, "c", "unrolled", SHORT)
    reruns = sum(s["reruns"]["expand"] for s in solves)
    again = [(a, b) for a, b in zip(calls, calls[1:]) if a[:2] == b[:2]]
    assert len(again) == reruns > 0
    for a, b in again:
        assert a[2] and b[2]
        assert np.array_equal(a[3], b[3]) and np.array_equal(a[4], b[4])


def test_nonconvergence_reports_not_ok(problems):
    res, solves = _solve(problems, "max_iter 3", "unrolled")
    assert not res.ok and res.n_iter == 6 and res.n_matvec == 30
    for h in (res.rms_history_r, res.rms_history_l):
        assert np.isinf(h[3:].numpy()).all()
    assert [s["iterations"] for s in solves] == [3, 3]


@pytest.mark.parametrize("route", ["eager", "unrolled", "short"])
def test_one_flag_read_an_iteration(problems, route):
    """The host reads the flags once an iteration through the one read
    function, and once more for each rerun of a rare branch."""
    budgets = SHORT if route == "short" else None
    before = graphs._read_flags.count
    res, solves = _solve(problems, "c", "unrolled" if budgets else route,
                         budgets)
    reruns = sum(sum(s["reruns"].values()) for s in solves)
    assert graphs._read_flags.count - before == res.n_iter + reruns
    assert sum(s["flag_reads"] for s in solves) == res.n_iter + reruns
    assert (reruns > 0) == (route == "short")


@pytest.mark.parametrize("route", ["eager", "unrolled"])
def test_a_step_run_last_is_settled(problems, route):
    """A pass whose last iteration ran a step 3 (max_iter ran out) reads
    that step's flags once more after the loop."""
    before = graphs._read_flags.count
    res, solves = _solve(problems, "max_iter 3", route)
    assert graphs._read_flags.count - before == res.n_iter + 2
    assert [s["flag_reads"] for s in solves] == [4, 4]


def test_pass_protocol_matches_consecutive(problems):
    """nonsym_pass, nonsym_seed_left and nonsym_finalize together give
    nonsym(side="c") exactly, on the steps."""
    a, guess = problems[4]
    mv, mvl, pc = _ops(a)
    opts = SolverOptions(**BASE)
    with graphs._recording("unrolled") as rec:
        ref = nonsym(mv, mvl, pc, torch.from_numpy(guess.copy()), opts,
                     side="c")
        r = nonsym_pass(mv, pc, torch.from_numpy(guess.copy()), opts,
                        use_left=False)
        gl, seed_ok = nonsym_seed_left(r.evec)
        l_ = nonsym_pass(mvl, pc, gl, opts, use_left=True)
        out = nonsym_finalize(r, l_, opts, seed_ok=seed_ok)
    assert len(rec.solves) == 4
    for f in dataclasses.fields(out):
        got, want = getattr(out, f.name), getattr(ref, f.name)
        if isinstance(want, torch.Tensor):
            assert torch.equal(got, want), f.name
        else:
            assert got == want, f.name


@pytest.mark.parametrize("branch", ["expand", "restart"])
def test_rerun_repeats_the_step_from_its_kept_inputs(problems, branch):
    """A step 3 run again (as after a rare branch) from the inputs it
    kept, with the eager loops, writes what it wrote the first time,
    though the next iteration's steps 1-2 overwrote the Ritz vectors,
    residuals and eigenvalues it read."""
    a, guess = problems[4]
    mv, _, pc = _ops(a)
    opts = SolverOptions(**BASE)
    st = nmod._NonsymIteration(mv, pc, check_guess(torch.from_numpy(guess)),
                               False, opts, N ** 0.5, graphs._UNROLL)
    copies = (np.zeros((st.lda_pad, 2 * N_WANT)),) * 2
    ldu, n_act = 0, N_WANT
    for i in range(3):
        st.matvec()
        copies = st.reduced(ldu + n_act, N_WANT if i == 0 else N_WANT +
                            n_act, i > 0, copies, False)
        st.ritz()
        if i < 2:
            st.expand()
            ldu, n_act = ldu + n_act, N_WANT - int(st.n_frozen)
    getattr(st, branch)()
    # what the step writes (the expansion leaves aspace to the next
    # matvec step)
    names = ("space", "ortho_ok", "ldu", "n_act", "finished3") + (
        ("aspace",) if branch == "restart" else ())
    once = {k: getattr(st, k).clone() for k in names}
    assert bool(st.finished3)
    st.matvec()
    fresh = branch == "restart"
    st.reduced(int(st.ldu + st.n_act), N_WANT + (0 if fresh else
                                                 int(st.n_act)),
               not fresh, copies, False)
    st.ritz()
    st.undo_ritz()
    st.rerun(branch)
    for k, v in once.items():
        assert torch.equal(getattr(st, k), v), k


def test_steps_read_nothing_from_the_device(problems, monkeypatch):
    """The steps themselves never turn a tensor into a Python value: every
    such read of the pass is the flag read or the reduced solve's read of
    the Gram matrix."""
    a, guess = problems[4]
    mv, _, pc = _ops(a)
    st = nmod._NonsymIteration(mv, pc, check_guess(torch.from_numpy(guess)),
                               False, SolverOptions(**BASE), N ** 0.5,
                               graphs._UNROLL)
    copies = (np.zeros((st.lda_pad, 2 * N_WANT)),) * 2
    st.matvec()
    copies = st.reduced(N_WANT, N_WANT, False, copies, False)

    def refuse(*_):
        raise AssertionError("a step read the device")

    for name in ("__bool__", "__int__", "__float__", "item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    st.ritz()
    st.expand()
    st.matvec()
    st.restart()


# ---- the ladder ----

@pytest.fixture(scope="module")
def stores():
    jstores, jdiag = j_bsr_nonsym(1024, 64, 4, jax.random.PRNGKey(5),
                                  t_scale=0.05)
    s, st, stt = jstores
    tstores = (sym_store_from_arrays(s, device="cpu"),
               sliced_store_from_arrays(st, device="cpu"),
               sliced_store_from_arrays(stt, device="cpu"))
    guess = np.asarray(guess_evec(6, jax.random.PRNGKey(2), 1024, 6,
                                  diagonal=jdiag))
    return tstores, guess


def _ladder(stores, route, driver="auto"):
    tstores, guess = stores
    d = tstores[0].diagonal
    with graphs._recording(route) as rec:
        res = nonsym_ladder(
            *nonsym_similarity_ops(tstores, dtype=torch.float32),
            diag_precnd(d.float()), *nonsym_similarity_ops(tstores),
            diag_precnd(d), torch.from_numpy(guess.copy()),
            SolverOptions(n_targ=4, n_max=6, max_iter=150, tol=1e-10,
                          max_dav=10),
            side="c", lo_tol=2e-6, lo_iter=60, driver=driver)
    return res, rec.solves


def test_ladder_pinned_and_bit_equal(stores):
    eager, _ = _ladder(stores, "eager")
    assert (eager.ok, eager.n_iter, eager.n_matvec) == (True, 29, 168)
    unrolled, solves = _ladder(stores, "unrolled")
    _same(eager, unrolled)
    # the float32 stage's pass, then the float64 stage's right and left
    # passes, each with its own steps
    assert [s["dtype"] for s in solves] == ["float32", "float64", "float64"]
    assert sum(s["iterations"] for s in solves) == unrolled.n_iter
    assert all(s["solver"] == "nonsym" for s in solves)


def test_captured_route_refused_without_a_card(problems):
    with pytest.raises(ValueError, match="captured route"):
        _solve(problems, "r", "graphs")
