"""The Casida iterations (``caslr`` algorithms 0 and 1, ``caslr_eff``) as
steps over fixed device state (the captured route's logic, run on the CPU
without capture) against the JAX package and against the eager loops they
replaced.

Protocol: tests/test_torch_caslr.py's general Casida blocks
(``casida_blocks(150)`` made by JAX from threefry keys and its guess by
``guess_evec``, handed over as numpy), 5 roots, n_max 10, tol 1e-8; the
restart path at n_targ 3, n_max 4, tol 1e-10 (more iterations than
dim_dav = 10, so the spaces are collapsed many times); the ladders on the
port's bsr_casida_tdscf(256, 8, 2) pair, 2 roots, n_max 4, lo_iter 60.
Torch runs on one thread here, so the counts are reproducible; the pinned
counts are those of the eager loops before the restructuring on this
protocol.

Tolerances: eigenvalues within 1e-10 of JAX's, iterations within +-2 and
matvecs within the band of tests/test_iteration_parity.py (+-2.5
iterations' worth); the routes of the port against each other bit for bit
(they run the same arithmetic).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.problems import casida_blocks as j_casida_blocks
from diaglib_tpu.problems import dense_matvec as j_dense_matvec
from diaglib_tpu.problems import lrprec_eff as j_lrprec_eff
from diaglib_tpu.problems import lrprec_std as j_lrprec_std
from diaglib_tpu.solvers import caslr as j_caslr
from diaglib_tpu.solvers import caslr_eff as j_caslr_eff
from diaglib_tpu.utils.guess import guess_evec
from diaglib_tpu_torch import (
    SolverOptions,
    caslr,
    caslr_eff,
    caslr_eff_ladder,
    caslr_ladder,
)
from diaglib_tpu_torch.problems import (
    bsr_casida_tdscf,
    casida_tdscf_ops,
    dense_matvec,
    lrprec_eff,
    lrprec_std,
)
from diaglib_tpu_torch.utils import graphs

cmod = importlib.import_module("diaglib_tpu_torch.solvers.caslr")

N, N_WANT, N_EIG = 150, 5, 10
TOY = dict(n_targ=N_WANT, n_max=N_EIG, max_iter=100, tol=1e-8, max_dav=10)
RESTART = dict(n_targ=3, n_max=4, max_iter=150, tol=1e-10, max_dav=10)
LADDER = dict(n_targ=2, n_max=4, max_iter=150, tol=1e-10, max_dav=10)
PATHS = ["caslr0", "caslr1", "caslr_eff"]
SHORT = {"vs": 1, "cd": 1, "shift": 0}
FIELDS = ("eig", "evec", "done", "rms_history", "max_history",
          "eig_history")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # torch's CPU threads and XLA's contend in one process
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def blocks():
    """JAX's general Casida blocks and strategy-4 guess as numpy."""
    blk = {k: np.asarray(v) for k, v in
           j_casida_blocks(N, jax.random.PRNGKey(17), tdscf=False).items()}
    diag = np.diagonal(blk["aa"]) - np.diagonal(blk["sigma"])
    guess = np.asarray(guess_evec(4, jax.random.PRNGKey(3), 2 * N, N_EIG,
                                  diagonal=jnp.asarray(diag)))
    return blk, guess


def _ops(blk, path):
    ops = {k: dense_matvec(_t(blk[k[:3]])) for k in
           ("apbmul", "ambmul", "spdmul", "smdmul")}
    aa, sg = _t(np.diagonal(blk["aa"])), _t(np.diagonal(blk["sigma"]))
    ops["lrprec"] = (lrprec_eff if path == "caslr_eff" else lrprec_std)(
        aa, sg)
    return ops


def _solve(blocks, path, opts, route=None, budgets=None):
    blk, guess = blocks
    ops = _ops(blk, path)
    gs = _t(guess[:opts["n_max"]])
    with graphs._recording(route, budgets) as rec:
        if path == "caslr_eff":
            res = caslr_eff(evec_guess=gs, options=SolverOptions(**opts),
                            **ops)
        else:
            res = caslr(evec_guess=gs, options=SolverOptions(**opts),
                        algorithm=int(path[-1]), **ops)
    return res, rec.solves


def _same(a, b):
    assert (a.ok, a.n_iter, a.n_matvec, a.ortho_ok) == \
        (b.ok, b.n_iter, b.n_matvec, b.ortho_ok)
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---- against the JAX package ----

@pytest.mark.parametrize("path", PATHS)
def test_unrolled_route_against_jax(blocks, path):
    blk, guess = blocks
    res, solves = _solve(blocks, path, TOY, "unrolled")
    ops = {k: j_dense_matvec(jnp.asarray(blk[k[:3]])) for k in
           ("apbmul", "ambmul", "spdmul", "smdmul")}
    aa = jnp.asarray(np.diagonal(blk["aa"]))
    sg = jnp.asarray(np.diagonal(blk["sigma"]))
    if path == "caslr_eff":
        ref = j_caslr_eff(lrprec=j_lrprec_eff(aa, sg), evec_guess=guess,
                          options=JOptions(**TOY), **ops)
    else:
        ref = j_caslr(lrprec=j_lrprec_std(aa, sg), evec_guess=guess,
                      options=JOptions(**TOY), algorithm=int(path[-1]),
                      **ops)
    assert res.ok and bool(ref.ok) and res.ortho_ok
    np.testing.assert_allclose(res.eig[:N_WANT].numpy(),
                               np.asarray(ref.eig[:N_WANT]), rtol=0,
                               atol=1e-10)
    assert abs(res.n_iter - int(ref.n_iter)) <= 2
    band = max(1, round(int(ref.n_matvec) * 2.5 / max(int(ref.n_iter), 1)))
    assert abs(res.n_matvec - int(ref.n_matvec)) <= band
    name = "caslr_eff" if path == "caslr_eff" else "caslr"
    assert [(r["solver"], r["route"]) for r in solves] == [
        (name, "unrolled")]


# ---- against the eager loops they replaced ----

# (ok, n_iter, n_matvec) of the eager loops before the restructuring, on
# this module's protocol (one thread)
PINNED = {
    ("caslr0", "toy"): (True, 18, 648), ("caslr1", "toy"): (True, 18, 648),
    ("caslr_eff", "toy"): (True, 18, 344),
    ("caslr0", "restart"): (True, 98, 1088),
    ("caslr1", "restart"): (True, 67, 848),
    ("caslr_eff", "restart"): (True, 127, 674),
    ("caslr0", "max_iter 3"): (False, 3, 120),
    ("caslr1", "max_iter 3"): (False, 3, 120),
    ("caslr_eff", "max_iter 3"): (False, 3, 80),
}
OPTS = {"toy": TOY, "restart": RESTART, "max_iter 3": dict(TOY, max_iter=3)}


@pytest.mark.parametrize("case", list(OPTS))
@pytest.mark.parametrize("path", PATHS)
def test_routes_bit_equal_and_pinned(blocks, path, case):
    """The eager route, the unrolled route with the default passes and the
    unrolled route at one pass a loop (every expand or restart whose loops
    need more is run again eagerly) give the pinned counts and the same
    bits."""
    opts = OPTS[case]
    eager, solves = _solve(blocks, path, opts, "eager")
    assert (eager.ok, eager.n_iter, eager.n_matvec) == PINNED[path, case]
    assert solves[0]["passes"]["vs"] >= 1
    unrolled, solves = _solve(blocks, path, opts, "unrolled")
    _same(eager, unrolled)
    assert solves[0]["reruns"] == {"expand": 0, "restart": 0}
    short, solves = _solve(blocks, path, opts, "unrolled", SHORT)
    _same(eager, short)
    # the forced rare branch is counted (caslr_eff's restart has no
    # refinement loop: its metric Cholesky did not fail)
    if eager.n_iter > 3:
        assert solves[0]["reruns"]["expand"] > 0
    if case == "restart":
        assert (solves[0]["reruns"]["restart"] > 0) == (path != "caslr_eff")


@pytest.mark.parametrize("path", PATHS)
def test_restart_path_restarts(blocks, path):
    res, solves = _solve(blocks, path, RESTART, "unrolled")
    # past dim_dav iterations the spaces were collapsed
    assert res.ok and res.n_iter > SolverOptions(**RESTART).dim_dav
    assert solves[0]["iterations"] == res.n_iter
    assert solves[0]["reruns"] == {"expand": 0, "restart": 0}


@pytest.mark.parametrize("path", PATHS)
def test_nonconvergence_reports_not_ok(blocks, path):
    res, _ = _solve(blocks, path, dict(TOY, max_iter=3), "unrolled")
    assert not res.ok and res.n_iter == 3
    assert np.isinf(res.rms_history[3:].numpy()).all()


@pytest.mark.parametrize("route", ["eager", "unrolled", "short"])
def test_one_flag_read_an_iteration(blocks, route):
    """The host reads the device once an iteration through the one read
    function, and once more for each rerun of a rare branch."""
    budgets = SHORT if route == "short" else None
    before = graphs._read_flags.count
    res, solves = _solve(blocks, "caslr_eff", RESTART,
                         "unrolled" if budgets else route, budgets)
    reruns = sum(solves[0]["reruns"].values())
    assert graphs._read_flags.count - before == res.n_iter + reruns
    assert solves[0]["flag_reads"] == res.n_iter + reruns
    assert (reruns > 0) == (route == "short")


@pytest.mark.parametrize("branch", ["expand", "restart"])
@pytest.mark.parametrize("path", PATHS)
def test_branch_reruns_from_its_kept_inputs(blocks, path, branch):
    """An expand or restart run again (as after a rare branch) from the
    inputs it kept, with the eager loops, writes what the unrolled step
    wrote when its loops finished, though the next iteration's steps ran
    between."""
    blk, guess = blocks
    ops = _ops(blk, path)
    opts = SolverOptions(**TOY)
    algorithm = None if path == "caslr_eff" else int(path[-1])
    st, _ = cmod._start(
        tuple(ops[k] for k in ("apbmul", "ambmul", "spdmul", "smdmul",
                               "lrprec")),
        _t(guess), opts, algorithm, None, lambda n: n ** 0.5, graphs._UNROLL)
    for step in range(3):       # two expansions, then the branch
        st.matvec()
        st.reduced(int(st.ldu_new), "device")
        st.ritz()
        getattr(st, "expand" if step < 2 else branch)()
    # what the branch writes: the spaces, and the operator images it makes
    # (caslr_eff's metric images) or clears (a restart's)
    names = ["vp", "vm", "ortho_ok", "ldu", "n_act", "finished3"]
    if branch == "restart":
        names += ["lvp", "lvm", "bvp", "bvm"]
    elif path == "caslr_eff":
        names += ["lvp", "lvm"]
    once = {k: getattr(st, k).clone() for k in names}
    assert bool(st.finished3)
    # the next iteration's steps 1-2 write the images' next rows
    st.matvec()
    st.reduced(int(st.ldu_new), "device")
    st.ritz()
    st.undo_ritz()
    st.rerun(branch)
    for k, v in once.items():
        assert torch.equal(getattr(st, k), v), k


# ---- the ladders ----

@pytest.fixture(scope="module")
def pair():
    _, _, _, (apb, amb) = bsr_casida_tdscf(256, 8, 2, seed=0, device="cpu")
    return apb, amb


def _ladder(pair, run, route):
    apb, amb = pair
    z = torch.zeros((4, 512), dtype=torch.float64)
    opts, kw = SolverOptions(**LADDER), dict(lo_tol=2e-6, lo_iter=60)
    with graphs._recording(route) as rec:
        if run == "caslr_eff":
            res = caslr_eff_ladder(
                *casida_tdscf_ops(apb, amb), z, opts,
                generator=torch.Generator().manual_seed(1), **kw)
        else:
            res = caslr_ladder(
                *casida_tdscf_ops(apb, amb, prec="std"), z, opts,
                algorithm=int(run[-1]),
                generator=torch.Generator().manual_seed(1), **kw)
    return res, rec.solves


@pytest.mark.parametrize("run,pinned", [("caslr_eff", (True, 54, 446)),
                                        ("caslr0", (True, 43, 684)),
                                        ("caslr1", (True, 45, 716))])
def test_ladders_pinned_and_bit_equal(pair, run, pinned):
    eager, _ = _ladder(pair, run, "eager")
    assert (eager.ok, eager.n_iter, eager.n_matvec) == pinned
    unrolled, solves = _ladder(pair, run, "unrolled")
    _same(eager, unrolled)
    # both stages take the route, each with its own steps
    assert [s["dtype"] for s in solves] == ["float32", "float64"]
    assert sum(s["iterations"] for s in solves) == unrolled.n_iter


def test_captured_route_refused_without_a_card(blocks):
    with pytest.raises(ValueError, match="captured route"):
        _solve(blocks, "caslr_eff", TOY, "graphs")
