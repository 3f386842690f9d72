"""The generalized Davidson slice of the port against the JAX package: the
B-metric ortho routines, the masked eigh / svd, ``gen_david`` on the
reference toy protocol and ``gen_david_ladder`` over symmetric sliced
stores carried over from JAX's ``bsr_gen_problem``.

Inputs are made once (numpy, or JAX's own generators) and handed to both
packages as numpy.  Tolerances: the deterministic ortho routines agree to
1e-12 relative; solver eigenvalues within 1e-10; (n_iter, n_matvec) within
the +-2 band of tests/test_iteration_parity.py around the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.ops.bsr_sliced_sym import sym_sliced_matvec as j_matvec
from diaglib_tpu.ortho import core as jcore
from diaglib_tpu.problems import bsr_gen_problem as j_bsr_gen_problem
from diaglib_tpu.problems import dense_matvec as j_dense_matvec
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.problems import metric_matrix as j_metric_matrix
from diaglib_tpu.problems import symm_matrix as j_symm_matrix
from diaglib_tpu.solvers import gen_david as j_gen_david
from diaglib_tpu.solvers import gen_david_ladder as j_gen_david_ladder
from diaglib_tpu.utils import masking as jmask
from diaglib_tpu.utils.guess import guess_evec
from diaglib_tpu_torch import (
    SolverOptions,
    gen_david,
    gen_david_ladder,
    profiling,
)
from diaglib_tpu_torch.ops.bsr_sliced_sym import (
    sliced_matvec_any,
    sym_store_from_arrays,
)
from diaglib_tpu_torch.ortho import core as tcore
from diaglib_tpu_torch.problems import dense_matvec, diag_precnd
from diaglib_tpu_torch.utils import masking as tmask

N, N_WANT, N_EIG = 1000, 10, 15
TOY = dict(n_targ=N_WANT, n_max=N_EIG, max_iter=100, tol=1e-8, max_dav=20)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * max(np.max(np.abs(want)), 1.0))


# ---- masked eigh / svd ----

MASK = np.array([1, 1, 1, 1, 0, 0, 1, 1, 0, 1, 1, 1], bool)   # [X|P|W]-like


def _sym(seed, k=12):
    a = np.random.default_rng(seed).standard_normal((k, k))
    return a + a.T


def test_masked_eigh_matches_reference():
    a = _sym(0)
    w, v = tmask.masked_eigh(_t(a), _t(MASK))
    jw, jv = jmask.masked_eigh(jnp.asarray(a), jnp.asarray(MASK))
    g = int(MASK.sum())
    _close(w, jw)              # genuine values ascending, then the pad
    assert float(w[g:].min()) > float(w[:g].max())
    # genuine eigenvectors: zero on masked rows (to LAPACK's rounding: the
    # masked rows are not a trailing block), equal up to sign
    v, jv = v.numpy()[:, :g], np.asarray(jv)[:, :g]
    assert np.max(np.abs(v[~MASK])) < 1e-14
    sign = np.sign(np.sum(v * jv, axis=0))
    np.testing.assert_allclose(v * sign, jv, rtol=0, atol=1e-12)


def test_masked_svd_matches_reference():
    a = np.random.default_rng(1).standard_normal((12, 12))
    u, s, vt = tmask.masked_svd(_t(a), _t(MASK))
    ju, js, jvt = jmask.masked_svd(jnp.asarray(a), jnp.asarray(MASK))
    g = int(MASK.sum())
    _close(s[:g], np.asarray(js)[:g])
    np.testing.assert_allclose(s[:g].numpy(), np.linalg.svd(
        a[np.ix_(MASK, MASK)], compute_uv=False), rtol=0, atol=1e-12)
    u, ju = u.numpy()[:, :g], np.asarray(ju)[:, :g]
    vt, jvt = vt.numpy()[:g], np.asarray(jvt)[:g]
    sign = np.sign(np.sum(u * ju, axis=0))
    np.testing.assert_allclose(u * sign, ju, rtol=0, atol=1e-12)
    np.testing.assert_allclose(vt * sign[:, None], jvt, rtol=0, atol=1e-12)


# ---- B-metric ortho ----

def _metric(n, seed):
    m = np.random.default_rng(seed).uniform(size=(n, n))
    return m.T @ m / n + np.eye(n)


@pytest.fixture(scope="module")
def metric():
    return _metric(200, 2)


def test_b_ortho_matches_reference(metric):
    u = np.random.default_rng(3).standard_normal((6, 200))
    u[2] *= 1e6                           # rows of very different norms
    mask = np.array([1, 1, 1, 1, 1, 0], bool)
    u[~mask] = 0.0
    bu = u @ metric.T
    got = tcore.b_ortho(_t(u), _t(bu), _t(mask))
    want = jcore.b_ortho(jnp.asarray(u), jnp.asarray(bu), jnp.asarray(mask))
    assert got[2] is True and bool(want[2])
    _close(got[0], want[0])
    _close(got[1], want[1])
    over = got[0].numpy() @ got[1].numpy().T
    np.testing.assert_allclose(over, np.diag(mask.astype(float)), atol=1e-12)


def test_b_ortho_svd_rescue_matches_reference(metric):
    # a valid zero row: the metric is singular, the Cholesky fails and the
    # SVD branch (relative cut) drops that direction in both packages
    u = np.random.default_rng(4).standard_normal((5, 200))
    u[3] = 0.0
    bu = u @ metric.T
    got = tcore.b_ortho(_t(u), _t(bu))
    want = jcore.b_ortho(jnp.asarray(u), jnp.asarray(bu))
    assert got[2] is False and not bool(want[2])
    _close(got[0], want[0], rel=1e-10)
    _close(got[1], want[1], rel=1e-10)
    direct = tcore.b_ortho_svd(_t(u), _t(bu))
    jdirect = jcore.b_ortho_svd(jnp.asarray(u), jnp.asarray(bu))
    _close(direct[0], jdirect[0], rel=1e-10)


def test_b_ortho_vs_x_matches_reference(metric):
    r = np.random.default_rng(5)
    x0 = r.standard_normal((8, 200))
    x, bx, _ = jcore.b_ortho(jnp.asarray(x0), jnp.asarray(x0 @ metric.T))
    x, bx = np.asarray(x), np.asarray(bx)
    xmask = np.arange(8) < 6
    umask = np.arange(5) < 4
    u = r.standard_normal((5, 200))
    u[~umask] = 0.0
    got, done = tcore.b_ortho_vs_x(_t(x), _t(bx), _t(u), _t(xmask),
                                   _t(umask))
    want, jdone = jcore.b_ortho_vs_x(jnp.asarray(x), jnp.asarray(bx),
                                     jnp.asarray(u), jnp.asarray(xmask),
                                     jnp.asarray(umask))
    assert done and bool(jdone)
    _close(got, want)
    # B-orthogonal to the valid x rows
    assert np.max(np.abs(got.numpy() @ bx[xmask].T)) < 1e-12


# ---- the toy protocol ----

@pytest.fixture(scope="module")
def toy():
    a = np.asarray(j_symm_matrix(N))
    diag = np.diag(a).copy()
    guess = np.asarray(guess_evec(4, jax.random.PRNGKey(1), N, N_EIG,
                                  diagonal=jnp.asarray(diag)))
    s = np.asarray(j_metric_matrix(N, jax.random.PRNGKey(1)))
    return a, diag, guess, s


def _band(res, it_exp, mv_exp):
    band = max(1, round(mv_exp * 2.5 / it_exp))
    assert abs(res.n_iter - it_exp) <= 2
    assert abs(res.n_matvec - mv_exp) <= band


def test_gen_david_toy_protocol(toy):
    a, diag, guess, s = toy
    res = gen_david(dense_matvec(_t(a)), diag_precnd(_t(diag)),
                    dense_matvec(_t(s)), _t(guess), SolverOptions(**TOY))
    ref = j_gen_david(j_dense_matvec(jnp.asarray(a)),
                      j_diag_precnd(jnp.asarray(diag)),
                      j_dense_matvec(jnp.asarray(s)), jnp.asarray(guess),
                      JOptions(**TOY), key=jax.random.PRNGKey(1))
    assert res.ok and bool(ref.ok) and res.ortho_ok
    np.testing.assert_allclose(res.eig[:N_WANT].numpy(),
                               np.asarray(ref.eig[:N_WANT]), rtol=0,
                               atol=1e-10)
    _band(res, 10, 133)                   # geneig/gen_david
    # the dense pencil, to the protocol's residual tolerance
    w = scipy.linalg.eigh(a, s, eigvals_only=True)[:N_WANT]
    np.testing.assert_allclose(res.eig[:N_WANT].numpy(), w, rtol=0,
                               atol=TOY["tol"])
    ev = res.evec[:N_WANT].numpy()
    np.testing.assert_allclose(ev @ s @ ev.T, np.eye(N_WANT), atol=1e-10)


def test_gen_david_nonconvergence(toy):
    a, diag, guess, s = toy
    opts = dict(TOY, max_iter=3)
    res = gen_david(dense_matvec(_t(a)), diag_precnd(_t(diag)),
                    dense_matvec(_t(s)), _t(guess), SolverOptions(**opts))
    assert not res.ok
    assert res.n_iter == 3 and res.n_matvec == 3 * N_EIG


def test_gen_david_restart_path(toy):
    a, diag, guess, s = toy
    opts = dict(n_targ=4, n_max=6, max_iter=150, tol=1e-9, max_dav=10)
    res = gen_david(dense_matvec(_t(a)), diag_precnd(_t(diag)),
                    dense_matvec(_t(s)), _t(guess[:6]),
                    SolverOptions(**opts))
    assert res.ok and res.n_iter > SolverOptions(**opts).dim_dav
    w = scipy.linalg.eigh(a, s, eigvals_only=True)[:4]
    np.testing.assert_allclose(res.eig[:4].numpy(), w, rtol=0, atol=1e-9)


# ---- the generalized ladder over carried sliced stores ----

def test_gen_david_ladder_matches_reference():
    ja, jb = j_bsr_gen_problem(256, 32, 3, jax.random.PRNGKey(0))
    ta, tb = (sym_store_from_arrays(ja, device="cpu"),
              sym_store_from_arrays(jb, device="cpu"))
    for js, ts in ((ja, ta), (jb, tb)):
        for f in dataclasses.fields(js):
            want = getattr(js, f.name)
            got = getattr(ts, f.name)
            if not isinstance(want, int):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kw = dict(n_targ=4, n_max=8, max_iter=150, tol=1e-10, max_dav=10)
    guess = np.random.default_rng(8).uniform(-0.5, 0.5, (8, 256))
    f32 = torch.float32
    with profiling.solve_log() as log:
        res = gen_david_ladder(
            sliced_matvec_any(ta, dtype=f32),
            diag_precnd(ta.diagonal.to(f32)),
            sliced_matvec_any(tb, dtype=f32),
            sliced_matvec_any(ta), diag_precnd(ta.diagonal),
            sliced_matvec_any(tb), _t(guess), SolverOptions(**kw),
            lo_tol=2e-6, lo_iter=15)
    # the JAX ladder has no stall exit: the float32 stage ends without it
    assert "stall" not in [r["end"] for r in log.records]
    ref = j_gen_david_ladder(
        j_matvec(ja, dtype=jnp.float32, interpret=True),
        j_diag_precnd(ja.diagonal.astype(jnp.float32)),
        j_matvec(jb, dtype=jnp.float32, interpret=True),
        j_matvec(ja, interpret=True), j_diag_precnd(ja.diagonal),
        j_matvec(jb, interpret=True), jnp.asarray(guess), JOptions(**kw),
        lo_tol=2e-6, lo_iter=15, key=jax.random.PRNGKey(1))
    assert res.ok and bool(ref.ok) and res.ortho_ok
    np.testing.assert_allclose(res.eig[:4].numpy(), np.asarray(ref.eig[:4]),
                               rtol=0, atol=1e-10)
    assert abs(res.n_iter - int(ref.n_iter)) <= 2
    # against the dense pencil of the stores' own operators
    eye = torch.eye(256, dtype=torch.float64)
    da = sliced_matvec_any(ta)(eye).numpy()
    db = sliced_matvec_any(tb)(eye).numpy()
    w = scipy.linalg.eigh(0.5 * (da + da.T), 0.5 * (db + db.T),
                          eigvals_only=True)[:4]
    np.testing.assert_allclose(res.eig[:4].numpy(), w, rtol=0, atol=1e-9)
    ev = res.evec[:4].numpy()
    r = ev @ da.T - res.eig[:4, None].numpy() * (ev @ db.T)
    assert np.max(np.linalg.norm(r, axis=1)) / np.sqrt(256) < 1e-10


def test_sliced_matvec_any_refuses_the_general_store():
    """Since kernel K5 is ported the general store is served (its matvec
    equals sliced_bsr_matvec's); only an object that is no sliced store is
    refused."""
    from diaglib_tpu_torch.ops.bsr import random_bsr_spd
    from diaglib_tpu_torch.ops.bsr_sliced import slice_bsr, sliced_bsr_matvec

    store = slice_bsr(random_bsr_spd(256, 64, 3, seed=1, device="cpu"))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 256)))
    assert torch.equal(sliced_matvec_any(store)(x),
                       sliced_bsr_matvec(store)(x))
    with pytest.raises(TypeError, match="not a sliced store"):
        sliced_matvec_any(object())
