"""The two-sided nonsymmetric Davidson of the PyTorch port against the JAX
package: the host reduced solve (dgeev, parking sort, root homing), the
biorthogonalization routines, ``nonsym`` on the reference toy protocol and
on the sides of tests/test_nonsym.py, and the public pass protocol.

Inputs are made once (numpy, or JAX's own generators) and handed to both
packages as numpy.  Tolerances: the host reduced solve is the same numpy
code and must agree bit for bit; the ortho routines to 1e-12 relative;
solver eigenvalues within 1e-10 of JAX's; (n_iter, n_matvec) within the
+-2 band of tests/test_iteration_parity.py around the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.ortho import core as jcore
from diaglib_tpu.problems import dense_matvec as j_dense_matvec
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.problems import nonsym_matrix as j_nonsym_matrix
from diaglib_tpu.solvers import nonsym as j_nonsym
from diaglib_tpu.solvers.nonsym import _host_reduced_eig as j_host_eig
from diaglib_tpu.utils.guess import guess_evec
from diaglib_tpu_torch import (
    SolverOptions,
    nonsym,
    nonsym_finalize,
    nonsym_pass,
    nonsym_seed_left,
)
from diaglib_tpu_torch.ortho import core as tcore
from diaglib_tpu_torch.problems import dense_matvec, diag_precnd
from diaglib_tpu_torch.solvers.nonsym import _host_reduced_eig

ITER_BAND = 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _counts_close(res, it_exp, mv_exp):
    band = max(1, round(mv_exp * (ITER_BAND + 0.5) / max(it_exp, 1)))
    assert abs(res.n_iter - it_exp) <= ITER_BAND, (res.n_iter, it_exp)
    assert abs(res.n_matvec - mv_exp) <= band, (res.n_matvec, mv_exp)


# ---- the host reduced solve ----

def _reduced_cases():
    rng = np.random.default_rng(11)
    L, n_max = 24, 4
    g = np.zeros((L, L))
    a = 0.2 * rng.standard_normal((14, 14)) + np.diag(2.0 * np.arange(14.0))
    g[:14, :14] = a
    # complex pairs: one inside the real roots' range, two above it
    c = np.zeros((L, L))
    blocks = [np.array([[re, 2.0], [-2.0, re]]) for re in (4.5, 20.0, 21.0)]
    d = scipy.linalg.block_diag(np.diag(np.arange(6.0) + 3.0), *blocks)
    q = np.linalg.qr(rng.standard_normal((12, 12)))[0]
    c[:12, :12] = q @ d @ q.T
    # homing: the previous vectors of a slightly perturbed matrix, with
    # two roots swapped so that the max-overlap permutation moves them
    g2 = g.copy()
    g2[:14, :14] += 1e-3 * rng.standard_normal((14, 14))
    _, vr0, vl0, _ = _host_reduced_eig(g2, 14, n_max + 2, False, None,
                                       None, n_max)
    copy_r = vr0[:, :2 * n_max].copy()
    copy_l = vl0[:, :2 * n_max].copy()
    copy_r[:, [0, 1]] = copy_r[:, [1, 0]]
    copy_l[:, [0, 1]] = copy_l[:, [1, 0]]
    return {
        "fresh": (g, 14, n_max, False, None, None, n_max),
        "complex_pairs": (c, 12, n_max, False, None, None, n_max),
        "homing": (g, 14, n_max + 2, True, copy_r, copy_l, n_max),
        "homing_f32": (g, 14, n_max + 2, True, copy_r, copy_l, n_max,
                       np.float32),
    }


@pytest.mark.parametrize("case", ["fresh", "complex_pairs", "homing",
                                  "homing_f32"])
def test_host_reduced_eig_equals_the_reference(case):
    args = _reduced_cases()[case]
    got = _host_reduced_eig(*args)
    want = j_host_eig(*args)
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    wr, vr = got[0], got[1]
    if case == "complex_pairs":
        # one root of the inner pair is parked in the last valid slot, its
        # conjugate takes the next slot of the window (the reference's rule)
        assert bool(got[3])
        np.testing.assert_allclose(wr[[0, 1, 2, 11]], [3.0, 4.0, 4.5, 4.5],
                                   atol=1e-12)
    if case.startswith("homing"):
        # the swap in the previous vectors is followed
        plain = _host_reduced_eig(*args[:3], False, None, None, *args[6:])
        np.testing.assert_array_equal(wr[[0, 1]], plain[0][[1, 0]])


# ---- biorthogonalization ----

def _pair(seed, k=5, n=60):
    rng = np.random.default_rng(seed)
    ur = rng.standard_normal((k, n))
    ul = ur + 0.3 * rng.standard_normal((k, n))
    return ul, ur


def _close(got, want, rel=1e-12):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * max(np.max(np.abs(want)), 1.0))


@pytest.mark.parametrize("masked", [False, True])
def test_svd_biortho(masked):
    ul, ur = _pair(1)
    # a prefix mask, as the solvers give (the SVD compacts the genuine
    # triplets to the leading rows)
    mask = np.array([1, 1, 1, 1, 0], bool) if masked else None
    if masked:
        ul[4] = ur[4] = 0.0
    jl, jr = jcore.svd_biortho(jnp.asarray(ul), jnp.asarray(ur),
                               None if mask is None else jnp.asarray(mask))
    tl, tr = tcore.svd_biortho(_t(ul), _t(ur),
                               None if mask is None else _t(mask))
    # the SVD's singular vectors are unique up to a sign per pair; the
    # biorthonormal pair is then (+-l, +-r) with matching signs
    sign = np.sign(np.sum(tl.numpy() * np.asarray(jl), axis=1))
    sign[sign == 0] = 1.0
    _close(tl * _t(sign)[:, None], jl)
    _close(tr * _t(sign)[:, None], jr)
    m = np.ones(5, bool) if mask is None else mask
    g = (tl @ tr.T).numpy()
    np.testing.assert_allclose(g[np.ix_(m, m)], np.eye(int(m.sum())),
                               atol=1e-12)


def test_biortho_vs_x():
    xl, xr = _pair(2, k=4)
    xl, xr = (np.asarray(v) for v in jcore.svd_biortho(jnp.asarray(xl),
                                                       jnp.asarray(xr)))
    ul, ur = _pair(3, k=3)
    jl, jr, jdone = jcore.biortho_vs_x(*(jnp.asarray(v)
                                         for v in (xl, xr, ul, ur)))
    tl, tr, tdone = tcore.biortho_vs_x(*(_t(v) for v in (xl, xr, ul, ur)))
    assert tdone and bool(jdone)
    sign = np.sign(np.sum(tl.numpy() * np.asarray(jl), axis=1))
    _close(tl * _t(sign)[:, None], jl, rel=1e-10)
    _close(tr * _t(sign)[:, None], jr, rel=1e-10)
    np.testing.assert_allclose((tl @ _t(xr).T).numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose((tr @ _t(xl).T).numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose((tl @ tr.T).numpy(), np.eye(3), atol=1e-12)


# ---- the toy protocol (main.f90's test_nonsym, side 'c') ----

N, N_WANT = 1000, 10
TOY = dict(n_targ=N_WANT, n_max=N_WANT, max_iter=100, tol=1e-8, max_dav=20)


@pytest.fixture(scope="module")
def toy():
    a = j_nonsym_matrix(N, jax.random.PRNGKey(1), variant=4)
    diag = jnp.diagonal(a)
    guess = guess_evec(6, jax.random.PRNGKey(1), N, N_WANT, diagonal=diag)
    ref = j_nonsym(j_dense_matvec(a), j_dense_matvec(a.T), j_diag_precnd(diag),
                   guess, JOptions(**TOY), side="c",
                   key=jax.random.PRNGKey(1), driver="jit")
    return np.asarray(a), np.asarray(guess), ref


def test_toy_protocol_consecutive(toy):
    a, guess, ref = toy
    ta = _t(a)
    res = nonsym(dense_matvec(ta), dense_matvec(ta.T),
                 diag_precnd(torch.diagonal(ta)), _t(guess),
                 SolverOptions(**TOY), side="c")
    assert res.ok and bool(ref.ok) and res.ortho_ok
    np.testing.assert_allclose(res.eig[:N_WANT].numpy(),
                               np.asarray(ref.eig[:N_WANT]), rtol=0,
                               atol=1e-10)
    _counts_close(res, 17, 137)                      # the reference's count
    assert abs(res.n_iter - int(ref.n_iter)) <= ITER_BAND
    g = (res.evec_l @ res.evec_r.T).numpy()
    np.testing.assert_allclose(g, np.eye(N_WANT), atol=1e-10)


def test_pass_protocol_matches_consecutive(toy):
    a, guess, _ = toy
    ta = _t(a)
    mv, mvl, pc = (dense_matvec(ta), dense_matvec(ta.T),
                   diag_precnd(torch.diagonal(ta)))
    opts = SolverOptions(**TOY)
    ref = nonsym(mv, mvl, pc, _t(guess), opts, side="c")
    r = nonsym_pass(mv, pc, _t(guess), opts, use_left=False)
    gl, seed_ok = nonsym_seed_left(r.evec)
    l_ = nonsym_pass(mvl, pc, gl, opts, use_left=True)
    out = nonsym_finalize(r, l_, opts, seed_ok=seed_ok)
    for f in dataclasses.fields(out):
        got, want = getattr(out, f.name), getattr(ref, f.name)
        if isinstance(want, torch.Tensor):
            assert torch.equal(got, want), f.name
        else:
            assert got == want, f.name


# ---- sides at n = 200 (tests/test_nonsym.py) ----

N2, N2_WANT = 200, 5


@pytest.fixture(scope="module")
def small():
    a = j_nonsym_matrix(N2, jax.random.PRNGKey(1), variant=4)
    w, vl, vr = scipy.linalg.eig(np.asarray(a), left=True, right=True)
    order = np.argsort(w.real)
    guess = guess_evec(6, jax.random.PRNGKey(7), N2, N2_WANT,
                       diagonal=jnp.diagonal(a))
    return (np.asarray(a), w[order].real, vr[:, order].real,
            vl[:, order].real, np.asarray(guess))


def _small_run(small, side, **kw):
    a, _, _, _, guess = small
    ta = _t(a)
    opts = SolverOptions(**{**dict(n_targ=N2_WANT, n_max=N2_WANT,
                                   max_iter=200, tol=1e-8, max_dav=10),
                            **kw})
    return nonsym(dense_matvec(ta), dense_matvec(ta.T),
                  diag_precnd(torch.diagonal(ta)), _t(guess), opts,
                  side=side)


@pytest.mark.parametrize("side", ["r", "l", "c", "s"])
def test_sides(small, side):
    a, w, vr, vl, _ = small
    res = _small_run(small, side)
    assert res.ok
    np.testing.assert_allclose(res.eig[:N2_WANT].numpy(), w[:N2_WANT],
                               rtol=0, atol=1e-7)
    for i in range(N2_WANT):
        for vec, ref, on in ((res.evec_r, vr, side != "l"),
                             (res.evec_l, vl, side != "r")):
            v = vec[i].numpy()
            if not on:
                assert not v.any()
                continue
            ov = abs(v @ ref[:, i]) / np.linalg.norm(v) / np.linalg.norm(
                ref[:, i])
            assert ov > 1 - 1e-6
    if side in ("c", "s"):
        g = (res.evec_l @ res.evec_r.T).numpy()
        np.testing.assert_allclose(g, np.eye(N2_WANT), atol=1e-8)


def test_max_iter_reached_is_not_ok(small):
    res = _small_run(small, "c", max_iter=3)
    assert not res.ok
    assert res.n_iter <= 6


def test_use_left_flips_on_one_operator(small):
    """The same operator closure (A^T) under use_left True, False, True:
    each run takes its own side's Gram layout and vectors (the reference's
    memo keyed a concrete flag as traced and could reuse the other side's
    program).  Both sides converge to A's left eigenvectors; the two
    use_left=True runs are identical."""
    a, w, _, vl, guess = small
    ta = _t(a)
    op, pc = dense_matvec(ta.T), diag_precnd(torch.diagonal(ta))
    opts = SolverOptions(n_targ=N2_WANT, n_max=N2_WANT, max_iter=200,
                         tol=1e-8, max_dav=10)
    runs = [nonsym_pass(op, pc, _t(guess), opts, use_left=flag)
            for flag in (True, False, np.bool_(True))]
    assert all(r.ok for r in runs)
    for f in dataclasses.fields(runs[0]):
        x, y = getattr(runs[0], f.name), getattr(runs[2], f.name)
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), f.name
    for r in runs[:2]:
        np.testing.assert_allclose(r.eig[:N2_WANT].numpy(), w[:N2_WANT],
                                   rtol=0, atol=1e-7)
        for i in range(N2_WANT):
            v = r.evec[i].numpy()
            assert abs(v @ vl[:, i]) / np.linalg.norm(v) / np.linalg.norm(
                vl[:, i]) > 1 - 1e-6
    with pytest.raises(TypeError):
        nonsym_pass(op, pc, _t(guess), opts, use_left=torch.tensor(True))


def test_driver_and_side_are_checked(small):
    a, _, _, _, guess = small
    ta = _t(a)
    args = (dense_matvec(ta), dense_matvec(ta.T),
            diag_precnd(torch.diagonal(ta)), _t(guess),
            SolverOptions(n_targ=2, n_max=N2_WANT))
    # driver="device" (the Eberlein reduced solve) runs now: see
    # test_torch_reduced_routes.py; a driver no package has still raises
    with pytest.raises(ValueError, match="driver"):
        nonsym(*args, driver="gpu")
    with pytest.raises(ValueError, match="side"):
        nonsym(*args, side="x")
    with pytest.raises(ValueError, match="driver"):
        nonsym_pass(args[0], args[2], args[3], args[4], driver="gpu")
