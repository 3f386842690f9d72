"""LOBPCG of the port against the JAX package: the reference toy protocol
(symm/lobpcg and geneig/lobpcg, guess strategy 4 made by JAX's
``guess_evec`` and handed over as numpy), the non-convergence path, and
``lobpcg_ladder`` over a symmetric sliced store carried over from JAX.

Tolerances: eigenvalues within 1e-10 of JAX; (n_iter, n_matvec) within
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
from diaglib_tpu.ops.bsr import bsr_to_dense as j_bsr_to_dense
from diaglib_tpu.ops.bsr import random_bsr_spd as j_random_bsr_spd
from diaglib_tpu.ops.bsr_sliced_sym import slice_bsr_sym as j_slice_bsr_sym
from diaglib_tpu.ops.bsr_sliced_sym import sym_sliced_matvec as j_matvec
from diaglib_tpu.problems import dense_matvec as j_dense_matvec
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.problems import metric_matrix as j_metric_matrix
from diaglib_tpu.problems import symm_matrix as j_symm_matrix
from diaglib_tpu.solvers import lobpcg as j_lobpcg
from diaglib_tpu.solvers import lobpcg_ladder as j_lobpcg_ladder
from diaglib_tpu.utils.guess import guess_evec
from diaglib_tpu_torch import SolverOptions, lobpcg, lobpcg_ladder
from diaglib_tpu_torch.ops.bsr_sliced_sym import (
    sym_sliced_matvec,
    sym_store_from_arrays,
)
from diaglib_tpu_torch.problems import dense_matvec, diag_precnd

N, N_WANT, N_EIG = 1000, 10, 15
TOY = dict(n_targ=N_WANT, n_max=N_EIG, max_iter=100, tol=1e-8, max_dav=20)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def toy():
    a = np.asarray(j_symm_matrix(N))
    diag = np.diag(a).copy()
    guess = np.asarray(guess_evec(4, jax.random.PRNGKey(1), N, N_EIG,
                                  diagonal=jnp.asarray(diag)))
    s = np.asarray(j_metric_matrix(N, jax.random.PRNGKey(1)))
    return a, diag, guess, s


def _run(toy, generalized, **over):
    a, diag, guess, s = toy
    kw = dict(TOY, **over)
    res = lobpcg(dense_matvec(_t(a)), diag_precnd(_t(diag)), _t(guess),
                 SolverOptions(**kw),
                 bvec=dense_matvec(_t(s)) if generalized else None)
    ref = j_lobpcg(j_dense_matvec(jnp.asarray(a)),
                   j_diag_precnd(jnp.asarray(diag)), jnp.asarray(guess),
                   JOptions(**kw), key=jax.random.PRNGKey(1),
                   bvec=j_dense_matvec(jnp.asarray(s)) if generalized
                   else None)
    return res, ref


@pytest.mark.parametrize("name,generalized,expected", [
    ("symm/lobpcg", False, (25, 358)),
    ("geneig/lobpcg", True, (12, 157)),
])
def test_lobpcg_toy_protocol(toy, name, generalized, expected):
    res, ref = _run(toy, generalized)
    assert res.ok and bool(ref.ok) and res.ortho_ok, name
    np.testing.assert_allclose(res.eig[:N_WANT].numpy(),
                               np.asarray(ref.eig[:N_WANT]), rtol=0,
                               atol=1e-10)
    it_exp, mv_exp = expected
    assert abs(res.n_iter - it_exp) <= 2
    assert abs(res.n_matvec - mv_exp) <= max(1, round(mv_exp * 2.5 / it_exp))
    a, _, _, s = toy
    w = (scipy.linalg.eigh(a, s, eigvals_only=True) if generalized
         else np.linalg.eigvalsh(a))[:N_WANT]
    np.testing.assert_allclose(res.eig[:N_WANT].numpy(), w, rtol=0,
                               atol=TOY["tol"])
    # histories: one row per iteration, the rest untouched
    assert np.isfinite(res.rms_history[:res.n_iter, 0].numpy()).all()
    assert np.isinf(res.rms_history[res.n_iter:].numpy()).all()


@pytest.mark.parametrize("generalized", [False, True])
def test_lobpcg_nonconvergence(toy, generalized):
    res, ref = _run(toy, generalized, max_iter=3)
    assert not res.ok and not bool(ref.ok)
    assert res.n_iter == int(ref.n_iter) == 3
    assert res.n_matvec == int(ref.n_matvec)
    # the unconverged Ritz values, to rounding (relative 1e-10)
    np.testing.assert_allclose(res.eig_history[:3].numpy(),
                               np.asarray(ref.eig_history[:3]), rtol=1e-10,
                               atol=0)


def test_lobpcg_shift_is_removed(toy):
    a, diag, guess, _ = toy
    opts = SolverOptions(n_targ=4, n_max=6, max_iter=100, tol=1e-8,
                         shift=3.0)
    res = lobpcg(dense_matvec(_t(a)), diag_precnd(_t(diag)),
                 _t(guess[:6]), opts)
    assert res.ok
    np.testing.assert_allclose(res.eig[:4].numpy(),
                               np.linalg.eigvalsh(a)[:4], rtol=0, atol=1e-8)


@pytest.fixture(scope="module")
def store():
    jm = j_random_bsr_spd(256, 64, 3, jax.random.PRNGKey(0),
                          dtype=jnp.float32)
    js = j_slice_bsr_sym(jm)
    ts = sym_store_from_arrays({f.name: np.asarray(getattr(js, f.name))
                                for f in dataclasses.fields(js)}, device="cpu")
    return js, ts, np.asarray(j_bsr_to_dense(jm), np.float64)


LADDER = dict(n_targ=4, n_max=8, max_iter=150, tol=1e-10, max_dav=10)
# the float32 stage's target sits above both packages' float32 noise floor
# on this operator (their matvecs are bit-equal, but torch's and XLA's
# float32 products round differently, and the port's stage settles near
# 3e-6 where JAX's reaches 1.8e-6); a stage on its floor runs to lo_iter
LO = dict(lo_tol=1e-5, lo_iter=70)


def test_lobpcg_ladder_matches_reference(store):
    js, ts, dense = store
    guess = np.random.default_rng(21).uniform(-0.5, 0.5, (8, 256))
    res = lobpcg_ladder(
        sym_sliced_matvec(ts, dtype=torch.float32),
        diag_precnd(ts.diagonal.to(torch.float32)),
        sym_sliced_matvec(ts), diag_precnd(ts.diagonal), _t(guess),
        SolverOptions(**LADDER), **LO)
    ref = j_lobpcg_ladder(
        j_matvec(js, dtype=jnp.float32, interpret=True),
        j_diag_precnd(js.diagonal.astype(jnp.float32)),
        j_matvec(js, interpret=True), j_diag_precnd(js.diagonal),
        jnp.asarray(guess), JOptions(**LADDER), key=jax.random.PRNGKey(1),
        **LO)
    assert res.ok and bool(ref.ok) and res.ortho_ok
    np.testing.assert_allclose(res.eig[:4].numpy(), np.asarray(ref.eig[:4]),
                               rtol=0, atol=1e-10)
    assert abs(res.n_iter - int(ref.n_iter)) <= 2
    assert res.eig.dtype == torch.float64
    w = np.linalg.eigvalsh(dense)[:4]
    np.testing.assert_allclose(res.eig[:4].numpy(), w, rtol=0, atol=1e-10)
    ev = res.evec[:4].numpy()
    r = ev @ dense - res.eig[:4, None].numpy() * ev
    assert np.max(np.linalg.norm(r, axis=1)) / np.sqrt(256) < 1e-10


def test_generalized_lobpcg_ladder_on_the_store(store):
    _, ts, dense = store
    s = np.random.default_rng(6).uniform(size=(256, 256))
    s = s.T @ s / 256 + np.eye(256)
    ts_ = _t(s)
    guess = np.random.default_rng(22).uniform(-0.5, 0.5, (8, 256))
    res = lobpcg_ladder(
        sym_sliced_matvec(ts, dtype=torch.float32),
        diag_precnd(ts.diagonal.to(torch.float32)),
        sym_sliced_matvec(ts), diag_precnd(ts.diagonal), _t(guess),
        SolverOptions(**LADDER), **LO, bvec_lo=dense_matvec(ts_.float()), bvec_hi=dense_matvec(ts_))
    assert res.ok and res.ortho_ok
    w = scipy.linalg.eigh(dense, s, eigvals_only=True)[:4]
    np.testing.assert_allclose(res.eig[:4].numpy(), w, rtol=0, atol=1e-9)
    ev = res.evec[:4].numpy()
    r = ev @ dense - res.eig[:4, None].numpy() * (ev @ s)
    assert np.max(np.linalg.norm(r, axis=1)) / np.sqrt(256) < 1e-10
