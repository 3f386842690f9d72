"""Davidson of the PyTorch port against the JAX package on the reference
toy protocol: symm_matrix(1000), 10 roots, n_max = 15, one numpy guess
handed to both packages (nonzero, so no random fallback fires).

Eigenvalues agree to 1e-10; iteration counts may differ by the
reduction-order jitter between XLA and torch (+-2 iterations, +-2 n_max
matvecs, the band of tests/test_iteration_parity.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.problems import dense_matvec as j_dense_matvec
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.problems import symm_matrix as j_symm_matrix
from diaglib_tpu.solvers import davidson as j_davidson
from diaglib_tpu_torch import SolverOptions, davidson
from diaglib_tpu_torch.problems import dense_matvec, diag_precnd, symm_matrix

N = 1000


@pytest.fixture(scope="module")
def matrix():
    a = symm_matrix(N, device="cpu")
    np.testing.assert_array_equal(a.numpy(), np.asarray(j_symm_matrix(N)))
    return a


def _guess(n_max, seed=1):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (n_max, N))


def _both(a, guess, **kw):
    res = davidson(dense_matvec(a), diag_precnd(torch.diagonal(a)),
                   torch.from_numpy(guess), SolverOptions(**kw))
    ja = jnp.asarray(a.numpy())
    ref = j_davidson(j_dense_matvec(ja), j_diag_precnd(jnp.diagonal(ja)),
                     jnp.asarray(guess), JOptions(**kw),
                     key=jax.random.PRNGKey(1))
    return res, ref


def _agree(res, ref, n_targ, n_max):
    assert res.ok and bool(ref.ok)
    np.testing.assert_allclose(res.eig[:n_targ].numpy(),
                               np.asarray(ref.eig[:n_targ]), rtol=0,
                               atol=1e-10)
    assert abs(res.n_iter - int(ref.n_iter)) <= 2
    assert abs(res.n_matvec - int(ref.n_matvec)) <= 2 * n_max
    assert res.ortho_ok


def test_davidson_toy_protocol(matrix):
    res, ref = _both(matrix, _guess(15), n_targ=10, n_max=15, max_iter=100,
                     tol=1e-8)
    _agree(res, ref, 10, 15)
    w = np.linalg.eigvalsh(matrix.numpy())[:10]
    np.testing.assert_allclose(res.eig[:10].numpy(), w, rtol=0, atol=1e-10)
    # histories: one row per iteration, the rest untouched
    assert np.isfinite(res.rms_history[:res.n_iter, 0].numpy()).all()
    assert np.isinf(res.rms_history[res.n_iter:].numpy()).all()
    r = res.evec[:10] @ matrix - res.eig[:10, None] * res.evec[:10]
    assert float(r.norm(dim=1).max()) / np.sqrt(N) < 1e-8


def test_davidson_restart_path(matrix):
    kw = dict(n_targ=4, n_max=6, max_iter=150, tol=1e-10, max_dav=10)
    res, ref = _both(matrix, _guess(6, seed=2), **kw)
    _agree(res, ref, 4, 6)
    # past dim_dav iterations the space was collapsed at least once
    assert res.n_iter > SolverOptions(**kw).dim_dav


def test_davidson_nonconvergence(matrix):
    res, ref = _both(matrix, _guess(15), n_targ=10, n_max=15, max_iter=3,
                     tol=1e-8)
    assert not res.ok and not bool(ref.ok)
    assert res.n_iter == int(ref.n_iter) == 3
    assert res.n_matvec == int(ref.n_matvec)


def test_davidson_zero_guess_uses_generator(matrix):
    g = torch.Generator().manual_seed(5)
    opts = SolverOptions(n_targ=4, n_max=6, max_iter=100, tol=1e-8)
    res = davidson(dense_matvec(matrix), diag_precnd(torch.diagonal(matrix)),
                   torch.zeros((6, N), dtype=torch.float64), opts,
                   generator=g)
    assert res.ok
    w = np.linalg.eigvalsh(matrix.numpy())[:4]
    np.testing.assert_allclose(res.eig[:4].numpy(), w, rtol=0, atol=1e-10)


@pytest.mark.parametrize("field,value,exc", [
    ("sliced_mm", "sometimes", ValueError),
    ("reduced_solver", "lapack", ValueError),
    ("reduced_solver", "", ValueError),
    ("wide_mm", "sometimes", ValueError),
])
def test_unported_routes_raise(matrix, field, value, exc):
    """A route no package has raises before the solve starts.  (The
    routes this test once found unported, sliced_mm="always" and
    reduced_solver "jacobi" / "host", are accepted now and held against
    the reference in test_torch_sliced_mm.py and
    test_torch_reduced_routes.py.)"""
    opts = SolverOptions(n_targ=2, n_max=3, **{field: value})
    with pytest.raises(exc):
        davidson(dense_matvec(matrix), diag_precnd(torch.diagonal(matrix)),
                 torch.from_numpy(_guess(3)), opts)
