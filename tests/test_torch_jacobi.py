"""The port's cyclic-Jacobi solvers (``diaglib_tpu_torch/utils/jacobi.py``)
and the "jacobi" and "host" routes of its reduced solves, against the JAX
package and LAPACK.

Inputs are made once in numpy.  Bounds are the reference's own
(tests/test_reduced.py): eigenvalues within 1e-11 of LAPACK, eigen-
residuals within 1e-10, orthonormality within 1e-12; singular values within
1e-11; the generalized pencil within 1e-10 with x^T a x = I to 1e-9.
``rank_argsort`` must equal the reference's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from diaglib_tpu.utils import jacobi as jjac
from diaglib_tpu_torch.utils import jacobi, reduced
from diaglib_tpu_torch.utils.masking import masked_eigh_prefix


def _t(a):
    return torch.from_numpy(np.array(a))


def _sym(n, seed=0):
    a = np.random.default_rng(seed).standard_normal((n, n))
    return 0.5 * (a + a.T)


@pytest.mark.parametrize("descending", [False, True])
def test_rank_argsort_equals_the_reference(descending):
    """Stable order, ties by index, in both directions: integer-valued
    keys with many ties, signed zeros and infinities."""
    rng = np.random.default_rng(3)
    w = rng.integers(-4, 5, 200).astype(np.float64)
    w[:6] = [0.0, -0.0, np.inf, -np.inf, 0.0, -0.0]
    got = jacobi.rank_argsort(_t(w), descending=descending).numpy()
    want = np.asarray(jjac.rank_argsort(jnp.asarray(w), descending))
    np.testing.assert_array_equal(got, want)


def _check_eigh(a, w, v, atol_w=1e-11):
    n = a.shape[0]
    np.testing.assert_allclose(w, np.linalg.eigvalsh(a), rtol=0, atol=atol_w)
    assert np.abs(a @ v - v * w[None, :]).max() < 1e-10
    np.testing.assert_allclose(v.T @ v, np.eye(n), rtol=0, atol=1e-12)


@pytest.mark.parametrize("L", [1, 2, 7, 64, 165])
@pytest.mark.parametrize("mixed", [True, False])
def test_jacobi_eigh_matches_lapack(L, mixed):
    a = _sym(L, L)
    w, v = jacobi.jacobi_eigh(_t(a), mixed_precision=mixed)
    _check_eigh(a, w.numpy(), v.numpy())


@pytest.mark.parametrize("L", [7, 40])
def test_jacobi_eigh_warm_start_and_off_tol(L):
    """The single-phase path from a warm start (the eigenvectors of a
    nearby matrix), and a relaxed off-norm target given as a 0-d tensor,
    as the solvers pass it; the mixed path ignores ``v0`` (the
    reference's choice), so it returns what it returns cold."""
    a = _sym(L, 1)
    _, v1 = jacobi.jacobi_eigh(_t(a))
    da = 1e-3 * _sym(L, 2)
    a2 = a + da
    w2, v2 = jacobi.jacobi_eigh(_t(a2), v0=v1, mixed_precision=False)
    _check_eigh(a2, w2.numpy(), v2.numpy())
    w3, v3 = jacobi.jacobi_eigh(_t(a2), off_tol=torch.tensor(1e-13))
    _check_eigh(a2, w3.numpy(), v3.numpy())
    cold = jacobi.jacobi_eigh(_t(a2))
    warm = jacobi.jacobi_eigh(_t(a2), v0=v1)
    assert all(torch.equal(x, y) for x, y in zip(cold, warm))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_masked_eigh_prefix_warm_growing_prefix(dtype):
    """tests/test_reduced.py's growing-prefix pattern: each solve of the
    leading block warm-started from the previous call's full-width
    vectors (their zero columns filled with identity columns), on the
    Jacobi route with a relaxed target; float32 takes the warm start."""
    full = 48
    a = _t(_sym(full, 5)).to(dtype)
    tol = 1e-10 if dtype == torch.float64 else 2e-4
    v_prev = None
    for ldu in (10, 14, 26, 40):
        w, v = masked_eigh_prefix(a, ldu, "jacobi", v0=v_prev,
                                  off_tol=1e-13)
        w_ref = np.linalg.eigvalsh(a[:ldu, :ldu].double().numpy())
        np.testing.assert_allclose(w[:ldu].double().numpy(), w_ref, rtol=0,
                                   atol=tol)
        assert not v[ldu:].any() and not v[:, ldu:].any()
        v_prev = v


def test_jacobi_eigh_agrees_with_the_reference():
    """The same float32 + float64 algorithm as JAX's on the same input:
    the eigenvalues agree far inside the LAPACK bound."""
    a = _sym(33, 4)
    w, _ = jacobi.jacobi_eigh(_t(a))
    wj, _ = jjac.jacobi_eigh(jnp.asarray(a))
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("L", [1, 17, 64])
def test_jacobi_svd_matches_lapack(L):
    a = np.random.default_rng(L).standard_normal((L, L))
    s0 = np.linalg.svd(a, compute_uv=False)
    for svd in (jacobi.jacobi_svd, jacobi.jacobi_svd_onesided):
        u, s, vt = (x.numpy() for x in svd(_t(a)))
        np.testing.assert_allclose(s, s0, rtol=0, atol=1e-11)
        np.testing.assert_allclose((u * s[None, :]) @ vt, a, rtol=0,
                                   atol=1e-11)


@pytest.mark.parametrize("L", [40, 41])
def test_onesided_svd_keeps_small_singular_values(L):
    """tests/test_reduced.py's one-sided case: a 1e6 condition number,
    singular values to 1e-10 relative, orthonormal factors, exact
    reconstruction."""
    rng = np.random.default_rng(L)
    u0, _, vt0 = np.linalg.svd(rng.standard_normal((L, L)))
    a = (u0 * np.logspace(0, -6, L)[None, :]) @ vt0
    u, s, vt = (x.numpy() for x in jacobi.jacobi_svd_onesided(_t(a)))
    sr = np.linalg.svd(a, compute_uv=False)
    assert np.max(np.abs(s - sr) / sr) < 1e-10
    assert np.abs((u * s[None, :]) @ vt - a).max() < 1e-14
    np.testing.assert_allclose(u.T @ u, np.eye(L), rtol=0, atol=1e-13)
    np.testing.assert_allclose(vt @ vt.T, np.eye(L), rtol=0, atol=1e-13)


@pytest.mark.parametrize("method", ["jacobi", "host"])
def test_eigh_gen_matches_scipy(method):
    n = 48
    s = _sym(n, 5)
    b = np.random.default_rng(6).standard_normal((n, n))
    a = b @ b.T + n * np.eye(n)
    e, x = (y.numpy() for y in reduced.eigh_gen(_t(s), _t(a), method))
    np.testing.assert_allclose(e, scipy.linalg.eigh(s, a, eigvals_only=True),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(x.T @ a @ x, np.eye(n), rtol=0, atol=1e-9)


@pytest.mark.parametrize("method", ["jacobi", "host"])
def test_eigh_and_svd_routes(method):
    """``reduced.eigh`` and ``reduced.svd`` on each route, float64 and
    float32 in, the input's dtype out (the host route solves in float64)."""
    a = _sym(20, 7)
    for dt, tol in ((torch.float64, 1e-11), (torch.float32, 2e-5)):
        w, v = reduced.eigh(_t(a).to(dt), method)
        assert w.dtype == v.dtype == dt
        np.testing.assert_allclose(w.double().numpy(), np.linalg.eigvalsh(a),
                                   rtol=0, atol=tol * 20)
        u, s, vt = reduced.svd(_t(a).to(dt), method)
        assert u.dtype == s.dtype == vt.dtype == dt
        np.testing.assert_allclose(s.double().numpy(),
                                   np.linalg.svd(a, compute_uv=False),
                                   rtol=0, atol=tol * 20)
