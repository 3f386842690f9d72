"""The port's Eberlein nonsymmetric eigensolver
(``diaglib_tpu_torch/utils/eberlein.py``) on the matrices and bounds of
tests/test_eberlein.py, run through both packages.

Inputs are made once in numpy.  Bounds are the reference test's: the
leading real eigenvalues against LAPACK's eig (1e-11 for the perturbed and
similarity-transformed symmetric matrices, 1e-10 for a planted spectrum,
1e-12 for a symmetric one), right and left eigenvector residuals within
50x that, complex pairs located to 1e-6 relative.  Beside them the port's
``wr`` lies within 1e-11 of the reference's ``eberlein_eig`` on the same
input.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from diaglib_tpu.utils.eberlein import eberlein_eig as j_eberlein_eig
from diaglib_tpu_torch.utils.eberlein import eberlein_eig


def _both(a):
    got = [x.numpy() for x in eberlein_eig(torch.from_numpy(a))]
    want = [np.asarray(x) for x in jax.jit(j_eberlein_eig)(jnp.asarray(a))]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-11)
    return got


def _real_eigs(a):
    w = scipy.linalg.eig(a, right=False)
    return np.sort(w[np.abs(w.imag) < 1e-9].real)


def _check(a, atol, n_want=8):
    wr, wi, vr, vl = _both(a)
    w_ref = _real_eigs(a)
    wr_real = np.sort(wr[wi < 1e-8])
    k = min(n_want, len(w_ref), len(wr_real))
    np.testing.assert_allclose(wr_real[:k], w_ref[:k], rtol=0, atol=atol)
    cnt = 0
    for i in range(len(wr)):
        if wi[i] > 1e-8 or cnt >= n_want:
            continue
        cnt += 1
        assert np.linalg.norm(a @ vr[:, i] - wr[i] * vr[:, i]) < 50 * atol
        assert np.linalg.norm(a.T @ vl[:, i] - wr[i] * vl[:, i]) < 50 * atol


def _sym(L, seed):
    s = np.random.default_rng(seed).standard_normal((L, L))
    return s + s.T


@pytest.mark.parametrize("L", [7, 24, 80])
def test_perturbed_symmetric(L):
    rng = np.random.default_rng(L)
    s = rng.standard_normal((L, L))
    s = s + s.T
    _check(s + 0.05 * rng.standard_normal((L, L)), atol=1e-11)


def test_similarity_transformed_symmetric():
    rng = np.random.default_rng(0)
    L = 48
    s = rng.standard_normal((L, L))
    s = s + s.T
    t = rng.standard_normal((L, L))
    t *= 0.01 / np.linalg.norm(t)
    _check(scipy.linalg.expm(-t.T) @ s @ scipy.linalg.expm(t.T), atol=1e-11)


def test_explicit_spectrum():
    rng = np.random.default_rng(2)
    L = 32
    w = np.sort(rng.uniform(1.0, 50.0, L))
    p = rng.standard_normal((L, L)) + 3 * np.eye(L)
    wr, wi, _, _ = _both(p @ np.diag(w) @ np.linalg.inv(p))
    assert np.abs(wi).max() < 1e-8
    np.testing.assert_allclose(np.sort(wr), w, rtol=0, atol=1e-10)


def test_symmetric_degenerates_to_jacobi():
    s = _sym(20, 5)
    wr, wi, _, _ = _both(s)
    assert np.abs(wi).max() < 1e-10
    np.testing.assert_allclose(np.sort(wr), np.linalg.eigvalsh(s), rtol=0,
                               atol=1e-12)


def test_complex_pairs_located():
    rng = np.random.default_rng(7)
    blocks = [np.diag(np.arange(1.0, 9.0))]
    ims = (3.0, 7.5)
    for k, im in enumerate(ims):
        blocks.append(np.array([[20.0 + k, im], [-im, 20.0 + k]]))
    a = scipy.linalg.block_diag(*blocks)
    q = np.linalg.qr(rng.standard_normal(a.shape))[0]
    wr, wi, _, _ = _both(q.T @ a @ q)
    np.testing.assert_allclose(np.sort(wi[wi > 1e-6]),
                               np.repeat(np.sort(ims), 2), rtol=1e-6)
    np.testing.assert_allclose(np.sort(wr[wi < 1e-6]), np.arange(1.0, 9.0),
                               rtol=0, atol=1e-9)


def test_odd_dimension_padding():
    rng = np.random.default_rng(9)
    L = 15
    s = rng.standard_normal((L, L))
    s = s + s.T
    _check(s + 0.02 * rng.standard_normal((L, L)), atol=1e-11, n_want=L)


def test_float32_input_and_off_tol():
    """float32 in, float32 out, solved in float32 then float64 as the
    reference does; and a relaxed target given as a 0-d tensor, as the
    nonsymmetric driver passes it."""
    rng = np.random.default_rng(4)
    a = _sym(24, 4) + 0.05 * rng.standard_normal((24, 24))
    w_ref = _real_eigs(a)
    wr, wi, vr, vl = eberlein_eig(torch.from_numpy(a).float())
    assert {x.dtype for x in (wr, wi, vr, vl)} == {torch.float32}
    np.testing.assert_allclose(np.sort(wr.double().numpy()), w_ref, rtol=0,
                               atol=1e-4)
    wr64, _, _, _ = eberlein_eig(torch.from_numpy(a),
                                 off_tol=torch.tensor(1e-6))
    np.testing.assert_allclose(np.sort(wr64.numpy()), w_ref, rtol=0,
                               atol=1e-8)
