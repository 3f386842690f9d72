"""The ELLPACK operator (``ops/ell.py``) of the port against the JAX
package, on tests/test_ell.py's matrices.

The builders run on the host with the same numpy code, so ``vals`` and
``cols`` are equal; the matvec (one gather and multiply-add a slot, in
slot order) is held within 1e-14 max|y| of JAX's; a Davidson solve over it
from the same nonzero numpy guess must be ok, with eigenvalues within
1e-10 of JAX's and iteration and matvec counts within +-2 (matvecs +-2
n_max) of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.ops import ell as jell
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.solvers import davidson as j_davidson
from diaglib_tpu_torch import SolverOptions, davidson
from diaglib_tpu_torch.ops import (
    ELLMatrix,
    ell_diagonal,
    ell_from_coo,
    ell_from_dense,
    ell_matvec,
    ell_to_dense,
)
from diaglib_tpu_torch.problems import diag_precnd

N = 300


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU threads and XLA's contend in one process
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _sparse_spd():
    """tests/test_ell.py's random sparse SPD: ~8 nonzeros a row and a
    dominant diagonal."""
    rng = np.random.default_rng(7)
    k = 4 * N
    r = rng.integers(0, N, k)
    c = rng.integers(0, N, k)
    v = rng.standard_normal(k) * 0.1
    a = np.zeros((N, N))
    np.add.at(a, (r, c), v)
    a = 0.5 * (a + a.T)
    a[np.diag_indices(N)] = 2.0 + np.abs(a).sum(1) + rng.random(N)
    return a


@pytest.fixture(scope="module")
def pair():
    a = _sparse_spd()
    return a, jell.ell_from_dense(jnp.asarray(a)), ell_from_dense(a, "cpu")


def test_builders_equal_the_reference(pair):
    a, jm, m = pair
    assert isinstance(m, ELLMatrix) and m.n == jm.n == N
    np.testing.assert_array_equal(m.vals.numpy(), np.asarray(jm.vals))
    np.testing.assert_array_equal(m.cols.numpy(), np.asarray(jm.cols))
    assert m.cols.dtype == torch.int32
    assert m.slots == jm.slots and m.nnz == jm.nnz
    np.testing.assert_array_equal(ell_to_dense(m).numpy(), a)
    np.testing.assert_array_equal(ell_diagonal(m).numpy(),
                                  np.asarray(jell.ell_diagonal(jm)))


def test_matvec_matches_the_reference(pair):
    a, jm, m = pair
    x = np.random.default_rng(1).standard_normal((5, N))
    y = ell_matvec(m)(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(jell.ell_matvec(jm))(jnp.asarray(x)))
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-14 * scale)
    np.testing.assert_allclose(y, x @ a.T, rtol=0, atol=1e-14 * scale)


def test_from_coo_sums_duplicates():
    m = ell_from_coo([0, 0, 1], [1, 1, 0], [2.0, 3.0, 1.0], 4, device="cpu")
    jm = jell.ell_from_coo([0, 0, 1], [1, 1, 0], [2.0, 3.0, 1.0], 4)
    d = ell_to_dense(m).numpy()
    assert d[0, 1] == 5.0 and d[1, 0] == 1.0
    assert m.slots == 1
    np.testing.assert_array_equal(d, np.asarray(jell.ell_to_dense(jm)))


def test_davidson_on_ell_matches_the_reference(pair):
    a, jm, m = pair
    kw = dict(n_targ=4, n_max=8, max_iter=100, tol=1e-9)
    guess = np.random.default_rng(9).uniform(-0.5, 0.5, (8, N))
    ref = j_davidson(jell.ell_matvec(jm), j_diag_precnd(jell.ell_diagonal(jm)),
                     jnp.asarray(guess), JOptions(**kw),
                     key=jax.random.PRNGKey(3))
    res = davidson(ell_matvec(m), diag_precnd(ell_diagonal(m)),
                   torch.from_numpy(guess), SolverOptions(**kw))
    assert res.ok and bool(ref.ok)
    np.testing.assert_allclose(res.eig[:4].numpy(), np.asarray(ref.eig[:4]),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(res.eig[:4].numpy(),
                               np.linalg.eigvalsh(a)[:4], rtol=0, atol=1e-8)
    assert abs(res.n_iter - int(ref.n_iter)) <= 2
    assert abs(res.n_matvec - int(ref.n_matvec)) <= 2 * 8


def test_builders_go_to_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ell_from_coo([0], [0], [1.0], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ell_from_dense(np.eye(3))
