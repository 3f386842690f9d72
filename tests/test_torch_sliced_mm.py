"""The port's exact sliced long contractions (``ops/slicing.py``
``sliced_mm`` / ``sliced_mmT`` / ``sliced_mTm``) and the
``SolverOptions(sliced_mm=...)`` routing, against the JAX package.

Inputs are made once in numpy (normal values, so that no line maximum is
an exact power of two, where the reference's CPU grid overshoots: ROADMAP
Queue 3).  The planes, scales and products are integers and exactly
rounded float64 sums, so they must equal the reference's bit for bit; a
Davidson run under "always" must match the reference's within 1e-10 and
the +-2 band of tests/test_iteration_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.ops import slicing as jsl
from diaglib_tpu.problems import dense_matvec as j_dense_matvec
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.problems import symm_matrix as j_symm_matrix
from diaglib_tpu.solvers import davidson as j_davidson
from diaglib_tpu_torch import SolverOptions, davidson, ops
from diaglib_tpu_torch.ops import slicing as tsl
from diaglib_tpu_torch.problems import dense_matvec, diag_precnd
from diaglib_tpu_torch.utils import mm as tmm


def _t(a):
    return torch.from_numpy(np.array(a))


def test_fits_exact_and_combine_weights():
    for bits in (6, 7):
        for k in (1, 2, 1000, 2 ** 16, 2 ** 17 - 1, 2 ** 17, 2 ** 20):
            assert tsl.fits_exact(k, bits) == jsl.fits_exact(k, bits)
    assert tsl.fits_exact(2 ** 17 - 1) and not tsl.fits_exact(2 ** 17)
    np.testing.assert_array_equal(tsl.combine_weights(17).numpy(),
                                  np.asarray(jsl.combine_weights(17)))


@pytest.mark.parametrize("axis", [0, -1])
def test_slice_operand_equals_the_reference(axis):
    """Planes and power-of-two scales of both axes at the long-contraction
    grid (6 bits, 9 planes), rows of very different magnitudes included."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 40)) * 2.0 ** rng.integers(-30, 30, (6, 1))
    x[:, 3] *= 1e-9
    planes, scale = tsl.slice_operand(_t(x), axis, 9, 6)
    jp, js = jsl.slice_operand(jnp.asarray(x), axis)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    assert scale.shape == ((6, 1) if axis == -1 else (1, 40))


@pytest.mark.parametrize("k", [1, 7, 300, 8192])
def test_sliced_products_bit_equal_to_the_reference(k):
    rng = np.random.default_rng(k)
    a = rng.standard_normal((5, k))
    b = rng.standard_normal((6, k)) * 1e3
    c = rng.standard_normal((k, 4))
    d = rng.standard_normal((k, 3))
    cases = ((tsl.sliced_mmT, jsl.sliced_mmT, a, b),
             (tsl.sliced_mm, jsl.sliced_mm, a, c),
             (tsl.sliced_mTm, jsl.sliced_mTm, c, d))
    for port, ref, x, y in cases:
        got = port(_t(x), _t(y)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(ref(jnp.asarray(x), jnp.asarray(y))))
    # and exact to a couple of ulps of the float64 product
    got = tsl.sliced_mmT(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, a @ b.T, rtol=0,
                               atol=1e-13 * np.abs(b).max() * max(k, 8))


def test_contraction_past_the_int32_budget_raises():
    a = torch.zeros((2, 2 ** 17), dtype=torch.float64)
    with pytest.raises(ValueError, match="overflows"):
        tsl.sliced_mmT(a, a)
    with pytest.raises(ValueError, match="overflows"):
        tsl.sliced_mTm(a.T, a.T)
    assert ops.sliced_mm is tsl.sliced_mm


def test_routing():
    """"always" sends float64 products within the budget to the sliced
    route (bit for bit what the sliced functions give), leaves float32 and
    over-budget ones plain; "never" also turns the wide route off."""
    rng = np.random.default_rng(2)
    a, b = _t(rng.standard_normal((4, 50))), _t(rng.standard_normal((3, 50)))
    c = _t(rng.standard_normal((50, 2)))
    with tmm.mm_routing(sliced="always"):
        assert torch.equal(tmm.mmT(a, b), tsl.sliced_mmT(a, b))
        assert torch.equal(tmm.mm(a, c), tsl.sliced_mm(a, c))
        assert torch.equal(tmm.mTm(c, c), tsl.sliced_mTm(c, c))
        assert torch.equal(tmm.mmT(a.float(), b.float()),
                           a.float() @ b.float().T)
        long = torch.zeros((2, 2 ** 17), dtype=torch.float64)
        assert torch.equal(tmm.mmT(long, long), long @ long.T)
    assert torch.equal(tmm.mmT(a, b), a @ b.T)
    assert tmm.routing_for(SolverOptions(n_targ=1, n_max=1,
                                         sliced_mm="always"),
                           "davidson").sliced == "always"
    with tmm.mm_routing(wide="always", sliced="never"):
        assert not tmm._use_wide(torch.float64, "cuda", 165, 15, 65536)
    with tmm.mm_routing(wide="always", sliced="auto"):
        assert tmm._use_wide(torch.float64, "cuda", 165, 15, 65536)


def test_davidson_under_always_matches_the_reference():
    """SolverOptions(sliced_mm="always"): every Gram product and rotation
    of the float64 solve goes through the sliced products, in both
    packages."""
    n = 300
    a = np.asarray(j_symm_matrix(n))
    guess = np.random.default_rng(5).uniform(-0.5, 0.5, (6, n))
    kw = dict(n_targ=3, n_max=6, max_iter=100, tol=1e-9, max_dav=10,
              sliced_mm="always")
    ref = j_davidson(j_dense_matvec(jnp.asarray(a)),
                     j_diag_precnd(jnp.diagonal(jnp.asarray(a))),
                     jnp.asarray(guess), JOptions(**kw),
                     key=jax.random.PRNGKey(0))
    ta = _t(a)
    res = davidson(dense_matvec(ta), diag_precnd(torch.diagonal(ta)),
                   _t(guess), SolverOptions(**kw))
    assert res.ok and bool(ref.ok)
    np.testing.assert_allclose(res.eig[:3].numpy(), np.asarray(ref.eig[:3]),
                               rtol=0, atol=1e-10)
    assert abs(res.n_iter - int(ref.n_iter)) <= 2
    assert abs(res.n_matvec - int(ref.n_matvec)) <= 2 * 6
