"""``utils.guess.guess_evec`` of the port against the JAX package.

Strategies 1 and 2 (unit vectors at the smallest / largest diagonal
entries) are deterministic and must be bit-equal to JAX's, diagonals with
ties included (both sort stably).  Strategies 3-6 draw from a
``torch.Generator``, whose stream is not jax.random's: their range, shape,
dtype and the unit-vector positions of 5 and 6 are held instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu.utils.guess import guess_evec as j_guess_evec
from diaglib_tpu_torch.utils import guess_evec

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU threads and XLA's contend in one process
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _diagonals():
    r = np.random.default_rng(3)
    plain = r.standard_normal(40)
    ties = np.round(r.uniform(0, 4, 40))          # many equal entries
    ties32 = 1.0 + r.integers(0, 3, 40) * 1e-9    # equal only in float32
    return {"plain": plain, "ties": ties, "ties_in_f32": ties32}


@pytest.mark.parametrize("dtype,jdtype", [(torch.float64, jnp.float64),
                                          (torch.float32, jnp.float32)])
@pytest.mark.parametrize("name", ["plain", "ties", "ties_in_f32"])
@pytest.mark.parametrize("strategy", [1, 2])
def test_unit_vector_strategies_bit_equal(strategy, name, dtype, jdtype):
    d = _diagonals()[name]
    ref = np.asarray(j_guess_evec(strategy, jax.random.PRNGKey(0), 40, 7,
                                  diagonal=jnp.asarray(d), dtype=jdtype))
    got = guess_evec(strategy, None, 40, 7, diagonal=torch.from_numpy(d),
                     dtype=dtype)
    assert got.dtype == dtype and got.device == CPU
    np.testing.assert_array_equal(got.numpy(), ref)
    # a numpy diagonal on a named device gives the same block
    assert torch.equal(guess_evec(strategy, None, 40, 7, diagonal=d,
                                  dtype=dtype, device="cpu"), got)


@pytest.mark.parametrize("strategy", [3, 4, 5, 6])
def test_random_strategies(strategy):
    d = _diagonals()["ties"]
    g = torch.Generator().manual_seed(7)
    got = guess_evec(strategy, g, 40, 6, diagonal=torch.from_numpy(d))
    assert got.shape == (6, 40) and got.dtype == torch.float64
    if strategy == 3:
        assert float(got.min()) >= 0.0 and float(got.max()) < 1.0
    elif strategy == 4:
        assert float(got.min()) >= -0.5 and float(got.max()) < 0.5
    else:
        onehot = guess_evec(1 if strategy == 6 else 2, None, 40, 6,
                            diagonal=torch.from_numpy(d))
        noise = got - onehot
        assert float(noise.min()) >= 0.0 and float(noise.max()) < 0.01
        assert torch.equal(got.argmax(dim=1), onehot.argmax(dim=1))
    # the generator's stream: the same seed gives the same block
    again = guess_evec(strategy, torch.Generator().manual_seed(7), 40, 6,
                       diagonal=torch.from_numpy(d))
    assert torch.equal(got, again)


def test_guess_evec_refuses():
    with pytest.raises(ValueError, match="diagonal required"):
        guess_evec(1, None, 10, 2, device="cpu")
    with pytest.raises(ValueError, match="unknown guess strategy"):
        guess_evec(7, None, 10, 2, device="cpu")


def test_guess_evec_builds_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        guess_evec(4, torch.Generator(), 10, 2)
    # with a diagonal tensor, its device
    d = torch.arange(10.0, dtype=torch.float64)
    assert guess_evec(1, None, 10, 2, diagonal=d).device == CPU
