"""The plain BSR operator (kernel K4's plain version, ``bsr_matvec``,
``bsr_from_dense``), port against the JAX package.

JAX's matrices are carried across as numpy; JAX runs its Pallas
``_spmm_kernel`` in interpret mode.  Tolerances are the reference's own
(tests/test_bsr.py): float32 rtol = atol = 1e-5 against the kernel,
float64 1e-12 against the segment-sum reference.  The plain-BSR ladder of
the README (float32 stage on ``bsr_matvec(m32)``, float64 on
``bsr_matvec(m64)``) is held to JAX's ladder: eigenvalues within 1e-10,
iterations within +-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.ops import bsr as jbsr
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.solvers import davidson_ladder as j_ladder
from diaglib_tpu_torch import (
    SolverOptions,
    bsr_from_dense,
    bsr_matvec,
    davidson_ladder,
)
from diaglib_tpu_torch.ops import bsr as tbsr
from diaglib_tpu_torch.problems import diag_precnd


def _carry(jm, dtype=None):
    return tbsr.bsr_from_arrays(jm, dtype=dtype, device="cpu")


@pytest.fixture(scope="module")
def jm32():
    return jbsr.random_bsr_spd(256, 32, 3, jax.random.PRNGKey(0),
                               dtype=jnp.float32)


def test_carried_matrix_is_the_same_operator(jm32):
    m = _carry(jm32)
    np.testing.assert_array_equal(tbsr.bsr_to_dense(m).numpy(),
                                  np.asarray(jbsr.bsr_to_dense(jm32)))
    np.testing.assert_array_equal(tbsr.bsr_diagonal(m).numpy(),
                                  np.asarray(jbsr.bsr_diagonal(jm32)))


def test_bsr_spmm_plain_matches_the_pallas_kernel(jm32):
    x = np.random.default_rng(2).standard_normal((8, 256)).astype(np.float32)
    ref = np.asarray(jbsr._spmm_pallas(jm32, jnp.asarray(x), interpret=True))
    m = _carry(jm32)
    before = tbsr.bsr_spmm.launches
    y = bsr_matvec(m)(torch.from_numpy(x))
    assert tbsr.bsr_spmm.launches == before    # the plain version on the CPU
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(y.numpy(),
                                  tbsr.bsr_spmm_plain(m, torch.from_numpy(x))
                                  .numpy())


def test_bsr_matvec_f64_matches_the_segment_reference():
    jm = jbsr.random_bsr_spd(256, 32, 3, jax.random.PRNGKey(0),
                             dtype=jnp.float64)
    x = np.random.default_rng(1).standard_normal((5, 256))
    ref = np.asarray(jbsr._spmm_reference(jm, jnp.asarray(x)))
    y = bsr_matvec(_carry(jm))(torch.from_numpy(x))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-12, atol=1e-12)
    dense = np.asarray(jbsr.bsr_to_dense(jm))
    np.testing.assert_allclose(y.numpy(), x @ dense.T, rtol=1e-12,
                               atol=1e-12)


def test_bsr_spmm_plain_bf16_rounds_the_float32_product_once(jm32):
    m = _carry(jm32, dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 256)).astype(np.float32)).to(torch.bfloat16)
    y = tbsr.bsr_spmm(m, x)
    assert y.dtype == torch.bfloat16
    dense = tbsr.bsr_to_dense(m).float()
    want = (x.float() @ dense.T).to(torch.bfloat16)
    # one float32 summation order against another: at most one bfloat16
    # rounding step apart
    diff = (y.float() - want.float()).abs()
    assert float(diff.max()) <= 2.0 ** -7 * float(want.float().abs().max())


def _blocky(rows_filled, seed=0, n=8 * 16, B=16):
    dense = np.zeros((n, n))
    rng = np.random.default_rng(seed)
    for r in rows_filled:
        dense[r * B:(r + 1) * B, r * B:(r + 1) * B] = rng.standard_normal(
            (B, B))
    dense[0:B, 2 * B:3 * B] = rng.standard_normal((B, B))
    dense[2 * B:3 * B, 0:B] = rng.standard_normal((B, B))
    return dense


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bsr_from_dense_arrays_equal_the_reference(dtype):
    dense = _blocky((0, 2, 3, 5, 7)).astype(dtype)   # rows 1, 4, 6 empty
    jm = jbsr.bsr_from_dense(jnp.asarray(dense), 16)
    tm = bsr_from_dense(dense, 16)
    for f in dataclasses.fields(jm):
        got, want = getattr(tm, f.name), getattr(jm, f.name)
        if isinstance(want, int):
            assert got == want, f.name
        else:
            assert got.dtype == torch.as_tensor(np.array(want)).dtype
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tbsr.bsr_to_dense(tm).numpy(), dense)
    # a torch input gives the same matrix
    tm2 = bsr_from_dense(torch.from_numpy(dense), 16)
    assert torch.equal(tm2.blocks_t, tm.blocks_t)


def test_empty_block_row_returns_zeros():
    dense = _blocky((0, 2, 3, 5, 7))
    B = 16
    m = bsr_from_dense(dense.astype(np.float32), B)
    x = np.random.default_rng(0).standard_normal((3, 8 * B))
    y = bsr_matvec(m)(torch.from_numpy(x.astype(np.float32)))
    jy = jbsr._spmm_pallas(jbsr.bsr_from_dense(jnp.asarray(
        dense, jnp.float32), B), jnp.asarray(x, jnp.float32), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    for r in (1, 4, 6):
        assert float(y[:, r * B:(r + 1) * B].abs().max()) == 0.0
    # a matrix without the padding entries (an empty row has no entry at
    # all) gives the same product
    keep = (m.blocks_t != 0).flatten(1).any(dim=1)
    rows = m.rows[keep]
    bare = tbsr.BSRMatrix(
        blocks_t=m.blocks_t[keep].contiguous(), rows=rows, cols=m.cols[keep],
        row_start=torch.searchsorted(rows, torch.arange(8, dtype=torch.int32)
                                     ).to(torch.int32),
        n=m.n, block=B)
    assert bare.nnzb < m.nnzb
    assert torch.equal(bsr_matvec(bare)(torch.from_numpy(
        x.astype(np.float32))), y)


def test_bsr_from_arrays_rejects_malformed_arrays(jm32):
    d = tbsr.as_arrays(jm32)
    bad = dict(d, cols=np.asarray(d["cols"]) + 100)
    with pytest.raises(ValueError):
        tbsr.bsr_from_arrays(bad, device="cpu")


def test_plain_bsr_ladder_matches_reference():
    jm64 = jbsr.random_bsr_spd(512, 32, 4, jax.random.PRNGKey(11),
                               dtype=jnp.float64)
    jm32 = dataclasses.replace(jm64, blocks_t=jm64.blocks_t.astype(
        jnp.float32))
    kw = dict(n_targ=4, n_max=8, max_iter=150, tol=1e-10)
    guess = np.random.default_rng(4).uniform(-0.5, 0.5, (8, 512))
    d = np.array(jbsr.bsr_diagonal(jm64))
    ref = j_ladder(jbsr.bsr_matvec(jm32), j_diag_precnd(d.astype(np.float32)),
                   jbsr.bsr_matvec(jm64), j_diag_precnd(d),
                   jnp.asarray(guess), JOptions(**kw),
                   key=jax.random.PRNGKey(1))
    m64 = _carry(jm64)
    m32 = _carry(jm32)
    td = torch.from_numpy(d)
    res = davidson_ladder(bsr_matvec(m32), diag_precnd(td.float()),
                          bsr_matvec(m64), diag_precnd(td),
                          torch.from_numpy(guess), SolverOptions(**kw))
    assert res.ok and bool(ref.ok) and res.ortho_ok
    np.testing.assert_allclose(res.eig[:4].numpy(), np.asarray(ref.eig[:4]),
                               rtol=0, atol=1e-10)
    assert abs(res.n_iter - int(ref.n_iter)) <= 2
    w = np.linalg.eigvalsh(np.asarray(jbsr.bsr_to_dense(jm64)))[:4]
    np.testing.assert_allclose(res.eig[:4].numpy(), w, rtol=0, atol=1e-10)
