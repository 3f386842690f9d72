"""The general sliced BSR store, its level sums (kernel K5's plain version)
and its matvec in the PyTorch port, against the JAX package.

JAX's matrices are carried across as arrays, so both packages slice the
same operator.  The store is integers and powers of two and must be
bit-equal (``col_scale`` could differ only where a column max is an exact
power of two, where the reference's ``pow2_grid`` overshoots; the
normal-distributed data here has none).  The int32 level sums must be
equal to JAX's ``_sliced_spmm`` run in interpret mode on both of its
kernels; the matvecs agree with a dense float64 oracle to 1e-14 max|y|
(float64 tier) and to the reference's own 2^-17 (float32 tier).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu.ops import bsr_sliced as jbs
from diaglib_tpu.ops.bsr import bsr_from_dense as j_bsr_from_dense
from diaglib_tpu.ops.bsr import bsr_to_dense as j_bsr_to_dense
from diaglib_tpu.ops.bsr import random_bsr_spd as j_random_bsr_spd
from diaglib_tpu_torch.ops.bsr import (
    BSRMatrix,
    bsr_from_arrays,
    bsr_from_dense,
    random_bsr_spd,
)
from diaglib_tpu_torch.ops.bsr_sliced import (
    _slice_x,
    _tier_params,
    slice_bsr,
    sliced_bsr_matvec,
    sliced_spmm,
    sliced_spmm_plain,
    sliced_store_from_arrays,
)
from diaglib_tpu_torch.ops.bsr_sliced_sym import sliced_matvec_any

FIELDS = ("slices", "col_scale", "diagonal", "rows", "cols", "row_start")


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _empty_row_dense():
    """tests/test_sliced.py's matrix with block rows 1, 3 and 4 empty."""
    n, B = 6 * 32, 32
    rng = np.random.default_rng(1)
    dense = np.zeros((n, n))
    for r in (0, 2, 5):
        dense[r*B:(r+1)*B, r*B:(r+1)*B] = rng.standard_normal((B, B))
    return dense, B


@pytest.fixture(scope="module", params=["f32", "f64", "empty_rows"])
def problem(request):
    """(JAX BSR, JAX store, port store, dense f64 oracle)."""
    if request.param == "empty_rows":
        dense, B = _empty_row_dense()
        jm = j_bsr_from_dense(jnp.asarray(dense), B)
    else:
        jm = j_random_bsr_spd(256, 32, 3, jax.random.PRNGKey(0),
                              dtype=jnp.float32)
        if request.param == "f64":
            jm = dataclasses.replace(
                jm, blocks_t=jm.blocks_t.astype(jnp.float64))
    js = jbs.slice_bsr(jm)
    ts = slice_bsr(bsr_from_arrays(_arrays(jm), device="cpu"))
    return jm, js, ts, np.asarray(j_bsr_to_dense(jm), np.float64)


def test_store_bit_equal(problem):
    _, js, ts, _ = problem
    for name in FIELDS:
        ref = np.asarray(getattr(js, name))
        got = getattr(ts, name).numpy()
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert (ts.n, ts.block, ts.na, ts.max_bpr, ts.nnzb, ts.nnz) == (
        js.n, js.block, js.na, js.max_bpr, js.nnzb, js.nnz)
    carried = sliced_store_from_arrays(js, device="cpu")
    for name in FIELDS:
        assert torch.equal(getattr(carried, name), getattr(ts, name)), name


def test_port_bsr_from_dense_gives_the_reference_store():
    dense, B = _empty_row_dense()
    ts = slice_bsr(bsr_from_dense(dense, B))
    js = jbs.slice_bsr(j_bsr_from_dense(jnp.asarray(dense), B))
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)


@pytest.mark.parametrize("variant", ["resident", "revisit"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_level_sums_equal_the_reference_kernels(problem, monkeypatch,
                                                variant, dtype):
    """sliced_spmm_plain (and the wrapper on CPU tensors) against JAX's
    resident-accumulator kernel and its revisited-row-tile kernel
    (DIAGLIB_TPU_RESIDENT=never), int32 for int32."""
    _, js, ts, _ = problem
    if variant == "revisit":
        monkeypatch.setenv("DIAGLIB_TPU_RESIDENT", "never")
    jbs._sliced_spmm.clear_cache()
    nx, na_used, nlev = _tier_params(ts.na, dtype, None, None)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    x = np.random.default_rng(4).standard_normal((5, ts.n))
    x = (x * 2.0 ** np.arange(-6, 4, 2)[:, None]).astype(
        np.float64 if dtype == torch.float64 else np.float32)
    p_ref, sx_ref = jbs._sliced_spmm(js, jnp.asarray(x, jdt), nx=nx,
                                     nlev=nlev, na_used=na_used,
                                     interpret=True)
    jbs._sliced_spmm.clear_cache()
    xs, sx = _slice_x(torch.from_numpy(x), nx)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_ref))
    args = (xs, ts.slices, ts.rows, ts.cols, ts.row_start)
    kw = dict(nx=nx, na=na_used, nlev=nlev)
    got = sliced_spmm_plain(*args, **kw)
    assert got.dtype == torch.int32 and bool(got.ne(0).any())
    np.testing.assert_array_equal(got.numpy(), np.asarray(p_ref))
    assert torch.equal(sliced_spmm(*args, **kw), got)


def test_level_sums_by_explicit_loops():
    """The plain version against a loop over entries and plane pairs in
    int64, on a store with several entries a row and a ragged tier (the
    float32 tier reads a prefix of 4 of the 8 stored planes)."""
    ts = slice_bsr(random_bsr_spd(256, 64, 4, seed=2, device="cpu"))
    rng = np.random.default_rng(5)
    nx, na, nlev, k, B = 4, 4, 4, 3, ts.block
    xs = rng.integers(-64, 65, (nx * k, ts.n)).astype(np.int8)
    got = sliced_spmm_plain(torch.from_numpy(xs), ts.slices, ts.rows,
                            ts.cols, ts.row_start, nx=nx, na=na, nlev=nlev)
    x = xs.reshape(nx, k, ts.n).astype(np.int64)
    want = np.zeros((nlev, k, ts.n), np.int64)
    sl = ts.slices.numpy()
    for e in range(ts.nnzb):
        r, c = int(ts.rows[e]), int(ts.cols[e])
        for i in range(na):
            t = sl[e][:, i * B:(i + 1) * B].astype(np.int64)
            for ix in range(nx):
                if i + ix < nlev:
                    want[i + ix, :, r*B:(r+1)*B] += x[ix, :, c*B:(c+1)*B] @ t
    np.testing.assert_array_equal(got.numpy(), want.reshape(nlev * k, -1))


def test_f64_tier_matvec(problem):
    _, js, ts, dense = problem
    x = np.random.default_rng(2).standard_normal((8, ts.n))
    ref_j = np.asarray(jbs.sliced_bsr_matvec(js, interpret=True)(
        jnp.asarray(x)))
    y = sliced_bsr_matvec(ts)(torch.from_numpy(x))
    assert y.dtype == torch.float64
    oracle = x @ dense.T
    scale = np.max(np.abs(oracle))
    np.testing.assert_allclose(y.numpy(), oracle, rtol=0, atol=1e-14 * scale)
    np.testing.assert_allclose(y.numpy(), ref_j, rtol=0, atol=1e-15 * scale)
    if not dense[32:64].any():                 # the empty block rows
        assert float(y[:, 32:64].abs().max()) == 0.0


def test_f32_tier_matvec(problem):
    _, js, ts, dense = problem
    x = np.random.default_rng(3).standard_normal((8, ts.n)).astype(
        np.float32)
    ref_j = np.asarray(jbs.sliced_bsr_matvec(js, dtype=jnp.float32,
                                             interpret=True)(jnp.asarray(x)),
                       np.float64)
    y = sliced_bsr_matvec(ts, dtype=torch.float32)(torch.from_numpy(x))
    assert y.dtype == torch.float32
    oracle = x.astype(np.float64) @ dense.T
    scale = np.max(np.abs(oracle))
    assert np.max(np.abs(y.double().numpy() - oracle)) / scale < 2.0 ** -17
    # the float32 combine order may differ from XLA's by a few float32 ulps
    assert np.max(np.abs(y.double().numpy() - ref_j)) / scale < 2.0 ** -21


def test_sliced_matvec_any_dispatches_the_general_store(problem):
    _, _, ts, _ = problem
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, ts.n)))
    for dtype in (torch.float64, torch.float32):
        xd = x.to(dtype)
        assert torch.equal(sliced_matvec_any(ts, dtype=dtype)(xd),
                           sliced_bsr_matvec(ts, dtype=dtype)(xd))


def test_int32_guard():
    # one block row of 600 entries of B = 64 overflows int32 at 8 planes
    B, nbr = 64, 600
    rows = torch.zeros((nbr,), dtype=torch.int32)
    m = BSRMatrix(blocks_t=torch.zeros((nbr, B, B)), rows=rows,
                  cols=torch.arange(nbr, dtype=torch.int32),
                  row_start=torch.tensor([0] + [nbr] * (nbr - 1),
                                         dtype=torch.int32),
                  n=nbr * B, block=B)
    with pytest.raises(ValueError, match="overflows exact int32"):
        slice_bsr(m)
    # the per-tier guard of the matvec, on a store that claims as many
    ts = slice_bsr(random_bsr_spd(256, 64, 3, seed=3, device="cpu"))
    big = dataclasses.replace(ts, max_bpr=600)
    with pytest.raises(ValueError, match="overflow exact int32"):
        sliced_bsr_matvec(big)
    sliced_bsr_matvec(big, dtype=torch.float32, nx=1)   # 1 pair fits


def _bad(d, field):
    d = dict(d)
    if field == "unsorted_rows":
        d["rows"] = d["rows"][::-1].copy()
    elif field == "row_start":
        d["row_start"] = d["row_start"].copy()
        d["row_start"][1] += 1
    elif field == "cols":
        d["cols"] = d["cols"].copy()
        d["cols"][0] = 99
    elif field == "plane_width":
        d["na"] = d["na"] - 1
    elif field == "col_scale":
        d["col_scale"] = d["col_scale"][:-1]
    return d


@pytest.mark.parametrize("field", ["unsorted_rows", "row_start", "cols",
                                   "plane_width", "col_scale"])
def test_store_from_arrays_rejects_malformed_arrays(problem, field):
    _, js, _, _ = problem
    d = _arrays(js)
    sliced_store_from_arrays(d, device="cpu")       # the intact arrays pass
    with pytest.raises(ValueError, match="malformed"):
        sliced_store_from_arrays(_bad(d, field), device="cpu")

