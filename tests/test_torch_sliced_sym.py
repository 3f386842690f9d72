"""The symmetric sliced BSR store and matvec of the PyTorch port against
the JAX package.

JAX's ``random_bsr_spd`` matrix is carried across as arrays, so both
packages slice the same operator.  The store is integers and powers of two
and must be bit-equal; the matvecs agree to float64 rounding.  The JAX
matvec runs its Pallas kernels in interpret mode, the port its plain
versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu.ops.bsr import BSRMatrix as JBSRMatrix
from diaglib_tpu.ops.bsr import bsr_to_dense as j_bsr_to_dense
from diaglib_tpu.ops.bsr import random_bsr_spd as j_random_bsr_spd
from diaglib_tpu.ops.bsr_sliced_sym import slice_bsr_sym as j_slice_bsr_sym
from diaglib_tpu.ops.bsr_sliced_sym import sym_sliced_matvec as j_matvec
from diaglib_tpu_torch.ops.bsr import bsr_from_arrays, bsr_to_dense
from diaglib_tpu_torch.ops.bsr_sliced_sym import (
    slice_bsr_sym,
    sym_sliced_matvec,
    sym_spmm,
    sym_spmm_plain,
    sym_store_from_arrays,
    sym_worklist,
)

STORE_FIELDS = ("slices", "slices1", "u_scale", "rows", "cols", "rows1",
                "cols1", "diagonal")


def _arrays(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _jax_problem(source):
    m = j_random_bsr_spd(256, 64, 3, jax.random.PRNGKey(0),
                         dtype=jnp.float32)
    if source == "f64":
        m = dataclasses.replace(m, blocks_t=m.blocks_t.astype(jnp.float64))
    return m


@pytest.fixture(scope="module", params=["f32", "f64"])
def problem(request):
    """(JAX BSR, JAX store, port BSR, port store, dense f64 oracle)."""
    jm = _jax_problem(request.param)
    js = j_slice_bsr_sym(jm)
    tm = bsr_from_arrays(_arrays(jm), device="cpu")
    ts = slice_bsr_sym(tm)
    dense = np.asarray(j_bsr_to_dense(jm), np.float64)
    return jm, js, tm, ts, dense


def test_carried_bsr_is_the_same_matrix(problem):
    jm, _, tm, _, dense = problem
    np.testing.assert_array_equal(bsr_to_dense(tm).double().numpy(), dense)
    assert np.array_equal(dense, dense.T)


def test_store_bit_equal(problem):
    _, js, _, ts, _ = problem
    for name in STORE_FIELDS:
        ref = np.asarray(getattr(js, name))
        got = getattr(ts, name).numpy()
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert (ts.n, ts.block, ts.na, ts.max_row_terms) == (
        js.n, js.block, js.na, js.max_row_terms)
    assert ts.nnz == js.nnz and ts.nnzb_stored == js.nnzb_stored
    # the flagship generator sheds plane 0 of every off-diagonal entry
    assert ts.slices1.shape[0] > 0


def test_store_from_arrays_round_trip(problem):
    _, js, _, ts, _ = problem
    carried = sym_store_from_arrays(_arrays(js), device="cpu")
    for name in STORE_FIELDS:
        assert torch.equal(getattr(carried, name), getattr(ts, name)), name


def test_f64_tier_matvec(problem):
    _, js, _, ts, dense = problem
    x = np.random.default_rng(2).standard_normal((8, 256))
    ref_j = np.asarray(j_matvec(js, interpret=True)(jnp.asarray(x)))
    y = sym_sliced_matvec(ts)(torch.from_numpy(x))
    assert y.dtype == torch.float64
    oracle = x @ dense.T
    scale = np.max(np.abs(oracle))
    np.testing.assert_allclose(y.numpy(), ref_j, rtol=0, atol=1e-15 * scale)
    np.testing.assert_allclose(y.numpy(), oracle, rtol=0, atol=1e-14 * scale)


def test_f32_tier_matvec(problem):
    _, js, _, ts, dense = problem
    x = np.random.default_rng(3).standard_normal((8, 256)).astype(np.float32)
    ref_j = np.asarray(j_matvec(js, dtype=jnp.float32, interpret=True)(
        jnp.asarray(x)), np.float64)
    y = sym_sliced_matvec(ts, dtype=torch.float32)(torch.from_numpy(x))
    assert y.dtype == torch.float32
    oracle = x.astype(np.float64) @ dense.T
    scale = np.max(np.abs(oracle))
    assert np.max(np.abs(y.double().numpy() - oracle)) / scale < 2.0 ** -17
    # float32 combine order may differ from XLA's by a few float32 ulps
    assert np.max(np.abs(y.double().numpy() - ref_j)) / scale < 2.0 ** -21


def _naive_levels(xs, slices, rows, cols, nx, na, nlev, plane_off, B):
    """Level sums by explicit loops over entries and plane pairs (int64)."""
    k = xs.shape[0] // nx
    n = xs.shape[1]
    x = xs.reshape(nx, k, n).astype(np.int64)
    acc = np.zeros((nlev, k, n), np.int64)
    for e in range(slices.shape[0]):
        r, c = int(rows[e]), int(cols[e])
        for i in range(na):
            t = slices[e][:, i * B:(i + 1) * B].astype(np.int64)
            for ix in range(nx):
                lev = plane_off + i + ix
                if lev >= nlev:
                    continue
                acc[lev, :, r * B:(r + 1) * B] += x[ix, :, c * B:(c + 1) * B] @ t
                if r != c:
                    acc[lev, :, c * B:(c + 1) * B] += (
                        x[ix, :, r * B:(r + 1) * B] @ t.T)
    return acc.reshape(nlev * k, n)


@pytest.mark.parametrize("nx,nlev", [(8, 9), (4, 4)])
def test_sym_spmm_plain_is_the_level_sum(problem, nx, nlev):
    _, _, _, ts, _ = problem
    rng = np.random.default_rng(4)
    k, B = 3, ts.block
    xs = rng.integers(-64, 65, (nx * k, ts.n)).astype(np.int8)
    acc = torch.zeros((nlev * k, ts.n), dtype=torch.int32)
    want = np.zeros((nlev * k, ts.n), np.int64)
    for rows, cols, slices, off in ((ts.rows, ts.cols, ts.slices, 0),
                                    (ts.rows1, ts.cols1, ts.slices1, 1)):
        na = min((4 if nx == 4 else ts.na) - off, slices.shape[-1] // B)
        sym_spmm(torch.from_numpy(xs), slices, rows, cols, acc, nx=nx, na=na,
                 nlev=nlev, plane_off=off)
        want += _naive_levels(xs, slices.numpy(), rows.numpy(), cols.numpy(),
                              nx, na, nlev, off, B)
    np.testing.assert_array_equal(acc.numpy(), want)
    # the plain version adds into what the accumulator holds
    again = sym_spmm_plain(torch.from_numpy(xs), ts.slices, ts.rows, ts.cols,
                           acc.clone(), nx=nx, na=min(ts.na, 4 if nx == 4
                                                      else 8),
                           nlev=nlev, plane_off=0)
    assert not torch.equal(again, acc)


def test_empty_bucket1_uniform_magnitudes():
    """Off-diagonal blocks at the diagonal's magnitude keep every entry in
    the full-width bucket (empty bucket 1); the matvec stays exact."""
    nbr, B = 4, 256
    n = nbr * B
    rng = np.random.default_rng(3)
    dense = rng.standard_normal((n, n))
    dense = np.triu(dense) + np.triu(dense, 1).T
    rows, cols, blocks = [], [], []
    for r in range(nbr):
        for c in range(r, nbr):
            rows.append(r)
            cols.append(c)
            blocks.append(dense[r*B:(r+1)*B, c*B:(c+1)*B].T)
    jm = JBSRMatrix(
        blocks_t=jnp.asarray(np.stack(blocks), jnp.float32).astype(
            jnp.float64),
        rows=jnp.asarray(rows, jnp.int32), cols=jnp.asarray(cols, jnp.int32),
        row_start=jnp.asarray([0, 4, 7, 9], jnp.int32), n=n, block=B)
    js = j_slice_bsr_sym(jm)
    ts = slice_bsr_sym(bsr_from_arrays(_arrays(jm), device="cpu"))
    assert ts.slices1.shape[0] == 0 and ts.slices.shape[0] == 10
    for name in STORE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    x = rng.standard_normal((4, n))
    y = sym_sliced_matvec(ts)(torch.from_numpy(x)).numpy()
    a64 = np.asarray(j_bsr_to_dense(jm), np.float64)
    a_sym = np.triu(a64) + np.triu(a64, 1).T
    ref = x @ a_sym.T
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(y - ref)) / scale < 1e-14
    y_j = np.asarray(j_matvec(js, interpret=True)(jnp.asarray(x)))
    assert np.max(np.abs(y - y_j)) / scale < 1e-15


@pytest.mark.parametrize("field,value", [("cols1", 99), ("rows", -1)])
def test_store_from_arrays_rejects_bad_coordinates(problem, field, value):
    _, js, _, _, _ = problem
    d = _arrays(js)
    d[field] = d[field].copy()
    d[field][0] = value
    with pytest.raises(ValueError, match="malformed"):
        sym_store_from_arrays(d, device="cpu")


@pytest.mark.parametrize("bucket", [0, 1])
def test_worklist_covers_every_pair_once(problem, bucket):
    """Kernel K1's work list on the store carried from JAX: each (entry,
    direction) pair exactly once, under the block row it adds to, and no
    mirror on the diagonal."""
    _, js, _, _, _ = problem
    st = sym_store_from_arrays(_arrays(js), device="cpu")
    rows, cols = (st.rows, st.cols) if bucket == 0 else (st.rows1, st.cols1)
    nbr = st.n // st.block
    items, start = sym_worklist(rows, cols, nbr)
    assert items.dtype == start.dtype == torch.int32
    assert start.shape == (nbr + 1,) and int(start[0]) == 0
    assert bool((start[1:] >= start[:-1]).all())
    assert int(start[-1]) == items.shape[0]
    r, c = rows.numpy(), cols.numpy()
    seen = []
    for dest in range(nbr):
        for v in items[int(start[dest]):int(start[dest + 1])].tolist():
            e, mirror = divmod(v, 2)
            assert dest == (c[e] if mirror else r[e])
            seen.append((e, mirror))
    want = [(e, 0) for e in range(r.size)] + [
        (e, 1) for e in range(r.size) if r[e] != c[e]]
    assert sorted(seen) == sorted(want) and len(seen) == len(set(seen))
    # bucket 0 holds the diagonal here, bucket 1 the off-diagonal entries
    assert r.size and bool((r != c).any()) == (bucket == 1)


def test_plain_version_ignores_the_worklist(problem):
    _, _, _, ts, _ = problem
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(rng.integers(-64, 65, (4 * 2, ts.n)).astype(
        np.int8))
    kw = dict(nx=4, na=4, nlev=4, plane_off=0)
    want = sym_spmm_plain(xs, ts.slices, ts.rows, ts.cols,
                          torch.zeros((8, ts.n), dtype=torch.int32), **kw)
    items, start = sym_worklist(ts.rows, ts.cols, ts.n // ts.block)
    for fn in (sym_spmm_plain, sym_spmm):
        got = fn(xs, ts.slices, ts.rows, ts.cols,
                 torch.zeros((8, ts.n), dtype=torch.int32), **kw,
                 items=items, item_start=start)
        assert torch.equal(got, want)
