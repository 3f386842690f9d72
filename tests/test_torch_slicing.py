"""Integer slicing of the PyTorch port against the JAX package.

The slice planes and power-of-two grids are integers and exact powers of
two, so the port must reproduce them bit for bit.  The JAX side runs its
Pallas peel kernel in interpret mode; the port side runs the plain torch
version of its CUDA kernel (the wrapper takes it for CPU tensors).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu.ops import bsr_sliced as jbs
from diaglib_tpu.ops import slicing as jsl
from diaglib_tpu_torch.ops import bsr_sliced as tbs
from diaglib_tpu_torch.ops import slicing as tsl


def _edge_values(dtype):
    fi = np.finfo(dtype)
    ks = range(fi.minexp, fi.maxexp)
    vals = [0.0, -1.0, 1e-30, 1e30]
    if dtype == np.float64:
        vals += [1e-300, 1e300]
    for k in ks:
        p = dtype(2.0) ** dtype(k)
        vals += [p, np.nextafter(p, dtype(0)), np.nextafter(p, dtype(np.inf))]
    return np.asarray(vals, dtype)


def _least_pow2(v):
    """Least power of two >= v by exact integer frexp, its exponent clamped
    to the normal float64 range; values below the smallest normal number of
    v's dtype (zero, negatives, denormals) -> 1."""
    tiny = np.finfo(v.dtype).tiny
    out = []
    for x in v.astype(np.float64):
        if not x >= tiny:
            out.append(1.0)
            continue
        mant, e = math.frexp(x)
        e = e - 1 if mant == 0.5 else e
        out.append(math.ldexp(1.0, min(max(e, -1022), 1023)))
    return np.asarray(out)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_pow2_grid_bit_equal_on_edge_values(dtype):
    v = _edge_values(dtype)
    ref = np.asarray(jsl.pow2_grid(jnp.asarray(v)))
    got = tsl.pow2_grid(torch.from_numpy(v)).numpy()
    assert got.dtype == np.float64
    # the port's contract: the least power of two >= v, 0 -> 1
    np.testing.assert_array_equal(got, _least_pow2(v))
    same = ref.view(np.int64) == got.view(np.int64)
    # every difference is the reference's log2 fault pinned below
    diff = ~same
    assert np.all(ref[diff] == 2.0 * got[diff])
    assert np.all(np.asarray(jnp.ceil(jnp.log2(jnp.asarray(v[diff]))))
                  > np.log2(got[diff]))
    # zero, 1e+-300 and the bump past 2^k all agree bit for bit
    for x in (0.0, 1e-30, 1e30) + ((1e-300, 1e300) if dtype == np.float64
                                   else ()):
        i = int(np.nonzero(v == dtype(x))[0][0])
        assert same[i], x
    for k in (-20, 0, 1, 10, 30):
        p = dtype(2.0) ** dtype(k)
        i = int(np.nonzero(v == np.nextafter(p, dtype(np.inf)))[0][0])
        assert same[i] and got[i] == 2.0 ** (k + 1)


def test_pow2_grid_reference_log2_overshoot():
    """Reference fault (diaglib_tpu/ops/slicing.py:77): on the CPU backend
    jnp.log2 of some exact powers of two rounds above the integer, so the
    reference returns 2*m where m is already on the grid.  The port returns
    m, the documented least power of two."""
    v = np.asarray([2.0 ** -3, 2.0 ** 55], np.float64)
    l2 = np.asarray(jnp.log2(jnp.asarray(v)))
    bad = l2 != np.log2(v)
    ref = np.asarray(jsl.pow2_grid(jnp.asarray(v)))
    got = tsl.pow2_grid(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, v)
    np.testing.assert_array_equal(ref[bad], 2.0 * v[bad])
    np.testing.assert_array_equal(ref[~bad], v[~bad])


def _scaled_rows(rng, k, n, dtype):
    """Pre-scaled rows |t| <= 1/2 with magnitudes over many octaves."""
    x = rng.standard_normal((k, n)) * 2.0 ** rng.integers(-40, 40, (k, 1))
    x[:, :7] *= 2.0 ** -30                    # deep tails in every row
    s = 2.0 * _least_pow2(np.abs(x).max(axis=1)).reshape(k, 1)
    return (x / s).astype(dtype)


@pytest.mark.parametrize("dtype,nx", [(np.float64, 8), (np.float32, 4)])
def test_peel_rows_plain_bit_equal(dtype, nx):
    t = _scaled_rows(np.random.default_rng(11), 6, 256, dtype)
    ref = np.asarray(jsl._peel_rows_pallas(jnp.asarray(t), nx, 7,
                                           interpret=True))
    got = tsl.peel_rows(torch.from_numpy(t), nx, 7)
    assert got.dtype == torch.int8 and tuple(got.shape) == (nx, 6, 256)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(tsl.peel_rows_plain(torch.from_numpy(t),
                                                      nx, 7).numpy(), ref)


def test_peel_rows_components_bit_equal():
    t = _scaled_rows(np.random.default_rng(12), 4, 256, np.float64)
    hi = t.astype(np.float32)
    d = t - hi.astype(np.float64)
    mid = d.astype(np.float32)
    lo = (d - mid.astype(np.float64)).astype(np.float32)
    ref = np.asarray(jsl._peel_rows_pallas(
        (jnp.asarray(hi), jnp.asarray(mid), jnp.asarray(lo)), 8, 7,
        interpret=True))
    got = tsl.peel_rows(tuple(torch.from_numpy(a) for a in (hi, mid, lo)),
                        8, 7)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype,nx", [(np.float64, 8), (np.float32, 4)])
def test_slice_x_bit_equal(dtype, nx):
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((5, 256))
         * 2.0 ** rng.integers(-20, 20, (5, 1))).astype(dtype)
    x[2] = 0.0                                 # an all-zero row
    ref_planes, ref_sx = jbs._slice_x(jnp.asarray(x), nx, interpret=True)
    planes, sx = tbs._slice_x(torch.from_numpy(x), nx)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(ref_planes))
    assert sx.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(sx.numpy(), np.asarray(ref_sx))
    assert float(sx[2, 0]) == 2.0 and not planes.reshape(nx, 5, 256)[:, 2].any()


def _front_end_rows(dtype, k=8, n=256, seed=14):
    """Rows for the fused front end: an all-zero row, rows 2^+-1000 apart
    in scale (2^+-100 in float32), a row of quotients below the least
    normal number of the work type, and rows over +-20 octaves."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((k, n)) * 2.0 ** rng.integers(-20, 20, (k, 1))
    big = 1000 if dtype == np.float64 else 100
    x[0] = 0.0
    x[2] *= 2.0 ** big
    x[3] *= 2.0 ** -big
    if dtype == np.float64:                  # quotients near 2^-1031
        x[4] = rng.standard_normal(n) * 2.0 ** 100
        x[4, ::3] *= 2.0 ** -1030
    else:                                    # quotients near 2^-131
        x[4] = rng.standard_normal(n) * 2.0 ** 60
        x[4, ::3] *= 2.0 ** -130
    return x.astype(dtype)


# (x's dtype, nx, the accumulation type, the symmetric store's fold)
FRONT_ENDS = [(np.float64, 8, np.float64, False),   # general, f64 tier
              (np.float64, 8, np.float64, True),    # sym, f64 tier
              (np.float32, 8, np.float32, False),   # f32 x at nx 8
              (np.float32, 4, np.float32, False),   # general, f32 tier
              (np.float32, 4, np.float32, True),    # sym, f32 tier
              (np.float64, 4, np.float32, True),    # sym, f32 tier, f64 x
              (np.float64, 4, np.float64, False)]   # f64 x at nx 4


@pytest.mark.parametrize("dtype,nx,acc,fold", FRONT_ENDS)
def test_slice_rows_plain_bit_equal_to_reference(dtype, nx, acc, fold):
    """The fused front end's plain version against JAX's _slice_x (the peel
    kernel in interpret mode), with the symmetric matvec's fold of
    x.astype(acc) * u where the store has one."""
    x = _front_end_rows(dtype)
    u = None
    xj = jnp.asarray(x)
    if fold:
        u = 2.0 ** np.random.default_rng(15).integers(-10, 10, x.shape[1])
        xj = xj.astype(acc) * jnp.asarray(u).astype(acc)[None, :]
    ref_planes, ref_sx = jbs._slice_x(xj, nx, interpret=True)
    ref_planes = np.asarray(ref_planes).reshape(nx, *x.shape)
    tacc = torch.from_numpy(np.zeros(1, acc)).dtype
    kw = dict(col_scale=None if u is None else torch.from_numpy(u),
              acc_dtype=tacc, work_dtype=torch.float64 if nx > 4 else tacc)
    planes, sx = tsl.slice_rows_plain(torch.from_numpy(x), nx, **kw)
    assert planes.dtype == torch.int8 and sx.dtype == tacc
    np.testing.assert_array_equal(planes.numpy(), ref_planes)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(ref_sx))
    assert float(sx[0, 0]) == 2.0 and not planes[:, 0].any()
    assert planes[:, 4].any()                 # not every quotient is lost
    # the matvecs' entry and the wrapper take this chain on the CPU
    xs, sx2 = tbs._slice_x(torch.from_numpy(x), nx, col_scale=kw[
        "col_scale"], acc_dtype=tacc)
    assert torch.equal(xs, planes.reshape(nx * x.shape[0], -1))
    assert torch.equal(sx2, sx)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_slice_operand_at_7_bits_is_the_front_end(dtype):
    """slice_operand at 7 bits and up to 8 planes goes through the fused
    entry: the grid and planes of the unfused chain, the scale in
    float64."""
    x = torch.from_numpy(_front_end_rows(dtype, seed=16))
    planes, scale = tsl.slice_operand(x, -1, 8, 7)
    t, want_scale = tsl._row_grid(x, 7)
    assert scale.dtype == torch.float64
    assert torch.equal(scale, want_scale)
    assert torch.equal(planes, tsl.peel_rows_plain(t, 8, 7))


def test_combine_weights_match():
    for dt, jdt in ((torch.float64, jnp.float64), (torch.float32,
                                                   jnp.float32)):
        np.testing.assert_array_equal(
            tsl.combine_weights(9, 7, dt).numpy(),
            np.asarray(jsl.combine_weights(9, 7, jdt)))


def test_peel_rows_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        tsl.peel_rows(torch.zeros((2, 4), device="meta"), 4, 7)
