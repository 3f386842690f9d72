"""The exact wide-rotation product (kernel K3's plain version) and its
routing, port against the JAX package.

The same numpy operands go to both packages; JAX runs its Pallas
``_wide_kernel`` in interpret mode.  The a-slices and both power-of-two
scales are integers and powers of two, so they must be bit-equal; the
float64 result is held to the numpy oracle at 1e-14 max|ref| (the
reference's own bound) and to JAX's result bit for bit (both combine the
levels into the same exact float32 triple, in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu.ops import slicing as jsl
from diaglib_tpu.utils import mm as jmm
from diaglib_tpu_torch import SolverOptions, davidson
from diaglib_tpu_torch.ops import slicing as tsl
from diaglib_tpu_torch.problems import dense_matvec, diag_precnd, symm_matrix
from diaglib_tpu_torch.utils import mm as tmm


def _rng(seed):
    return np.random.default_rng(seed)


def _case(name):
    """The operands of tests/test_sliced.py's wide-kernel cases, made with
    numpy: (a, b) with a (m, K), b (K, n)."""
    if name == "dynamic_range":
        r = _rng(11)
        a = r.standard_normal((15, 165)) * np.exp(
            2.0 * r.standard_normal((15, 165)))
        return a, r.standard_normal((165, 8192))
    if name == "correlated":
        a, b = _case("dynamic_range")
        return np.tile(b[:, 0][None, :], (15, 1)) + 1e-9 * a, b
    if name == "masked":
        r = _rng(3)
        a = r.standard_normal((15, 165))
        b = r.standard_normal((165, 4096))
        a[:, 30:] = 0.0
        b[30:] = 0.0
        return a, b
    if name == "transposed":
        r = _rng(7)
        c_t = r.standard_normal((165, 15))
        b = r.standard_normal((165, 4096)) * np.exp(
            3.0 * r.standard_normal((1, 4096)))
        return c_t.T, b
    if name == "zero_row_col":
        a, b = _case("transposed")
        a, b = a.copy(), b.copy()
        a[0] = 0.0
        b[:, 0] = 0.0
        return a, b
    if name == "odd_k":
        r = _rng(5)
        return r.standard_normal((1, 13)), r.standard_normal((13, 1024))
    # the edges of b's column grid, which the CUDA kernel computes itself;
    # no column max is an exact power of two (JAX's CPU log2 overshoots
    # there, see test_pow2_grid_reference_log2_overshoot)
    if name in ("zero_cols", "tiny_cols", "huge_cols"):
        r = _rng(17)
        a = r.standard_normal((15, 165)) * np.exp(
            r.standard_normal((15, 165)))
        b = r.standard_normal((165, 2048))
        if name == "zero_cols":
            b[:, [0, 5, 2047]] = 0.0
            a[[2, 14]] = 0.0
        elif name == "tiny_cols":
            b[:, 0] *= 1e-310           # a denormal max: grid 1
            b[:, 1] *= 1e-300
            b[:, 2] *= 1e-200
        else:
            b[:, 0] *= 1e300
            b[:, 1] *= 1e200
        return a, b
    raise KeyError(name)


CASES = ["dynamic_range", "correlated", "masked", "transposed",
         "zero_row_col", "odd_k", "zero_cols", "tiny_cols", "huge_cols"]


@pytest.mark.parametrize("name", CASES)
def test_wide_operands_bit_equal(name):
    a, b = _case(name)
    a_sl, sa, sb = tsl._wide_operands(torch.from_numpy(a),
                                      torch.from_numpy(b))
    k = a.shape[1]
    kp = k + (-k) % 8                   # the reference pads K to 8
    ja, jsa = jsl.slice_operand(jnp.pad(jnp.asarray(a), ((0, 0), (0, kp - k))),
                                axis=-1, n_slices=8, bits=7)
    jsb = 2.0 * jsl.pow2_grid(jnp.max(jnp.abs(jnp.asarray(b)), axis=0,
                                      keepdims=True))
    np.testing.assert_array_equal(a_sl.numpy(), np.asarray(ja)[:, :, :k])
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jsb))


@pytest.mark.parametrize("name", CASES)
def test_sliced_wide_mm_matches_reference(name):
    a, b = _case(name)
    ta = torch.from_numpy(a)
    if name == "transposed":
        ta = torch.from_numpy(np.ascontiguousarray(a.T)).T   # mTm's layout
    y = tsl.sliced_wide_mm(ta, torch.from_numpy(b)).numpy()
    ref = a @ b
    scale = max(np.max(np.abs(ref)), 1e-30)
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-14 * scale)
    jy = np.asarray(jsl.sliced_wide_mm(jnp.asarray(a), jnp.asarray(b),
                                       interpret=True))
    np.testing.assert_array_equal(y, jy)
    if name == "zero_row_col":
        assert np.max(np.abs(y[0])) == 0.0
        assert np.max(np.abs(y[:, 0])) == 0.0


def test_sliced_wide_mm_plain_is_the_cpu_route():
    a, b = (torch.from_numpy(v) for v in _case("dynamic_range"))
    before = tsl.sliced_wide_mm.launches
    assert torch.equal(tsl.sliced_wide_mm(a, b),
                       tsl.sliced_wide_mm_plain(a, b))
    assert tsl.sliced_wide_mm.launches == before   # no kernel on the CPU


@pytest.mark.parametrize("bad", ["f32", "shape", "k_budget"])
def test_sliced_wide_mm_rejects(bad):
    a = torch.zeros((2, 8), dtype=torch.float64)
    b = torch.zeros((8, 16), dtype=torch.float64)
    if bad == "f32":
        a = a.float()
    elif bad == "shape":
        b = b[:7]
    else:
        a = torch.zeros((2, 300000), dtype=torch.float64)
        b = torch.zeros((300000, 1), dtype=torch.float64)
    with pytest.raises(ValueError):
        tsl.sliced_wide_mm(a, b)


def test_wide_scratch_is_kept_per_stream_and_grown():
    # the kernel's scratch (a's planes, grids, tile counters) is one buffer
    # a (device, stream); the CPU device stands in for the card here
    cpu = torch.device("cpu")
    assert tsl._wide_scratch_bytes(15, 165) == 6 * 4096 + 128 + 4
    assert tsl._wide_scratch_bytes(17, 33) == 2 * (2 * 4096 + 128 + 4)
    small = tsl._wide_scratch(cpu, 7, tsl._wide_scratch_bytes(15, 165))
    assert tsl._wide_scratch(cpu, 7, 100) is small
    other = tsl._wide_scratch(cpu, 8, 100)
    assert other is not small
    big = tsl._wide_scratch(cpu, 7, small.numel() + 1)
    assert big.numel() > small.numel()
    assert tsl._wide_scratch(cpu, 7, 100) is big
    assert tsl._wide_scratch(cpu, 8, 100) is other
    # the replaced buffer stays alive for the graphs captured over it
    assert tsl._wide_replaced[-1] is small
    tsl._wide_replaced.pop()
    for key in [(None, 7), (None, 8)]:
        tsl._wide_scratches.pop(key)


@pytest.mark.parametrize("k", [1, 165, 1500, 4096, 262140, 262144])
def test_wide_feasible_keeps_the_int32_bound(k):
    # the reference's K * 2^13 <= 2^31 bound, over K padded to 4; the TPU
    # lane-tile model is dropped on purpose (K = 1500 and 4096 run here)
    assert tsl.wide_feasible(15, k, 65536) == (k + (-k) % 4 <= 2 ** 18)


CUDA = torch.device("cuda")   # a device name only: no card is touched


@pytest.mark.parametrize("dtype,device,k,m,n,want", [
    (torch.float64, CUDA, 165, 15, 65536, True),     # the flagship rotation
    (torch.float64, CUDA, 4096, 1024, 8192, True),   # every guard at its edge
    (torch.float32, CUDA, 165, 15, 65536, False),    # float64 only
    (torch.float64, CUDA, 165, 15, 4096, False),     # n >= 8192
    (torch.float64, CUDA, 165, 15, 8192 + 128, False),   # n % 256 == 0
    (torch.float64, CUDA, 4097, 15, 65536, False),   # k <= 4096
    (torch.float64, CUDA, 165, 1025, 65536, False),  # m <= 1024
    (torch.float64, torch.device("cpu"), 165, 15, 65536, False),  # CUDA only
])
def test_use_wide_guards(dtype, device, k, m, n, want):
    with tmm.mm_routing(wide="always"):
        assert tmm._use_wide(dtype, device, k, m, n) is want
    # the reference makes the same shape decisions (its backend check
    # aside): on this CPU it never takes the route
    with jmm.mm_routing(wide="always"):
        assert jmm._use_wide(jnp.float64 if dtype == torch.float64
                             else jnp.float32, k, m, n) is False


@pytest.mark.parametrize("wide,sliced,want", [
    ("always", None, True), ("never", None, False), ("auto", None, False),
    (None, None, False), ("always", "never", False)])
def test_use_wide_modes(wide, sliced, want):
    with tmm.mm_routing(wide=wide, sliced=sliced):
        assert tmm._use_wide(torch.float64, CUDA, 165, 15, 65536) is want


@pytest.mark.parametrize("driver", ["davidson", "gen_david", "lobpcg",
                                    "caslr", "caslr_eff", "nonsym", "other"])
@pytest.mark.parametrize("mode", ["auto", "always", "never"])
def test_routing_for_resolves_like_the_reference(driver, mode):
    opts = SolverOptions(n_targ=1, n_max=1, wide_mm=mode)
    with tmm.routing_for(opts, driver) as r:
        got = (r.wide, tmm._ROUTING["wide"])
    with jmm.routing_for(opts, driver) as jr:
        want = jr.wide
    assert got == (want, want)
    assert tmm._ROUTING["wide"] is None    # restored on exit


def test_wide_mm_always_runs_and_leaves_the_cpu_solve_unchanged():
    a = symm_matrix(300, device="cpu")
    guess = torch.from_numpy(_rng(1).uniform(-0.5, 0.5, (6, 300)))
    res = {}
    for mode in ("always", "never"):
        opts = SolverOptions(n_targ=4, n_max=6, tol=1e-9, wide_mm=mode)
        res[mode] = davidson(dense_matvec(a), diag_precnd(torch.diagonal(a)),
                             guess, opts)
    assert res["always"].ok
    assert torch.equal(res["always"].eig, res["never"].eig)
    assert res["always"].n_iter == res["never"].n_iter
