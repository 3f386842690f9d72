"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip elsewhere.  They import
no JAX, so they also run where only the port's dependencies are installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Every kernel output here is integer (planes, int32 level sums) and must be
bitwise equal to the plain version; the float64 matvec is held to the
dense oracle at 1e-14 max|y|.
"""

import pytest
import torch

from diaglib_tpu_torch.ops import slicing
from diaglib_tpu_torch.ops.bsr import bsr_to_dense, random_bsr_spd
from diaglib_tpu_torch.ops.bsr_sliced import _slice_x
from diaglib_tpu_torch.ops.bsr_sliced_sym import (
    slice_bsr_sym,
    sym_sliced_matvec,
    sym_spmm,
    sym_spmm_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _scaled_rows(k, n, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((k, n), generator=g, dtype=torch.float64, device=dev)
    x = x * 2.0 ** torch.randint(-30, 30, (k, 1), generator=g, device=dev)
    x[:, :5] *= 2.0 ** -40
    s = 2.0 * slicing.pow2_grid(x.abs().amax(dim=1, keepdim=True))
    return (x / s).to(dtype)


@pytest.mark.parametrize("dtype,nx,bits", [(torch.float64, 8, 7),
                                           (torch.float32, 4, 7),
                                           (torch.float64, 9, 6)])
def test_peel_bit_equal(dev, dtype, nx, bits):
    t = _scaled_rows(5, 1000, dtype, dev, 1)     # a ragged last block
    before = slicing.peel_rows.launches
    got = slicing.peel_rows(t, nx, bits)
    torch.cuda.synchronize()
    assert slicing.peel_rows.launches == before + 1
    assert torch.equal(got, slicing.peel_rows_plain(t, nx, bits))


def test_peel_components_bit_equal(dev):
    t = _scaled_rows(4, 512, torch.float64, dev, 2)
    hi = t.float()
    d = t - hi.double()
    mid = d.float()
    lo = (d - mid.double()).float()
    got = slicing.peel_rows((hi, mid, lo), 8, 7)
    assert torch.equal(got, slicing.peel_rows_plain((hi, mid, lo), 8, 7))
    assert torch.equal(got, slicing.peel_rows(t, 8, 7))


def test_pow2_grid_exact_on_card(dev):
    m = torch.tensor([0.0, 1e-300, 3.0, 4.0, 1e300, 2.0 ** -1022, 7e-310],
                     dtype=torch.float64)
    got = slicing.pow2_grid(m.to(dev)).cpu()
    assert torch.equal(got, slicing.pow2_grid(m))
    mant, _ = torch.frexp(got)
    assert bool((mant == 0.5).all())


@pytest.fixture(scope="module")
def small_store(dev):
    m = random_bsr_spd(512, 64, 3, seed=3, dtype=torch.float32, device=dev)
    return m, slice_bsr_sym(m)


@pytest.mark.parametrize("k", [3, 17])
@pytest.mark.parametrize("tier", [torch.float64, torch.float32])
def test_sym_spmm_bit_equal(dev, small_store, k, tier):
    _, s = small_store
    nx, nlev, na_used = (8, 9, s.na) if tier == torch.float64 else (4, 4, 4)
    g = torch.Generator(device=dev).manual_seed(k)
    x = torch.randn((k, s.n), generator=g, dtype=torch.float64, device=dev)
    xs, _ = _slice_x((x * s.u_scale).to(tier), nx)
    got = torch.zeros((nlev * k, s.n), dtype=torch.int32, device=dev)
    want = torch.zeros_like(got)
    for rows, cols, sl, off in ((s.rows, s.cols, s.slices, 0),
                                (s.rows1, s.cols1, s.slices1, 1)):
        na = min(na_used - off, sl.shape[-1] // s.block)
        sym_spmm(xs, sl, rows, cols, got, nx=nx, na=na, nlev=nlev,
                 plane_off=off)
        sym_spmm_plain(xs, sl, rows, cols, want, nx=nx, na=na, nlev=nlev,
                       plane_off=off)
    torch.cuda.synchronize()
    assert bool(want.ne(0).any())
    assert torch.equal(got, want)


def test_f64_matvec_matches_dense(dev):
    m = random_bsr_spd(2048, 256, 4, seed=4, dtype=torch.float32, device=dev)
    s = slice_bsr_sym(m)
    dense = bsr_to_dense(m).double()
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((15, 2048), generator=g, dtype=torch.float64, device=dev)
    y = sym_sliced_matvec(s)(x)
    ref = x @ dense.T
    assert float((y - ref).abs().max()) <= 1e-14 * float(ref.abs().max())


def test_wrappers_check_their_inputs(dev, small_store):
    _, s = small_store
    with pytest.raises(ValueError):
        slicing.peel_rows(torch.zeros((2, 4), dtype=torch.int32, device=dev),
                          4, 7)
    xs = torch.zeros((8 * 2, s.n), dtype=torch.int8, device=dev)
    acc = torch.zeros((9 * 2, s.n), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        sym_spmm(xs, s.slices, s.rows.long(), s.cols, acc, nx=8, na=8,
                 nlev=9, plane_off=0)
