"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU with nvcc and skip elsewhere.  They import
no JAX, so they also run where only the port's dependencies are installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

The peel (K2: its pre-scaled entry, and its fused entry from x to planes
and row scales as every caller drives it, at k = 1 to 33 rows and rows
longer than a cluster keeps in registers, strided rows, and rows of zeros,
inf, NaN and denormal quotients), the symmetric sliced SpMM (K1), the
general sliced SpMM (K5), the distributed group SpMM (K6, on an irregular
partition with padding entries and uncovered rows) and the wide-rotation
product (K3) must be bitwise equal to their plain versions (integer planes,
scales and level sums; K3 also combines its levels in the plain version's
order).  K1 and K5
are also held so on synthetic stores at the edges of their tensor-core
tiles: k = 1, 15, 16, 17, 33 rows of x, B = 64, 128, 512, a store of
diagonal entries only, one whose first bucket holds no diagonal entry, one
of planes at +-64 whose level sums reach 2^30 (the int32 guard's limit),
the band store of one entry a row and a store with empty rows.  The
float64 matvec and K3 are held to float64 oracles at 1e-14 max|y|.
The plain BSR SpMM (K4) sums in another order than its plain version:
float32 within 1e-5 max|y| (the reference's kernel bound), bfloat16 within
one bfloat16 rounding step.
"""

import pytest
import torch

from diaglib_tpu_torch.ops import slicing
from diaglib_tpu_torch.ops.bsr import (
    BSRMatrix,
    bsr_from_dense,
    bsr_spmm,
    bsr_spmm_plain,
    bsr_to_dense,
    random_bsr_spd,
)
from diaglib_tpu_torch.ops.bsr_sliced import (
    _slice_x,
    _tier_params,
    slice_bsr,
    sliced_bsr_matvec,
    sliced_spmm,
    sliced_spmm_plain,
)
from diaglib_tpu_torch.ops.bsr_sliced_sym import (
    slice_bsr_sym,
    sym_sliced_matvec,
    sym_spmm,
    sym_spmm_plain,
    sym_worklist,
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


f64, f32 = torch.float64, torch.float32

# The fused front end (K2's slice_rows) as its callers drive it: (x's dtype,
# nx, slice_rows's keywords, the column grid u, in the accumulation type,
# or none).
FRONT_ENDS = {
    # sym_sliced_matvec: x.to(acc) * u, the float64 and float32 tiers
    "sym f64": (f64, 8, dict(acc_dtype=f64, work_dtype=f64), True),
    "sym f32": (f32, 4, dict(acc_dtype=f32, work_dtype=f32), True),
    "sym f32 of f64 x": (f64, 4, dict(acc_dtype=f32, work_dtype=f32), True),
    "sym f32 at nx 8": (f64, 8, dict(acc_dtype=f32, work_dtype=f64), True),
    # sliced_bsr_matvec: x as it comes, float64 above 4 planes
    "general f64": (f64, 8, dict(work_dtype=f64), False),
    "general f32 x at nx 8": (f32, 8, dict(work_dtype=f64), False),
    "general f32": (f32, 4, dict(work_dtype=f32), False),
    "general f64 at nx 4": (f64, 4, dict(work_dtype=f64), False),
    # dist_sliced_matvec's float32 tier: x.to(float32)
    "dist f32": (f64, 4, dict(acc_dtype=f32, work_dtype=f32), False),
    # slice_operand at 7 bits: float64 scales
    "operand f32": (f32, 8, dict(sx_dtype=f64), False),
}


def _front_end_inputs(name, k, n, dev, seed):
    xdt, nx, kw, fold = FRONT_ENDS[name]
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((k, n), generator=g, dtype=f64, device=dev)
    x = x * 2.0 ** torch.randint(-30, 30, (k, 1), generator=g, device=dev)
    x[:, :5] *= 2.0 ** -40                      # deep tails in every row
    if k > 2:
        x[2] = 0.0                              # an all-zero row
    u = None
    if fold:
        u = 2.0 ** torch.randint(-20, 20, (n,), generator=g,
                                 device=dev).to(kw.get("acc_dtype", xdt))
    return x.to(xdt), nx, dict(kw, col_scale=u)


def _front_end_check(x, nx, kw):
    """One counted launch, planes and scales equal to the plain chain."""
    before = slicing.peel_rows.launches
    planes, sx = slicing.slice_rows(x, nx, **kw)
    torch.cuda.synchronize()
    assert slicing.peel_rows.launches == before + 1
    want_planes, want_sx = slicing.slice_rows_plain(x, nx, **kw)
    assert planes.shape == want_planes.shape and sx.dtype == want_sx.dtype
    assert torch.equal(sx, want_sx)
    assert torch.equal(planes, want_planes)
    return planes, sx


@pytest.mark.parametrize("n", [64, 4160, 65536, 131084])
@pytest.mark.parametrize("k", [1, 10, 15, 33])
@pytest.mark.parametrize("name", list(FRONT_ENDS))
def test_slice_rows_bit_equal(dev, name, k, n):
    # 131084: longer than a cluster keeps in registers (8 x 512 x 4 quads)
    # and not a multiple of 4
    x, nx, kw = _front_end_inputs(name, k, n, dev, k + n)
    _front_end_check(x, nx, kw)


def _edge_rows(xdt, n, dev):
    """Rows at the grid's edges: zero, inf, NaN among values far beyond the
    grid, a max past 2^1022 (float64), quotients below the least normal
    number of the work type, and denormal inputs."""
    g = torch.Generator(device=dev).manual_seed(31)
    x = torch.randn((10, n), generator=g, dtype=f64, device=dev)
    x[0] = 0.0
    x[1, 7] = float("inf")
    x[2, 3] = float("nan")
    x[2, 4:] *= 1e30
    x[3, 5] = -float("inf")
    x[3, 6] = float("nan")
    if xdt == f64:
        x[4] = x[4].clamp(-3, 3) * 5e307         # grid 2^1024: sx = inf
        x[5] *= 2.0 ** 1000                      # float64 quotients ...
        x[5, ::3] *= 2.0 ** -1060                # ... below 2^-1022
        x[6] *= 1e-310                           # denormal inputs
    else:
        x[4] = x[4].clamp(-3, 3) * 1e38          # near float32's max
        x[5] *= 2.0 ** 60                        # float32 quotients ...
        x[5, ::3] *= 2.0 ** -130                 # ... below 2^-126
        x[6] *= 1e-40
    x[7] *= 2.0 ** 60                            # float32 quotients from
    x[7, ::5] *= 2.0 ** -130                     # float64 x too
    return x.to(xdt)


@pytest.mark.parametrize("n", [4163, 65536])
@pytest.mark.parametrize("name", list(FRONT_ENDS))
def test_slice_rows_edge_rows_bit_equal(dev, name, n):
    xdt, nx, kw, fold = FRONT_ENDS[name]
    x = _edge_rows(xdt, n, dev)
    u = None
    if fold:
        g = torch.Generator(device=dev).manual_seed(32)
        u = 2.0 ** torch.randint(-20, 20, (n,), generator=g,
                                 device=dev).to(kw.get("acc_dtype", xdt))
        u[:9] = 2.0 ** 100                       # float32 overflow in the
    _, sx = _front_end_check(x, nx, dict(kw, col_scale=u))   # fold
    assert float(sx[0, 0]) == 2.0                # the zero row


@pytest.mark.parametrize("layout", ["offset", "transposed"])
@pytest.mark.parametrize("name", ["sym f64", "sym f32", "general f32"])
def test_slice_rows_strided_bit_equal(dev, name, layout):
    x, nx, kw = _front_end_inputs(name, 15, 4160, dev, 7)
    if layout == "offset":      # rows 1 element off 16 bytes, stride n + 7
        wide = torch.zeros((15, 4160 + 8), dtype=x.dtype, device=dev)
        wide[:, 1:4161] = x
        x = wide[:, 1:4161]
    else:                       # columns strided
        x = x.T.contiguous().T
    _front_end_check(x, nx, kw)


# the CTAs a row the library takes (a quad a thread at least, 8 at most)
# at the widths on either side of each step
@pytest.mark.parametrize("n,cluster", [(2048, 1), (2052, 2), (4096, 2),
                                       (8192, 4), (8196, 8)])
@pytest.mark.parametrize("name", ["sym f64", "sym f32"])
def test_slice_rows_cluster_sizes_bit_equal(dev, name, n, cluster):
    x, nx, kw = _front_end_inputs(name, 15, n, dev, 8)
    _front_end_check(x, nx, kw)


def test_slice_rows_checks_its_inputs(dev):
    x = torch.zeros((3, 64), dtype=f64, device=dev)
    u = torch.ones(64, dtype=f64, device=dev)
    bad = [
        lambda: slicing.slice_rows(x.int(), 8),
        lambda: slicing.slice_rows(x[None], 8),
        lambda: slicing.slice_rows(x, 0),
        lambda: slicing.slice_rows(x, 9),
        lambda: slicing.slice_rows(x, 8, col_scale=u.float()),
        lambda: slicing.slice_rows(x, 8, col_scale=u[:32]),
        lambda: slicing.slice_rows(x, 8, col_scale=u.cpu()),
        lambda: slicing.slice_rows(x, 8, acc_dtype=torch.float16),
        lambda: slicing.slice_rows(x, 4, work_dtype=f32),
        lambda: slicing.slice_rows(x.float(), 4, col_scale=u),
        lambda: slicing.slice_rows(x[:, :0], 8),
    ]
    before = slicing.peel_rows.launches
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert slicing.peel_rows.launches == before


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
    m, _ = small_store
    with pytest.raises(ValueError):        # K4 takes float32 / bfloat16
        bsr_spmm(BSRMatrix(m.blocks_t.double(), m.rows, m.cols, m.row_start,
                           m.n, m.block),
                 torch.zeros((2, m.n), dtype=torch.float64, device=dev))
    with pytest.raises(ValueError):        # K3 takes float64
        slicing.sliced_wide_mm(torch.zeros((2, 8), device=dev),
                               torch.zeros((8, 8192), device=dev))


@pytest.mark.parametrize("m,k,n", [
    (15, 165, 65536), (1, 13, 8192), (64, 170, 8448), (9, 1500, 8192),
    (16, 165, 8192), (17, 165, 8192), (33, 165, 8192),      # row tiles
    (15, 1, 8192), (15, 31, 8192), (15, 32, 8192), (15, 33, 8192),
    (15, 4096, 8192),                                       # K chunks
    (15, 165, 8200),                                        # ragged n
    (15, 15, 65536)])                       # ortho_cd's Cholesky step
def test_wide_mm_bit_equal(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(m + k)
    a = torch.randn((m, k), generator=g, dtype=torch.float64, device=dev)
    a = a * torch.exp(2.0 * torch.randn((m, k), generator=g,
                                        dtype=torch.float64, device=dev))
    b = torch.randn((k, n), generator=g, dtype=torch.float64, device=dev)
    b[:, 1] = 0.0
    before = slicing.sliced_wide_mm.launches
    got = slicing.sliced_wide_mm(a, b)
    torch.cuda.synchronize()
    assert slicing.sliced_wide_mm.launches == before + 1    # one launch
    assert torch.equal(got, slicing.sliced_wide_mm_plain(a, b))
    ref = a @ b
    assert float((got - ref).abs().max()) <= 1e-14 * float(ref.abs().max())
    assert float(got[:, 1].abs().max()) == 0.0
    # the mTm layout: a transposed view
    at = a.T.contiguous()
    assert torch.equal(slicing.sliced_wide_mm(at.T, b), got)


@pytest.mark.parametrize("n_slices,bits", [(6, 7), (8, 6)])
def test_wide_mm_refuses_other_plane_shapes(dev, n_slices, bits):
    # K3 is built for 8 planes of 7 bits; the plain version takes the rest
    a = torch.ones((2, 8), dtype=torch.float64, device=dev)
    b = torch.ones((8, 64), dtype=torch.float64, device=dev)
    before = slicing.sliced_wide_mm.launches
    with pytest.raises(ValueError, match="8 planes of 7 bits"):
        slicing.sliced_wide_mm(a, b, n_slices=n_slices, bits=bits)
    assert slicing.sliced_wide_mm.launches == before
    got = slicing.sliced_wide_mm(a.cpu(), b.cpu(), n_slices=n_slices,
                                 bits=bits)
    assert torch.equal(got, torch.full((2, 64), 8.0, dtype=torch.float64))


def test_wide_mm_longest_k(dev):
    # the largest K the exact int32 level sums allow still runs (streamed
    # a chunk at a time, 8192 chunks through one warp)
    k = 262140
    assert slicing.wide_feasible(2, k, 8)
    g = torch.Generator(device=dev).manual_seed(22)
    a = torch.randn((2, k), generator=g, dtype=torch.float64, device=dev)
    b = torch.randn((k, 8), generator=g, dtype=torch.float64, device=dev)
    got = slicing.sliced_wide_mm(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, slicing.sliced_wide_mm_plain(a, b))


def _edge_columns(dev):
    """(a, b) whose columns of b hit pow2_grid's edges: all zero, a
    denormal max, an exact power of two, huge values; and a zero row of
    a."""
    g = torch.Generator(device=dev).manual_seed(21)
    a = torch.randn((15, 165), generator=g, dtype=torch.float64, device=dev)
    a[3] = 0.0
    b = torch.randn((165, 8192), generator=g, dtype=torch.float64,
                    device=dev)
    b[:, 0] = 0.0
    b[:, 1] *= 1e-310                   # every |b| below the least normal
    b[:, 2] = b[:, 2].clamp(-3.9, 3.9)
    b[7, 2] = -4.0                      # max exactly 2^2
    b[:, 3] *= 1e300
    b[:, 4] = 2.0 ** -1022              # max exactly the least normal
    b[:, 5] *= 1e-300
    return a, b


@pytest.mark.parametrize("layout", ["contiguous", "strided", "misaligned"])
def test_wide_mm_grid_edges_bit_equal(dev, layout):
    a, b = _edge_columns(dev)
    if layout == "strided":             # b a transposed view, a too
        b = b.T.contiguous().T
        a = a.T.contiguous().T
    elif layout == "misaligned":        # rows of b 8 bytes off 16
        wide = torch.zeros((b.shape[0], b.shape[1] + 1), dtype=b.dtype,
                           device=dev)
        wide[:, 1:] = b
        b = wide[:, 1:]
    got = slicing.sliced_wide_mm(a, b)
    want = slicing.sliced_wide_mm_plain(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert not bool(got[3].ne(0).any()) and not bool(got[:, 0].ne(0).any())
    assert bool(got[:, 3].abs().max() > 1e299)


K4_PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
            (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]


def _k4_check(m, x):
    before = bsr_spmm.launches
    got = bsr_spmm(m, x)
    torch.cuda.synchronize()
    assert bsr_spmm.launches == before + 1 and got.dtype == x.dtype
    want = bsr_spmm_plain(m, x)
    tol = 1e-5 if x.dtype == torch.float32 else 2.0 ** -7
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max())
    return got


@pytest.mark.parametrize("block", [64, 128, 512])
@pytest.mark.parametrize("k", [1, 16, 17, 19, 33])
@pytest.mark.parametrize("xdt,bdt", K4_PAIRS)
def test_bsr_spmm_matches_plain(dev, xdt, bdt, k, block):
    m = random_bsr_spd(4096, block, 4, seed=6, dtype=torch.float32,
                       device=dev)
    m = BSRMatrix(m.blocks_t.to(bdt), m.rows, m.cols, m.row_start, m.n,
                  m.block)
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((k, 4096), generator=g, dtype=torch.float32,
                    device=dev).to(xdt)
    _k4_check(m, x)


@pytest.mark.parametrize("xdt,bdt", K4_PAIRS)
def test_bsr_spmm_unaligned(dev, xdt, bdt):
    # B = 12: a bfloat16 row of a block is 24 bytes; x 4 bytes off 16
    m = random_bsr_spd(480, 12, 3, seed=13, dtype=torch.float32, device=dev)
    m = BSRMatrix(m.blocks_t.to(bdt), m.rows, m.cols, m.row_start, m.n,
                  m.block)
    g = torch.Generator(device=dev).manual_seed(14)
    flat = torch.randn(5 * 480 + 2, generator=g, dtype=torch.float32,
                       device=dev).to(xdt)
    _k4_check(m, flat[2:].view(5, 480))


@pytest.mark.parametrize("xdt,bdt", K4_PAIRS)
def test_bsr_spmm_empty_block_row(dev, xdt, bdt):
    B = 32
    dense = torch.zeros((8 * B, 8 * B), dtype=torch.float32)
    g = torch.Generator().manual_seed(8)
    for r in (0, 2, 3, 5, 7):
        dense[r * B:(r + 1) * B, r * B:(r + 1) * B] = torch.randn(
            (B, B), generator=g)
    m = bsr_from_dense(dense.to(dev), B)
    keep = (m.blocks_t != 0).flatten(1).any(dim=1)
    rows = m.rows[keep]
    bare = BSRMatrix(m.blocks_t[keep].contiguous().to(bdt), rows,
                     m.cols[keep].contiguous(),
                     torch.searchsorted(rows, torch.arange(
                         8, dtype=torch.int32, device=dev)).to(torch.int32),
                     m.n, B)
    x = torch.randn((3, 8 * B), generator=g).to(dev).to(xdt)
    y = _k4_check(bare, x)
    for r in (1, 4, 6):
        assert float(y[:, r * B:(r + 1) * B].abs().max()) == 0.0
    if xdt == bdt == torch.float32:
        ref = x.double() @ dense.double().to(dev).T
        assert float((y.double() - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())


def _k5_stores(dev):
    """A store with several entries a block row, the band store of T, and
    a store with empty block rows (no padding entries)."""
    from diaglib_tpu_torch.problems import _band_bsr

    multi = slice_bsr(random_bsr_spd(1024, 64, 5, seed=9, device=dev))
    band = slice_bsr(_band_bsr(1024, 128, 10, 0.01, device=dev))
    B = 64
    dense = torch.zeros((8 * B, 8 * B))
    g = torch.Generator().manual_seed(11)
    for r, c in ((0, 0), (0, 5), (2, 2), (3, 1), (5, 7), (7, 7)):
        dense[r * B:(r + 1) * B, c * B:(c + 1) * B] = torch.randn(
            (B, B), generator=g)
    m = bsr_from_dense(dense.to(dev), B)
    keep = (m.blocks_t != 0).flatten(1).any(dim=1)
    rows = m.rows[keep]
    bare = BSRMatrix(m.blocks_t[keep].contiguous(), rows,
                     m.cols[keep].contiguous(),
                     torch.searchsorted(rows, torch.arange(
                         8, dtype=torch.int32, device=dev)).to(torch.int32),
                     m.n, B)
    return {"multi": multi, "band": band, "empty_rows": slice_bsr(bare)}


@pytest.mark.parametrize("k", [10, 17])
@pytest.mark.parametrize("tier", [torch.float64, torch.float32])
@pytest.mark.parametrize("which", ["multi", "band", "empty_rows"])
def test_sliced_spmm_bit_equal(dev, which, tier, k):
    st = _k5_stores(dev)[which]
    nx, na, nlev = _tier_params(st.na, tier, None, None)
    g = torch.Generator(device=dev).manual_seed(k)
    x = torch.randn((k, st.n), generator=g, dtype=torch.float64, device=dev)
    xs, _ = _slice_x(x.to(tier), nx)
    args = (xs, st.slices, st.rows, st.cols, st.row_start)
    before = sliced_spmm.launches
    got = sliced_spmm(*args, nx=nx, na=na, nlev=nlev)
    torch.cuda.synchronize()
    assert sliced_spmm.launches == before + 1
    want = sliced_spmm_plain(*args, nx=nx, na=na, nlev=nlev)
    assert bool(want.ne(0).any())
    assert torch.equal(got, want)
    if which == "empty_rows":             # rows 1, 4, 6 write zeros
        lv = got.reshape(nlev, k, 8, 64)
        assert not bool(lv[:, :, [1, 4, 6]].ne(0).any())


def test_general_f64_matvec_matches_dense(dev):
    m = random_bsr_spd(2048, 256, 4, seed=4, dtype=torch.float32, device=dev)
    dense = bsr_to_dense(m).double()
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((15, 2048), generator=g, dtype=torch.float64, device=dev)
    y = sliced_bsr_matvec(slice_bsr(m))(x)
    ref = x @ dense.T
    assert float((y - ref).abs().max()) <= 1e-14 * float(ref.abs().max())


def test_sliced_spmm_checks_its_inputs(dev):
    st = _k5_stores(dev)["multi"]
    xs = torch.zeros((8 * 2, st.n), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):        # int64 column indices
        sliced_spmm(xs, st.slices, st.rows, st.cols.long(), st.row_start,
                    nx=8, na=8, nlev=9)
    with pytest.raises(ValueError):        # more levels than the kernel has
        sliced_spmm(xs, st.slices, st.rows, st.cols, st.row_start, nx=8,
                    na=8, nlev=10)


def _k6_partition(dev):
    """A general store at B = 64 split over 4 ranks whose ring-offset
    groups have uneven counts: padding entries, and rows a group does not
    cover."""
    from diaglib_tpu_torch.ops.dist_sliced import distribute_sliced_bsr

    B, nbr = 64, 16
    pattern = {(r, r) for r in range(nbr)} | {
        (0, 4), (1, 5), (8, 12), (2, 15), (13, 0), (6, 14), (7, 9)}
    dense = torch.zeros((nbr * B, nbr * B))
    g = torch.Generator().manual_seed(12)
    for r, c in sorted(pattern):
        dense[r * B:(r + 1) * B, c * B:(c + 1) * B] = torch.randn(
            (B, B), generator=g)
    return distribute_sliced_bsr(slice_bsr(bsr_from_dense(dense.to(dev), B)),
                                 4)


@pytest.mark.parametrize("k", [10, 17])
@pytest.mark.parametrize("tier", [torch.float64, torch.float32])
def test_group_spmm_bit_equal(dev, tier, k):
    from diaglib_tpu_torch.ops.dist_sliced import group_spmm, group_spmm_plain

    ds = _k6_partition(dev)
    nbr_loc, n_loc = ds.nbr_loc, ds.n_local
    nx, na, nlev = _tier_params(ds.na, tier, None, None)
    g = torch.Generator(device=dev).manual_seed(k)
    x = torch.randn((k, ds.n), generator=g, dtype=torch.float64, device=dev)
    padded = uncovered = False
    for i, s in enumerate(ds.steps):
        for r in range(4):
            src = (r + s) % 4
            xs, _ = _slice_x(x[:, src * n_loc:(src + 1) * n_loc].to(tier), nx)
            args = (xs, ds.slices[i][r], ds.loc_rows[i][r],
                    ds.loc_cols[i][r])
            kw = dict(nx=nx, na=na, nlev=nlev, nbr_loc=nbr_loc)
            before = group_spmm.launches
            got = group_spmm(*args, **kw)
            torch.cuda.synchronize()
            assert group_spmm.launches == before + 1
            want = group_spmm_plain(*args, **kw)
            assert got.shape == want.shape == (nlev * k, n_loc)
            assert torch.equal(got, want)
            lr = ds.loc_rows[i][r]
            padded |= bool((lr == nbr_loc).any())
            rows = set(lr.tolist())
            for q in range(nbr_loc):          # uncovered rows are zeros
                if q not in rows:
                    uncovered = True
                    assert not bool(got[:, q * 64:(q + 1) * 64].ne(0).any())
    assert padded and uncovered


def test_group_spmm_checks_its_inputs(dev):
    from diaglib_tpu_torch.ops.dist_sliced import group_spmm

    ds = _k6_partition(dev)
    sl, lr, lc = ds.slices[0][0], ds.loc_rows[0][0], ds.loc_cols[0][0]
    xs = torch.zeros((8 * 2, ds.n_local), dtype=torch.int8, device=dev)
    kw = dict(nx=8, na=8, nlev=9, nbr_loc=ds.nbr_loc)
    group_spmm(xs, sl, lr, lc, **kw)                  # the intact call
    with pytest.raises(ValueError):        # int64 local columns
        group_spmm(xs, sl, lr, lc.long(), **kw)
    with pytest.raises(ValueError):        # x not the shard's width
        group_spmm(xs[:, :64].contiguous(), sl, lr, lc, **kw)
    with pytest.raises(ValueError):        # more levels than the kernel has
        group_spmm(xs, sl, lr, lc, **dict(kw, nlev=10))
    with pytest.raises(ValueError):        # float x
        group_spmm(xs.float(), sl, lr, lc, **kw)


# ---- K1 and K5 on the tensor cores: synthetic stores at the tile edges ----

TC_K = [1, 15, 16, 17, 33]
TC_BLOCKS = [64, 128, 512]
TIERS = {"f64": (8, 9, 8), "f32": (4, 4, 4)}     # nx, nlev, stored planes used


def _int8_planes(shape, g, dev, signs_only=False):
    if signs_only:
        return (64 * (2 * torch.randint(0, 2, shape, generator=g, device=dev)
                      - 1)).to(torch.int8)
    return torch.randint(-64, 65, shape, generator=g, device=dev,
                         dtype=torch.int8)


_K1_CASES = {}


def _k1_case(kind, B, dev):
    """(buckets [(rows, cols, slices, plane_off)], n) of a symmetric store:
    "diagonal": only diagonal entries, in both buckets; "no_diag_bucket0":
    bucket 0 holds only off-diagonal entries, bucket 1 the diagonal and one
    more; "guard_limit": block row 0 holds 2^15 / B entries of planes all
    +64, the most the store's int32 guard admits, so with x planes at +64
    its level sums reach 2^30."""
    key = (kind, B)
    if key in _K1_CASES:
        return _K1_CASES[key]
    g = torch.Generator(device=dev).manual_seed(B + len(kind))
    if kind == "guard_limit":
        nbr = 2 ** 15 // B
        pats = ([(0, c) for c in range(nbr)], [])
    elif kind == "diagonal":
        nbr = 4
        pats = ([(0, 0), (2, 2)], [(1, 1), (3, 3)])
    else:
        nbr = 4
        pats = ([(0, 1), (0, 3), (1, 2), (2, 3)],
                [(0, 0), (1, 1), (1, 3), (2, 2), (3, 3)])
    buckets = []
    for off, pat in enumerate(pats):
        if not pat:
            continue
        rows = torch.tensor([p[0] for p in pat], dtype=torch.int32,
                            device=dev)
        cols = torch.tensor([p[1] for p in pat], dtype=torch.int32,
                            device=dev)
        shape = (len(pat), B, (8 - off) * B)
        sl = (torch.full(shape, 64, dtype=torch.int8, device=dev)
              if kind == "guard_limit" else _int8_planes(shape, g, dev))
        buckets.append((rows, cols, sl, off))
    _K1_CASES[key] = (buckets, nbr * B)
    return _K1_CASES[key]


@pytest.mark.parametrize("kind", ["diagonal", "no_diag_bucket0",
                                  "guard_limit"])
@pytest.mark.parametrize("block", TC_BLOCKS)
@pytest.mark.parametrize("k", TC_K)
@pytest.mark.parametrize("tier", list(TIERS))
def test_sym_spmm_tile_edges_bit_equal(dev, tier, k, block, kind):
    buckets, n = _k1_case(kind, block, dev)
    nx, nlev, na_used = TIERS[tier]
    g = torch.Generator(device=dev).manual_seed(k)
    limit = kind == "guard_limit"
    xs = _int8_planes((nx * k, n), g, dev, signs_only=limit)
    if limit:
        xs.view(nx, k, n)[:, 0] = 64
    got = torch.zeros((nlev * k, n), dtype=torch.int32, device=dev)
    want = torch.zeros_like(got)
    for rows, cols, sl, off in buckets:
        na = min(na_used - off, sl.shape[-1] // block)
        items, start = sym_worklist(rows, cols, n // block)
        before = sym_spmm.launches
        sym_spmm(xs, sl, rows, cols, got, nx=nx, na=na, nlev=nlev,
                 plane_off=off, items=items, item_start=start)
        assert sym_spmm.launches == before + 1
        sym_spmm_plain(xs, sl, rows, cols, want, nx=nx, na=na, nlev=nlev,
                       plane_off=off)
    torch.cuda.synchronize()
    assert bool(want.ne(0).any())
    assert torch.equal(got, want)
    if limit:       # level nx - 1 of row 0 of block row 0: 2^30 exactly
        top = want.view(nlev, k, n)[min(nx, nlev) - 1, 0, :block]
        assert int(top.max()) == 2 ** 30 * min(nx, na_used, nlev) // 8


_K5_CASES = {}


def _k5_case(kind, B, dev):
    """(slices, rows, cols, row_start, n) of a general store: "band", one
    entry a row at (r, r + 1 mod 8); "empty_rows", block rows 1, 4 and 6
    without entries."""
    key = (kind, B)
    if key in _K5_CASES:
        return _K5_CASES[key]
    nbr = 8
    pat = ([(r, (r + 1) % nbr) for r in range(nbr)] if kind == "band" else
           [(0, 0), (0, 5), (2, 2), (3, 1), (5, 7), (7, 7)])
    rows = torch.tensor([p[0] for p in pat], dtype=torch.int32, device=dev)
    cols = torch.tensor([p[1] for p in pat], dtype=torch.int32, device=dev)
    row_start = torch.searchsorted(rows, torch.arange(
        nbr, dtype=torch.int32, device=dev)).to(torch.int32)
    g = torch.Generator(device=dev).manual_seed(B + 1)
    sl = _int8_planes((len(pat), B, 8 * B), g, dev)
    _K5_CASES[key] = (sl, rows, cols, row_start, nbr * B)
    return _K5_CASES[key]


@pytest.mark.parametrize("kind", ["band", "empty_rows"])
@pytest.mark.parametrize("block", TC_BLOCKS)
@pytest.mark.parametrize("k", TC_K)
@pytest.mark.parametrize("tier", list(TIERS))
def test_sliced_spmm_tile_edges_bit_equal(dev, tier, k, block, kind):
    sl, rows, cols, row_start, n = _k5_case(kind, block, dev)
    nx, nlev, na = TIERS[tier]
    g = torch.Generator(device=dev).manual_seed(k)
    xs = _int8_planes((nx * k, n), g, dev)
    args = (xs, sl, rows, cols, row_start)
    before = sliced_spmm.launches
    got = sliced_spmm(*args, nx=nx, na=na, nlev=nlev)
    torch.cuda.synchronize()
    assert sliced_spmm.launches == before + 1
    want = sliced_spmm_plain(*args, nx=nx, na=na, nlev=nlev)
    assert bool(want.ne(0).any())
    assert torch.equal(got, want)
    if kind == "empty_rows":              # rows 1, 4, 6 write zeros
        lv = got.reshape(nlev, k, 8, block)
        assert not bool(lv[:, :, [1, 4, 6]].ne(0).any())
