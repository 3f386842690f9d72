"""Integer-sliced BSR operator, the general (unsymmetric) store, and the
parts the symmetric store shares (port of ``diaglib_tpu/ops/bsr_sliced.py``).

7-bit slices on a half power-of-two grid (|t| <= 1/2 keeps every plane at
|q| <= 64, inside int8): 8 planes cover 7*8-1 = 55 >= 53 mantissa bits.
The float64 tier slices x into nx = 8 planes, the float32 tier into 4.

The general store keeps every entry of a block matrix once, as ``na``
int8 planes on a per-(block row, output column) grid ``col_scale``: entry
e at block (r, c) holds T_e = A(r, c)^T / col_scale[r], so that all the
entries of a block row share one grid and their plane products add up
exactly in int32 levels.  :func:`sliced_spmm` is the wrapper of the CUDA
kernel ``csrc/sliced_spmm.cu`` (kernel K5); on CPU tensors it runs
:func:`sliced_spmm_plain`.  The reference's two TPU variants (resident
accumulator or revisited row tiles, switched on a VMEM budget) are one
kernel here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from .._device import resolve_device
from ..utils.graphs import replayable
from . import _build
from .bsr import BSRMatrix, as_arrays, bsr_diagonal
from .slicing import combine_weights, pow2_grid, slice_rows, slice_scaled

__all__ = ["SlicedBSR", "slice_bsr", "sliced_bsr_matvec", "sliced_spmm",
           "sliced_spmm_plain", "sliced_store_from_arrays"]

_BITS = 7


def _slice_x(x: torch.Tensor, nx: int, *, col_scale=None, acc_dtype=None):
    """Row-aligned int8 planes of x, ``(nx*k, n)``, and the row scales
    ``sx`` (``(k, 1)``, ``sx = 2 * pow2_grid(max|x|)``), in one launch of
    kernel K2 on the card (:func:`~.slicing.slice_rows`).  x is cast to
    ``acc_dtype`` (its own by default) and multiplied by the column grid
    ``col_scale`` where one is given (the symmetric store's u); the float64
    tier (nx > 4) peels in float64, the float32 tier in the accumulation
    type; sx comes back in the accumulation type."""
    k, n = x.shape
    acc = x.dtype if acc_dtype is None else acc_dtype
    planes, sx = slice_rows(x, nx, col_scale=col_scale, acc_dtype=acc,
                            work_dtype=torch.float64 if nx > 4 else acc)
    return planes.reshape(nx * k, n), sx


def _tier_params(m_na: int, dtype, nx: int | None, nlev: int | None):
    """(nx, na_used, nlev) for the requested accuracy tier.

    float64: nx = 8 x planes, all na stored planes, levels up to na+nx-2
    capped at 9 (deeper terms fall below the storage truncation).
    float32: nx = 4, the top min(na, 4) planes, 4 levels (~2^-20 relative).
    """
    if dtype == torch.float64:
        nx = 8 if nx is None else nx
        na_used = m_na
        nlev = min(na_used + nx - 1, 9) if nlev is None else nlev
    else:
        nx = 4 if nx is None else nx
        na_used = min(m_na, 4)
        nlev = min(4, na_used + nx - 1) if nlev is None else nlev
    return nx, na_used, nlev


def _combine_levels(p: torch.Tensor, w: torch.Tensor, nlev: int, k: int,
                    n: int, acc_dtype) -> torch.Tensor:
    """Weighted level combine of the int32 level sums ``p`` (nlev*k, n):
    ``sum_L p[L] * w[L]`` in ``acc_dtype``, summed from level 0 up.  The
    int32 -> float64 conversion is exact and the weights are powers of two,
    so the only rounding is the summation itself."""
    lv = p.reshape(nlev, k, n)
    w = w.to(acc_dtype)
    y = torch.zeros((k, n), dtype=acc_dtype, device=p.device)
    for lev in range(nlev):
        y = y + lv[lev].to(acc_dtype) * w[lev]
    return y


def _fold(lev, prod, dst, nx, na, nlev, plane_off):
    """Add the (E, nx, k, na, B) plane products into the (nlev, k, nbr, B)
    level sums at block columns ``dst``, pair (ix, i) at level
    plane_off + i + ix."""
    for L in range(plane_off, nlev):
        pairs = [(ix, L - plane_off - ix) for ix in range(nx)
                 if 0 <= L - plane_off - ix < na]
        if not pairs:
            continue
        s = sum(prod[:, ix, :, i, :] for ix, i in pairs)      # (E, k, B)
        lev[L].index_add_(1, dst, s.transpose(0, 1))


def _int32_bits(B: int, terms: int, pairs: int) -> int:
    """Bits of a level sum of ``pairs`` plane products summed over
    ``B * terms`` terms: 2*(_BITS-1)+1 bits a product, the extra bit being
    headroom for the carry overlap of neighbouring planes (combined slice
    magnitudes reach ~1.3x the nominal 2^(_BITS-1))."""
    return 2 * (_BITS - 1) + 1 + math.ceil(math.log2(B * terms * pairs))


@dataclasses.dataclass(frozen=True)
class SlicedBSR:
    """BSR operator stored as int8 Ozaki slices.

    slices:    (nnzb, B, na*B) int8; entry e holds, side by side, the na
               planes of T_e = A(r_e, c_e)^T / col_scale[r_e] (transposed,
               so that the kernel computes x_blk @ T_e).  Plane i occupies
               columns [i*B, (i+1)*B), so a prefix of planes is a
               lower-precision operator.
    col_scale: (n,) float64 half power-of-two grid per output column,
               shared by all the entries of a block row.
    diagonal:  (n,) float64 main diagonal of the operator.
    rows/cols/row_start: as in :class:`~.bsr.BSRMatrix` (rows sorted).
    max_bpr:   most entries in one block row (the int32 guard's count).
    """

    slices: torch.Tensor
    col_scale: torch.Tensor
    diagonal: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    row_start: torch.Tensor
    n: int
    block: int
    na: int
    max_bpr: int = 0

    @property
    def nnzb(self) -> int:
        return self.slices.shape[0]

    @property
    def nnz(self) -> int:
        return self.nnzb * self.block * self.block

    @property
    def nbytes(self) -> int:
        """Bytes the store holds on its device."""
        return sum(t.numel() * t.element_size() for t in (
            self.slices, self.col_scale, self.diagonal, self.rows, self.cols,
            self.row_start))


def slice_bsr(m: BSRMatrix, na: int | None = None,
              chunk: int = 256) -> SlicedBSR:
    """Build the general slice store from a BSRMatrix (float32 or float64
    blocks), on the blocks' device.

    ``na`` defaults to 8 planes (55 bits below each column's grid).
    Entries are sliced ``chunk`` at a time into a preallocated store, so
    the float64 temporaries stay bounded.
    """
    if na is None:
        na = 8
    B = m.block
    nbr = m.n // B
    dev = m.blocks_t.device
    rows = m.rows.long()
    max_bpr = (int(torch.bincount(rows, minlength=nbr).max())
               if m.nnzb else 0)
    if max_bpr and _int32_bits(B, max_bpr, min(na, 8)) > 31:
        raise ValueError(
            f"block {B} x {max_bpr}/row overflows exact int32 accumulation")

    # per-(block row, column) half power-of-two grid over the row's entries
    absmax = m.blocks_t.abs().amax(dim=1)                    # (nnzb, B)
    colmax = torch.zeros((nbr, B), dtype=m.blocks_t.dtype, device=dev)
    colmax.scatter_reduce_(0, rows[:, None].expand(-1, B), absmax, "amax")
    col_scale = 2.0 * pow2_grid(colmax.to(torch.float64))    # (nbr, B)

    slices = torch.empty((m.nnzb, B, na * B), dtype=torch.int8, device=dev)
    for s in range(0, m.nnzb, chunk):
        e = slice(s, s + chunk)
        t = (m.blocks_t[e].to(torch.float64)
             / col_scale[rows[e]][:, None, :])
        sl = slice_scaled(t, n_slices=na, bits=_BITS)       # (na, c, B, B)
        del t
        slices[e] = sl.permute(1, 2, 0, 3).reshape(-1, B, na * B)
        del sl

    return SlicedBSR(
        slices=slices,
        col_scale=col_scale.reshape(-1),
        diagonal=bsr_diagonal(m).to(torch.float64),
        rows=m.rows.to(torch.int32).contiguous(),
        cols=m.cols.to(torch.int32).contiguous(),
        row_start=m.row_start.to(torch.int32).contiguous(),
        n=m.n, block=B, na=na, max_bpr=max_bpr)


def sliced_store_from_arrays(d, device=None) -> SlicedBSR:
    """SlicedBSR from the JAX dataclass's fields: a dict of numpy arrays or
    numbers (static fields included), or the dataclass itself (each T
    store of the JAX package's ``bsr_nonsym_similarity``, for example).

    Rejects arrays the kernel would misread: rows not sorted, ``row_start``
    not the first entry of each row, coordinates or plane widths that do
    not fit the store's dimensions.  Built on the current CUDA device
    unless ``device`` names another (RuntimeError without a card: pass
    ``device="cpu"``)."""
    device = resolve_device(device)
    d = as_arrays(d)

    def t(name, dtype=None):
        return torch.as_tensor(np.array(d[name]), dtype=dtype, device=device)

    s = SlicedBSR(
        slices=t("slices", torch.int8), col_scale=t("col_scale",
                                                    torch.float64),
        diagonal=t("diagonal", torch.float64), rows=t("rows", torch.int32),
        cols=t("cols", torch.int32), row_start=t("row_start", torch.int32),
        n=int(d["n"]), block=int(d["block"]), na=int(d["na"]),
        max_bpr=int(d.get("max_bpr", 0)))
    B = s.block
    nbr = s.n // B if B > 0 else 0
    m = s.rows.shape[0]
    ok = (B > 0 and s.n % B == 0 and s.na > 0
          and tuple(s.slices.shape) == (m, B, s.na * B)
          and s.cols.shape == (m,) and s.row_start.shape == (nbr,)
          and s.col_scale.shape == (s.n,) and s.diagonal.shape == (s.n,))
    if ok and m:
        rows = s.rows.long()
        ok = (int(rows.min()) >= 0 and int(rows.max()) < nbr
              and int(s.cols.min()) >= 0 and int(s.cols.max()) < nbr
              and bool((rows[1:] >= rows[:-1]).all()))
    if ok:
        starts = torch.searchsorted(
            s.rows.long(), torch.arange(nbr, device=s.rows.device))
        ok = torch.equal(starts.to(torch.int32), s.row_start)
    if not ok:
        raise ValueError("sliced_store_from_arrays: malformed store arrays")
    return s


_PLAIN_CHUNK = 32   # entries per batched product in sliced_spmm_plain


def sliced_spmm_plain(xs, slices, rows, cols, row_start, *, nx: int,
                      na: int, nlev: int, n_out: int | None = None
                      ) -> torch.Tensor:
    """The plain torch version of kernel K5: the int32 level sums
    ``(nlev*k, n_out)`` of the general store.

    ``xs`` (nx*k, n) int8 x planes; ``slices`` (m, B, width*B) int8, of
    which the leading ``na`` planes are used; ``rows``/``cols`` (m,) block
    coordinates of the output and of x (``row_start`` is the kernel's; the
    plain version does not need it); ``n_out`` the output's width (x's by
    default; kernel K6 writes one more block row).  Pair (x plane ix,
    stored plane i) of entry e goes to level i + ix of block row rows[e]
    when that is below nlev; rows no entry covers are zero.  The products
    are float64 matmuls of the planes, exact because every partial sum is
    an integer below 2^53.
    """
    m, B = slices.shape[0], slices.shape[1]
    n = xs.shape[1]
    n_out = n if n_out is None else n_out
    k = xs.shape[0] // nx
    f64 = torch.float64
    xb = xs.reshape(nx * k, n // B, B)
    lev = torch.zeros((nlev, k, n_out // B, B), dtype=f64, device=xs.device)
    for s in range(0, m, _PLAIN_CHUNK):
        e = slice(s, s + _PLAIN_CHUNK)
        t = slices[e, :, :na * B].to(f64)                  # (E, B, na*B)
        xc = xb[:, cols[e].long(), :].permute(1, 0, 2).to(f64)
        prod = (xc @ t).reshape(t.shape[0], nx, k, na, B)
        _fold(lev, prod, rows[e].long(), nx, na, nlev, 0)
    return lev.reshape(nlev * k, n_out).to(torch.int32)


def _launch_level_sums(wrapper, xs, slices, cols, row_start, *, nx: int,
                       na: int, nlev: int, n_out: int) -> torch.Tensor:
    """Check the arguments of kernel K5 or K6, which share their device
    code and C interface, and launch the kernel of ``wrapper``
    (:func:`sliced_spmm` or ``dist_sliced.group_spmm``: the library, its
    entry and the launch count are named after it) on CUDA tensors;
    returns the ``(nlev*k, n_out)`` int32 level sums.  Raises ValueError
    on arguments the kernel would misread and RuntimeError when the
    launch fails."""
    kernel = wrapper.__name__
    for name, t, dt in (("xs", xs, torch.int8), ("slices", slices, torch.int8),
                        ("cols", cols, torch.int32),
                        ("row_start", row_start, torch.int32)):
        if t.device != xs.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous {dt} "
                             f"tensor on {xs.device}")
    m, B = slices.shape[0], slices.shape[1]
    width = slices.shape[2] // B if B else 0
    n = xs.shape[-1]
    k = xs.numel() // (nx * n) if n and nx > 0 else 0
    if (B <= 0 or B % 64 or n % B or n_out % B or xs.ndim != 2
            or slices.ndim != 3 or slices.shape[2] != width * B
            or xs.numel() != nx * k * n or cols.shape != (m,)
            or not 0 < n_out // B < 65536 or row_start.shape != (n_out // B,)
            or not 0 < nx <= 8 or not 0 < na <= min(width, 8)
            or not 0 < nlev <= 9
            or xs.data_ptr() % 16 or slices.data_ptr() % 16
            or max(n, n_out, m, nlev * k) >= 2 ** 31):
        raise ValueError(
            f"{kernel}: unsupported shapes xs={tuple(xs.shape)} "
            f"slices={tuple(slices.shape)} n_out={n_out} nx={nx} na={na} "
            f"nlev={nlev}")
    acc = torch.empty((nlev * k, n_out), dtype=torch.int32, device=xs.device)
    if k == 0:
        return acc
    lib = _build.library(kernel)
    fn = getattr(lib, kernel)
    err_string = getattr(lib, f"{kernel}_error_string")
    if not getattr(lib, "_typed", False):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p] + [i32] * 9 + [p]
        fn.restype = i32
        err_string.argtypes = [i32]
        err_string.restype = ctypes.c_char_p
        lib._typed = True
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = fn(xs.data_ptr(), slices.data_ptr(), cols.data_ptr(),
             row_start.data_ptr(), acc.data_ptr(), m, k, n, n_out, B, width,
             nx, na, nlev, stream)
    if err:
        raise RuntimeError(f"{kernel} kernel: {err_string(err).decode()}")
    wrapper.launches += 1
    return acc


def sliced_spmm(xs, slices, rows, cols, row_start, *, nx: int, na: int,
                nlev: int) -> torch.Tensor:
    """The level sums of the general store (kernel K5).

    Arguments as :func:`sliced_spmm_plain`.  On CPU tensors this is the
    plain version; on CUDA tensors it launches ``csrc/sliced_spmm.cu``
    (one CTA per block row and tile, int8 tensor-core products, each
    output written once, bitwise equal to the plain version) or raises.
    """
    if xs.device.type == "cpu":
        return sliced_spmm_plain(xs, slices, rows, cols, row_start, nx=nx,
                                 na=na, nlev=nlev)
    if xs.device.type != "cuda":
        raise ValueError(f"sliced_spmm: unsupported device {xs.device}")
    return _launch_level_sums(sliced_spmm, xs, slices, cols, row_start,
                             nx=nx, na=na, nlev=nlev, n_out=xs.shape[-1])


sliced_spmm.launches = 0


def sliced_bsr_matvec(m: SlicedBSR, *, dtype=torch.float64,
                      nx: int | None = None, nlev: int | None = None):
    """Matvec closure ``x: (k, n) -> (k, n)`` over the general store.

    ``dtype`` float64 is the full-accuracy tier (nx = 8, all planes, 9
    levels, combined in float64); float32 the fast tier (nx = 4, the top 4
    planes, 4 levels, combined in float32).  See :func:`_tier_params`.
    """
    nx, na_used, nlev = _tier_params(m.na, dtype, nx, nlev)
    # int32 exactness for the actual tier: up to min(nx, na_used) pair
    # products a level, summed over B * max_bpr terms
    if m.max_bpr and _int32_bits(m.block, m.max_bpr,
                                 min(nx, na_used)) > 31:
        raise ValueError(
            f"nx={nx} x na={na_used} slices overflow exact int32 "
            f"accumulation at block {m.block} x {m.max_bpr}/row")
    acc_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    w = combine_weights(nlev, _BITS, acc_dtype, device=m.col_scale.device)
    cs = m.col_scale[None, :].to(acc_dtype)

    def mv(x):
        k, n = x.shape
        xs, sx = _slice_x(x, nx)
        p = sliced_spmm(xs, m.slices, m.rows, m.cols, m.row_start, nx=nx,
                        na=na_used, nlev=nlev)
        y = _combine_levels(p, w, nlev, k, n, acc_dtype)
        y = y * sx.to(acc_dtype) * cs
        return y.to(dtype)

    return replayable(mv)
