"""Symmetric integer-sliced BSR operator (port of
``diaglib_tpu/ops/bsr_sliced_sym.py``).

The store keeps the block diagonal and the upper triangle (r <= c) of a
SYMMETRIC block matrix once, as int8 Ozaki planes on a separable
power-of-two grid

    q[j, k] = T_e[j, k] / (u_{cB+j} * u_{rB+k}),
    u_i = pow2_grid(sqrt(2 * rowmax_i)),   rowmax_i = max_j |A_ij|,

so one read of an entry serves both the direct term (y_r += x_c T_e) and
the mirror term (y_c += x_r T_e^T).  The grid factors out of the
contraction: x is multiplied by u before it is sliced and y after the
levels are combined, both exact power-of-two multiplies, and every plane
product lands exactly in one int32 level accumulator.

:func:`sym_spmm` is the wrapper of the CUDA kernel ``csrc/sym_spmm.cu``
(kernel K1); on CPU tensors it runs :func:`sym_spmm_plain`.
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
from .bsr_sliced import (
    _BITS,
    SlicedBSR,
    _combine_levels,
    _fold,
    _slice_x,
    _tier_params,
    sliced_bsr_matvec,
)
from .slicing import combine_weights, pow2_grid, slice_scaled

__all__ = ["SymSlicedBSR", "slice_bsr_sym", "sym_sliced_matvec",
           "sliced_matvec_any", "sym_spmm", "sym_spmm_plain",
           "sym_store_from_arrays", "sym_worklist"]


@dataclasses.dataclass(frozen=True)
class SymSlicedBSR:
    """Upper-triangle int8 slice store of a SYMMETRIC BSR operator.

    Entries are the block diagonal plus the upper triangle (r <= c),
    row-sorted, split by whether their first plane is occupied: below the
    separable grid an off-diagonal block with max|q| < 2^-_BITS has an
    all-zero plane 0, which is not stored.

    slices:   (m0, B, na*B) int8 — entries with plane 0 occupied; entry e
              holds the na planes of T_e = A(r_e, c_e)^T / (u_c ⊗ u_r)
              side by side.
    slices1:  (m1, B, (na-1)*B) int8 — entries whose plane 0 is zero,
              stored from plane 1 (their levels are offset by one).
    u_scale:  (n,) float64 separable power-of-two grid.
    diagonal: (n,) float64 main diagonal of A (for preconditioners).
    rows/cols, rows1/cols1: (m,) int32 block coordinates per bucket.
    """

    slices: torch.Tensor
    u_scale: torch.Tensor
    diagonal: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    slices1: torch.Tensor
    rows1: torch.Tensor
    cols1: torch.Tensor
    n: int
    block: int
    na: int
    max_row_terms: int = 0

    @property
    def nnzb_stored(self) -> int:
        return self.slices.shape[0] + self.slices1.shape[0]

    @property
    def nnz(self) -> int:
        """LOGICAL nonzeros of the symmetric operator (both triangles)."""
        n_diag = int((self.rows == self.cols).sum()) + int(
            (self.rows1 == self.cols1).sum())
        n_off = self.nnzb_stored - n_diag
        return (n_diag + 2 * n_off) * self.block * self.block

    @property
    def nbytes(self) -> int:
        """Bytes the store holds on its device."""
        return sum(t.numel() * t.element_size() for t in (
            self.slices, self.u_scale, self.diagonal, self.rows, self.cols,
            self.slices1, self.rows1, self.cols1))


def sym_store_from_arrays(d, device=None) -> SymSlicedBSR:
    """SymSlicedBSR from the JAX dataclass's fields: a dict of numpy arrays
    or numbers (static fields included), or the dataclass itself (for
    example each store of the JAX package's ``bsr_gen_problem`` pair).
    Built on the current CUDA device unless ``device`` names another
    (RuntimeError without a card: pass ``device="cpu"``)."""
    device = resolve_device(device)
    d = as_arrays(d)

    def t(name, dtype=None):
        return torch.as_tensor(np.array(d[name]), dtype=dtype, device=device)

    s = SymSlicedBSR(
        slices=t("slices", torch.int8), u_scale=t("u_scale", torch.float64),
        diagonal=t("diagonal", torch.float64), rows=t("rows", torch.int32),
        cols=t("cols", torch.int32), slices1=t("slices1", torch.int8),
        rows1=t("rows1", torch.int32), cols1=t("cols1", torch.int32),
        n=int(d["n"]), block=int(d["block"]), na=int(d["na"]),
        max_row_terms=int(d.get("max_row_terms", 0)))
    # the kernel indexes x and the accumulator with these: reject a store
    # whose coordinates or plane widths do not fit its own dimensions
    B, nbr = s.block, s.n // s.block
    for rows, cols, sl, width in ((s.rows, s.cols, s.slices, s.na),
                                  (s.rows1, s.cols1, s.slices1, s.na - 1)):
        m = rows.shape[0]
        if (s.n % B or tuple(sl.shape) != (m, B, width * B)
                or cols.shape != (m,)
                or (m and not (bool((rows >= 0).all())
                               and bool((rows <= cols).all())
                               and int(cols.max()) < nbr))):
            raise ValueError("sym_store_from_arrays: malformed store arrays")
    if s.u_scale.shape != (s.n,) or s.diagonal.shape != (s.n,):
        raise ValueError("sym_store_from_arrays: malformed store arrays")
    return s


def slice_bsr_sym(m: BSRMatrix, na: int | None = None,
                  chunk: int = 256) -> SymSlicedBSR:
    """Build the symmetric slice store from a SYMMETRIC BSRMatrix.

    The matrix must be symmetric in pattern and values (A = A^T); only the
    r <= c entries are stored.  ``na`` defaults to 8 (7*8-1 = 55 mantissa
    bits below the separable grid, >= float64's 53).  Entries are sliced
    ``chunk`` at a time to bound the float64 temporaries.
    """
    if na is None:
        na = 8
    B = m.block
    nbr = m.n // B
    dev = m.blocks_t.device
    rows_all = m.rows.long()
    cols_all = m.cols.long()

    # rowmax over the FULL symmetric matrix: T_e[j, k] = A[rB+k, cB+j], so
    # the max over axis 1 covers rows of block r, over axis 2 rows of c
    absb = m.blocks_t.abs()
    rmax_r = absb.amax(dim=1).to(torch.float64)          # (nnzb, B)
    rmax_c = absb.amax(dim=2).to(torch.float64)
    del absb
    rowmax = torch.zeros((nbr, B), dtype=torch.float64, device=dev)
    rowmax.scatter_reduce_(0, rows_all[:, None].expand(-1, B), rmax_r, "amax")
    rowmax.scatter_reduce_(0, cols_all[:, None].expand(-1, B), rmax_c, "amax")
    u = pow2_grid(torch.sqrt(2.0 * rowmax.reshape(-1)))   # (n,)

    idx = torch.nonzero(m.rows <= m.cols).reshape(-1)
    rows = m.rows[idx]
    cols = m.cols[idx]
    # int32 exactness guard: per-level products |q_x q_a| summed over
    # B * (terms per output row) * pairs; each output row receives direct
    # terms from its row's stored entries and mirror terms from its
    # column's.  2*(_BITS-1)+1 bits per product leave room for the carry
    # overlap of neighbouring planes.
    terms = torch.zeros((nbr,), dtype=torch.int32, device=dev)
    terms.index_add_(0, rows.long(), torch.ones_like(rows))
    terms.index_add_(0, cols.long(), (rows != cols).to(torch.int32))
    max_terms = int(terms.max())
    if (2 * (_BITS - 1) + 1
            + math.ceil(math.log2(B * max_terms * min(na, 8)))) > 31:
        raise ValueError(
            f"block {B} x {max_terms} terms/row overflows exact int32 "
            "accumulation")

    u2 = u.reshape(nbr, B)
    parts = []
    for s in range(0, idx.shape[0], chunk):
        e = idx[s:s + chunk]
        r = rows_all[e]
        c = cols_all[e]
        # T_e[j, k] = A[rB+k, cB+j] -> grid u_c[j] * u_r[k]
        t = (m.blocks_t[e].to(torch.float64)
             / u2[c][:, :, None] / u2[r][:, None, :])
        sl = slice_scaled(t, n_slices=na, bits=_BITS)    # (na, ch, B, B)
        del t
        parts.append(sl.permute(1, 2, 0, 3).reshape(-1, B, na * B))
    slices = (torch.cat(parts) if parts
              else torch.zeros((0, B, na * B), dtype=torch.int8, device=dev))
    del parts

    # per-entry plane truncation: an entry whose plane 0 is all zero goes to
    # the narrow bucket with plane 0 dropped (exact: only zero planes go)
    nzp = slices.reshape(-1, B, na, B).ne(0).any(dim=3).any(dim=1)
    in_b0 = nzp[:, 0]
    i0 = torch.nonzero(in_b0).reshape(-1)
    i1 = torch.nonzero(~in_b0 & nzp.any(dim=1)).reshape(-1)

    return SymSlicedBSR(
        slices=slices[i0],
        u_scale=u,
        diagonal=bsr_diagonal(m).to(torch.float64),
        rows=rows[i0].contiguous(),
        cols=cols[i0].contiguous(),
        slices1=slices[i1][:, :, B:].contiguous(),
        rows1=rows[i1].contiguous(),
        cols1=cols[i1].contiguous(),
        n=m.n,
        block=B,
        na=na,
        max_row_terms=max_terms,
    )


_PLAIN_CHUNK = 32   # entries per batched product in sym_spmm_plain


def sym_worklist(rows: torch.Tensor, cols: torch.Tensor, nbr: int):
    """Kernel K1's work list of one bucket: ``(items, item_start)``, int32.

    Every (entry, direction) pair once, grouped by the block row it adds
    to: the direct term of entry e (code 2e) goes to block row rows[e], the
    mirror term (code 2e + 1) to cols[e], and only off the diagonal.  The
    items of block row r are ``items[item_start[r]:item_start[r + 1]]``
    (``item_start`` has nbr + 1 entries), entries in store order within a
    direction, the direct terms first."""
    rows, cols = rows.long(), cols.long()
    e = torch.arange(rows.shape[0], device=rows.device)
    off = rows != cols
    dest = torch.cat([rows, cols[off]])
    order = torch.argsort(dest, stable=True)
    items = torch.cat([2 * e, 2 * e[off] + 1])[order].to(torch.int32)
    item_start = torch.searchsorted(
        dest[order], torch.arange(nbr + 1, device=rows.device))
    return items.contiguous(), item_start.to(torch.int32)


def sym_spmm_plain(xs, slices, rows, cols, acc, *, nx: int, na: int,
                   nlev: int, plane_off: int, items=None, item_start=None):
    """The plain torch version of kernel K1: adds one bucket's level sums
    into the int32 accumulator ``acc`` (nlev*k, n), in place.

    ``xs`` (nx*k, n) int8 x planes; ``slices`` (m, B, width*B) int8 with
    the bucket's first stored plane at original index ``plane_off``;
    ``rows``/``cols`` (m,) block coordinates.  Pair (x plane ix, stored
    plane i) goes to level plane_off + i + ix when that is below nlev.
    The products are float64 matmuls of the planes, exact because every
    partial sum is an integer below 2^53.  ``items``/``item_start`` (the
    kernel's :func:`sym_worklist`) are accepted and not needed.
    """
    m, B = slices.shape[0], slices.shape[1]
    n = xs.shape[1]
    k = xs.shape[0] // nx
    nbr = n // B
    f64 = torch.float64
    xb = xs.reshape(nx * k, nbr, B)
    lev = torch.zeros((nlev, k, nbr, B), dtype=f64, device=xs.device)
    for s in range(0, m, _PLAIN_CHUNK):
        e = slice(s, s + _PLAIN_CHUNK)
        r = rows[e].long()
        c = cols[e].long()
        t = slices[e, :, :na * B].to(f64)                  # (E, B, na*B)
        e_n = t.shape[0]
        # direct: y_r += x_c @ T_e
        xc = xb[:, c, :].permute(1, 0, 2).to(f64)          # (E, nx*k, B)
        prod = (xc @ t).reshape(e_n, nx, k, na, B)
        _fold(lev, prod, r, nx, na, nlev, plane_off)
        # mirror: y_c += x_r @ T_e^T, off the diagonal only
        off = r != c
        if bool(off.any()):
            t2 = t[off].reshape(-1, B, na, B).permute(0, 3, 2, 1)
            t2 = t2.reshape(-1, B, na * B)   # [e, l, i*B + j] = T_e[j, iB+l]
            xr = xb[:, r[off], :].permute(1, 0, 2).to(f64)
            prod = (xr @ t2).reshape(-1, nx, k, na, B)
            _fold(lev, prod, c[off], nx, na, nlev, plane_off)
    total = acc.to(torch.int64) + lev.reshape(nlev * k, n).to(torch.int64)
    acc.copy_(total.to(torch.int32))
    return acc


def _spmm_lib():
    lib = _build.library("sym_spmm")
    if not getattr(lib, "_typed", False):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sym_spmm.argtypes = [p] * 7 + [i32] * 8 + [p]
        lib.sym_spmm.restype = i32
        lib.sym_spmm_error_string.argtypes = [i32]
        lib.sym_spmm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def sym_spmm(xs, slices, rows, cols, acc, *, nx: int, na: int, nlev: int,
             plane_off: int, items=None, item_start=None):
    """Add one bucket's level sums into ``acc`` (kernel K1).

    Arguments as :func:`sym_spmm_plain`.  On CPU tensors this is the plain
    version; on CUDA tensors it launches ``csrc/sym_spmm.cu`` (one CTA per
    output block row and tile walking the bucket's :func:`sym_worklist`,
    int8 tensor-core products, bitwise equal to the plain version) or
    raises.  The work list is derived here when it is not given.
    """
    if xs.device.type == "cpu":
        return sym_spmm_plain(xs, slices, rows, cols, acc, nx=nx, na=na,
                              nlev=nlev, plane_off=plane_off)
    if xs.device.type != "cuda":
        raise ValueError(f"sym_spmm: unsupported device {xs.device}")
    m, B = slices.shape[0], slices.shape[1]
    n = xs.shape[-1]
    if items is None or item_start is None:
        items, item_start = sym_worklist(rows, cols, n // B if B > 0 else 0)
    for name, t, dt in (("xs", xs, torch.int8), ("slices", slices, torch.int8),
                        ("rows", rows, torch.int32),
                        ("cols", cols, torch.int32),
                        ("items", items, torch.int32),
                        ("item_start", item_start, torch.int32),
                        ("acc", acc, torch.int32)):
        if t.device != xs.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"sym_spmm: {name} must be a contiguous {dt} "
                             f"tensor on {xs.device}")
    width = slices.shape[2] // B if B else 0
    k = xs.numel() // (nx * n) if n and nx > 0 else 0
    if (B <= 0 or B % 64 or n % B or slices.ndim != 3
            or slices.shape[2] != width * B
            or xs.numel() != nx * k * n or tuple(acc.shape) != (nlev * k, n)
            or rows.shape != (m,) or cols.shape != (m,) or items.ndim != 1
            or n // B >= 65536 or item_start.shape != (n // B + 1,)
            or not 0 < nx <= 8 or na > min(width, 8)
            or nlev - plane_off > 9
            or xs.data_ptr() % 16 or slices.data_ptr() % 16
            or acc.data_ptr() % 16
            or max(n, 2 * m, nlev * k) >= 2 ** 31):
        raise ValueError(
            f"sym_spmm: unsupported shapes xs={tuple(xs.shape)} "
            f"slices={tuple(slices.shape)} acc={tuple(acc.shape)} nx={nx} "
            f"na={na} nlev={nlev} plane_off={plane_off}")
    if m == 0 or k == 0 or na <= 0 or plane_off >= nlev:
        return acc
    lib = _spmm_lib()
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = lib.sym_spmm(xs.data_ptr(), slices.data_ptr(), rows.data_ptr(),
                       cols.data_ptr(), items.data_ptr(),
                       item_start.data_ptr(), acc.data_ptr(), k, n, B, width,
                       nx, na, nlev, plane_off, stream)
    if err:
        raise RuntimeError(
            f"sym_spmm kernel: {lib.sym_spmm_error_string(err).decode()}")
    sym_spmm.launches += 1
    return acc


sym_spmm.launches = 0


def sym_sliced_matvec(m: SymSlicedBSR, *, dtype=torch.float64,
                      nx: int | None = None, nlev: int | None = None):
    """Matvec closure ``x: (k, n) -> (k, n)`` over the symmetric store.

    ``dtype`` float64 is the full-accuracy tier (nx = 8, all planes, 9
    levels, combined in float64); float32 the fast tier (nx = 4, the top 4
    planes, 4 levels, combined in float32).
    """
    nx, na_used, nlev = _tier_params(m.na, dtype, nx, nlev)
    if m.max_row_terms:
        pairs = min(nx, na_used)
        if (2 * (_BITS - 1) + math.ceil(
                math.log2(m.block * m.max_row_terms * pairs))) > 31:
            raise ValueError("tier overflows exact int32 accumulation")
    acc_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    w = combine_weights(nlev, _BITS, acc_dtype, device=m.u_scale.device)
    u = m.u_scale.to(acc_dtype)
    B, n = m.block, m.n
    buckets = []
    for rows_b, cols_b, slices_b, plane_off in (
            (m.rows, m.cols, m.slices, 0), (m.rows1, m.cols1, m.slices1, 1)):
        na_b = min(na_used - plane_off, slices_b.shape[-1] // B)
        if rows_b.shape[0] and na_b > 0:
            work = sym_worklist(rows_b, cols_b, n // B)
            buckets.append((rows_b, cols_b, slices_b, na_b, plane_off, work))

    def mv(x):
        k = x.shape[0]
        if not buckets:
            return torch.zeros_like(x, dtype=dtype)
        # fold the separable grid into x (exact power-of-two multiply), in
        # K2's launch on the card
        xs, sx = _slice_x(x, nx, col_scale=u, acc_dtype=acc_dtype)
        acc = torch.zeros((nlev * k, n), dtype=torch.int32, device=x.device)
        for rows_b, cols_b, slices_b, na_b, plane_off, work in buckets:
            sym_spmm(xs, slices_b, rows_b, cols_b, acc, nx=nx, na=na_b,
                     nlev=nlev, plane_off=plane_off, items=work[0],
                     item_start=work[1])
        y = _combine_levels(acc, w, nlev, k, n, acc_dtype)
        y = y * sx.to(acc_dtype) * u[None, :]
        return y.to(dtype)

    return replayable(mv)


def sliced_matvec_any(store, *, dtype=torch.float64, nx: int | None = None,
                      nlev: int | None = None):
    """Tier matvec closure for either sliced-store flavor: the symmetric
    :class:`SymSlicedBSR` (kernel K1) or the general
    :class:`~diaglib_tpu_torch.ops.bsr_sliced.SlicedBSR` (kernel K5)."""
    if isinstance(store, SymSlicedBSR):
        return sym_sliced_matvec(store, dtype=dtype, nx=nx, nlev=nlev)
    if isinstance(store, SlicedBSR):
        return sliced_bsr_matvec(store, dtype=dtype, nx=nx, nlev=nlev)
    raise TypeError(f"sliced_matvec_any: not a sliced store: {type(store)}")
