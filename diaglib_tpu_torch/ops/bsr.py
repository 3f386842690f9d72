"""Block-sparse-row (BSR) operator (port of ``diaglib_tpu/ops/bsr.py``).

Vectors are rows (k, n) as everywhere in this library; entry e stores the
block A(rows[e], cols[e]) TRANSPOSED, ready for ``x_blk @ blocks_t[e]``,
so the matvec is

    y[:, r*B:(r+1)*B] = sum over e in row r of x[:, c_e*B:(c_e+1)*B] @ T_e.

:func:`bsr_spmm` is the wrapper of the CUDA kernel ``csrc/bsr_spmm.cu``
(kernel K4, float32 and bfloat16); on CPU tensors, and for float64 in
:func:`bsr_matvec`, the plain torch product :func:`bsr_spmm_plain` runs, as
the reference computes float64 outside its kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..utils.graphs import replayable
from . import _build

__all__ = ["BSRMatrix", "bsr_from_dense", "bsr_to_dense", "bsr_diagonal",
           "bsr_matvec", "bsr_spmm", "bsr_spmm_plain", "random_bsr_spd",
           "bsr_from_arrays", "row_slots", "segment_sum", "entry_products"]


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Square block-sparse matrix with uniform B x B blocks.

    blocks_t: (nnzb, B, B) — the e-th block stored transposed.
    rows:     (nnzb,) int32 block-row index of each entry (sorted ascending).
    cols:     (nnzb,) int32 block-col index of each entry.
    row_start:(nbr,) int32 index of the first entry of each block row.
    n:        matrix dimension (nbr * B).
    """

    blocks_t: torch.Tensor
    rows: torch.Tensor
    cols: torch.Tensor
    row_start: torch.Tensor
    n: int
    block: int

    @property
    def nnzb(self) -> int:
        return self.blocks_t.shape[0]

    @property
    def nnz(self) -> int:
        return self.nnzb * self.block * self.block


def as_arrays(obj) -> dict:
    """The fields of a dataclass instance (for example one of the JAX
    package's operators) as a dict of numpy arrays and numbers; a dict is
    returned as it is."""
    if isinstance(obj, dict):
        return obj
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def bsr_from_arrays(d, device=None, dtype=None) -> BSRMatrix:
    """BSRMatrix from the JAX dataclass's fields: a dict of numpy arrays or
    numbers (static fields included), or the dataclass itself (see
    :func:`as_arrays`).  ``dtype`` converts the blocks.  Built on the
    current CUDA device unless ``device`` names another (RuntimeError
    without a card: pass ``device="cpu"``)."""
    device = resolve_device(device)
    d = as_arrays(d)

    def t(name, dtype=None):
        return torch.as_tensor(np.array(d[name]), dtype=dtype, device=device)

    m = BSRMatrix(blocks_t=t("blocks_t", dtype), rows=t("rows", torch.int32),
                  cols=t("cols", torch.int32),
                  row_start=t("row_start", torch.int32), n=int(d["n"]),
                  block=int(d["block"]))
    nbr = m.n // m.block if m.block else 0
    if (m.block <= 0 or m.n % m.block
            or tuple(m.blocks_t.shape) != (m.rows.shape[0], m.block, m.block)
            or m.cols.shape != m.rows.shape or m.row_start.shape != (nbr,)
            or (m.nnzb and not (int(m.rows.min()) >= 0
                                and int(m.rows.max()) < nbr
                                and int(m.cols.min()) >= 0
                                and int(m.cols.max()) < nbr
                                and bool((m.rows[1:] >= m.rows[:-1]).all())))
            or (nbr and not (int(m.row_start.min()) >= 0
                             and int(m.row_start.max()) <= m.nnzb))):
        raise ValueError("bsr_from_arrays: malformed BSR arrays")
    return m


def bsr_from_dense(a, block: int) -> BSRMatrix:
    """Build a BSR matrix from a dense array (numpy or torch), dropping
    all-zero blocks.  An empty block row gets one zero diagonal block, as
    in the reference, so the arrays equal the reference's (kernel K4 needs
    no such entry: an empty row writes zeros)."""
    dev = a.device if isinstance(a, torch.Tensor) else None
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    n = a.shape[0]
    if n % block or a.shape[0] != a.shape[1]:
        raise ValueError("dense matrix must be square with n % block == 0")
    nbr = n // block
    rows, cols, blocks = [], [], []
    for r in range(nbr):
        found = False
        for c in range(nbr):
            blk = a[r * block:(r + 1) * block, c * block:(c + 1) * block]
            if np.any(blk != 0.0):
                rows.append(r)
                cols.append(c)
                blocks.append(blk.T)
                found = True
        if not found:
            rows.append(r)
            cols.append(r)
            blocks.append(np.zeros((block, block), a.dtype))
    return BSRMatrix(
        blocks_t=torch.as_tensor(np.stack(blocks), device=dev),
        rows=torch.as_tensor(np.asarray(rows, np.int32), device=dev),
        cols=torch.as_tensor(np.asarray(cols, np.int32), device=dev),
        row_start=torch.as_tensor(np.searchsorted(
            np.asarray(rows), np.arange(nbr)).astype(np.int32), device=dev),
        n=n,
        block=block,
    )


def bsr_to_dense(m: BSRMatrix) -> torch.Tensor:
    """Dense reconstruction (tests/oracles only)."""
    B = m.block
    nbr = m.n // B
    out = torch.zeros((nbr, B, nbr, B), dtype=m.blocks_t.dtype,
                      device=m.blocks_t.device)
    out[m.rows.long(), :, m.cols.long(), :] = m.blocks_t.transpose(1, 2)
    return out.reshape(m.n, m.n)


def bsr_diagonal(m: BSRMatrix) -> torch.Tensor:
    """(n,) main diagonal — the input to mprec-style preconditioners."""
    nbr = m.n // m.block
    is_diag = (m.rows == m.cols)
    contrib = torch.diagonal(m.blocks_t, dim1=1, dim2=2)
    contrib = torch.where(is_diag[:, None], contrib, 0.0)
    d = torch.zeros((nbr, m.block), dtype=m.blocks_t.dtype,
                    device=m.blocks_t.device)
    d.index_add_(0, m.rows.long(), contrib)
    return d.reshape(-1)


_PLAIN_CHUNK = 64     # entries per batched product in bsr_spmm_plain


def row_slots(rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``(n_rows, P)`` int64 indices of each row's entries in entry order
    (P the most entries a row), padded with ``len(rows)``: the fixed order
    of :func:`segment_sum`.  Built on the host from ``rows``, on its
    device."""
    r = rows.cpu().numpy().astype(np.int64)
    counts = np.bincount(r, minlength=n_rows) if len(r) else \
        np.zeros(n_rows, np.int64)
    width = max(int(counts.max()) if n_rows else 0, 1)
    slots = np.full((n_rows, width), len(r), np.int64)
    order = np.argsort(r, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(r)) - np.repeat(starts, counts)
    slots[r[order], pos] = order
    return torch.as_tensor(slots, device=rows.device)


def segment_sum(prods: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Row sums of the per-entry products ``prods`` (E, ...) over
    :func:`row_slots`: each row's terms added in one fixed order, so the
    result is the same on every call (``index_add_`` on a CUDA tensor adds
    them in the order its atomics land)."""
    pad = prods.new_zeros((1,) + tuple(prods.shape[1:]))
    return torch.cat([prods, pad])[slots].sum(dim=1)


def entry_products(cols: torch.Tensor, blocks_t: torch.Tensor,
                   xb: torch.Tensor) -> torch.Tensor:
    """``xb[cols[e]] @ blocks_t[e]`` for every entry e, a chunk of entries
    at a time; xb (block columns, k, B) in the accumulation type."""
    prods = torch.empty((blocks_t.shape[0],) + tuple(xb.shape[1:]),
                        dtype=xb.dtype, device=xb.device)
    for s in range(0, blocks_t.shape[0], _PLAIN_CHUNK):
        e = slice(s, s + _PLAIN_CHUNK)
        prods[e] = xb[cols[e].long()] @ blocks_t[e].to(xb.dtype)
    return prods


def bsr_spmm_plain(m: BSRMatrix, x: torch.Tensor,
                   slots: torch.Tensor | None = None) -> torch.Tensor:
    """The plain torch version of kernel K4: ``y = x @ A^T``.

    Gathers x's block columns, multiplies them by the blocks a chunk of
    entries at a time and sums each block row's products in entry order
    (:func:`segment_sum`, the same bits on every call; ``slots`` is
    :func:`row_slots` of the rows, derived here, with a read of the
    device, when not given).  It computes in float64 when x or the blocks
    are float64 and in float32 otherwise (bfloat16 widened), and returns
    x's dtype.
    """
    B = m.block
    k = x.shape[0]
    nbr = m.n // B
    if slots is None:
        slots = row_slots(m.rows, nbr)
    acc = (torch.float64 if torch.float64 in (x.dtype, m.blocks_t.dtype)
           else torch.float32)
    xb = x.to(acc).reshape(k, nbr, B).transpose(0, 1)        # (nbr, k, B)
    out = segment_sum(entry_products(m.cols, m.blocks_t, xb), slots)
    return out.transpose(0, 1).reshape(k, m.n).to(x.dtype)


_K4_TYPES = {torch.float32: 0, torch.bfloat16: 1}


def _spmm_lib():
    lib = _build.library("bsr_spmm")
    if not getattr(lib, "_typed", False):
        p, i32 = ctypes.c_void_p, ctypes.c_int
        lib.bsr_spmm.argtypes = [i32, i32, p, p, p, p, p] + [i32] * 5 + [p]
        lib.bsr_spmm.restype = i32
        lib.bsr_spmm_error_string.argtypes = [i32]
        lib.bsr_spmm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def bsr_spmm(m: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """``y = x @ A^T`` for float32 / bfloat16 x and blocks (kernel K4).

    On CPU tensors this is :func:`bsr_spmm_plain`; on CUDA tensors it
    launches ``csrc/bsr_spmm.cu`` (float32 accumulation; persistent CTAs
    stream the blocks through a ring of asynchronous copies) or raises.
    y has x's dtype.
    """
    if x.device.type == "cpu":
        return bsr_spmm_plain(m, x)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmm: unsupported device {x.device}")
    if x.dtype not in _K4_TYPES or m.blocks_t.dtype not in _K4_TYPES:
        raise ValueError(f"bsr_spmm: x {x.dtype} and blocks "
                         f"{m.blocks_t.dtype} must be float32 or bfloat16")
    for name, t, dt in (("blocks_t", m.blocks_t, m.blocks_t.dtype),
                        ("cols", m.cols, torch.int32),
                        ("row_start", m.row_start, torch.int32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"bsr_spmm: {name} must be a contiguous {dt} "
                             f"tensor on {x.device}")
    B, n = m.block, m.n
    nbr = n // B if B else 0
    if (x.ndim != 2 or x.shape[1] != n or B <= 0 or n % B
            or m.row_start.shape != (nbr,) or m.cols.shape != (m.nnzb,)
            or max(n, m.nnzb, x.shape[0]) >= 2 ** 31):
        raise ValueError(f"bsr_spmm: x {tuple(x.shape)} against n={n}, "
                         f"B={B}, nnzb={m.nnzb}")
    x = x.contiguous()
    y = torch.empty_like(x)
    k = x.shape[0]
    if k == 0:
        return y
    lib = _spmm_lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.bsr_spmm(_K4_TYPES[x.dtype], _K4_TYPES[m.blocks_t.dtype],
                       x.data_ptr(), m.blocks_t.data_ptr(), m.cols.data_ptr(),
                       m.row_start.data_ptr(), y.data_ptr(), k, n, B, nbr,
                       m.nnzb, stream)
    if err:
        raise RuntimeError(
            f"bsr_spmm kernel: {lib.bsr_spmm_error_string(err).decode()}")
    bsr_spmm.launches += 1
    return y


bsr_spmm.launches = 0


def bsr_matvec(m: BSRMatrix, *, force_reference: bool = False):
    """Row-block matvec closure ``x: (k, n) -> (k, n)`` for the solvers.

    float32 and bfloat16 blocks go to kernel K4 (:func:`bsr_spmm`, its
    plain version on the CPU); float64 blocks to the plain float64 segment
    product :func:`bsr_spmm_plain` on the blocks' device, as the reference
    computes float64 outside its kernel.  ``force_reference=True`` asks for
    :func:`bsr_spmm_plain` at every dtype, on the blocks' device, as the
    reference's keyword forces its segment-sum path.  The plain product's
    row order (:func:`row_slots`) is derived once, here, so that a call
    reads nothing back from the device.
    """
    plain = force_reference or m.blocks_t.dtype == torch.float64
    slots = row_slots(m.rows, m.n // m.block) if plain else None

    def mv(x):
        if plain:
            return bsr_spmm_plain(m, x, slots)
        return bsr_spmm(m, x)

    return replayable(mv)


def random_bsr_spd(n: int, block: int, blocks_per_row: int, seed: int,
                   dtype=torch.float32, n_low_modes: int = 20,
                   off_scale: float = 0.3, device=None) -> BSRMatrix:
    """Random SPD-ish block-sparse test matrix with a dominant diagonal.

    The same construction as the JAX package's ``random_bsr_spd``: the
    block diagonal plus ``blocks_per_row - 1`` symmetric off-diagonal block
    pairs per row, diagonal blocks made dominant so the matrix is SPD, and
    ``n_low_modes`` diagonal entries pulled below the bulk so the low end of
    the spectrum is a set of separated eigenvalues.  The sparsity pattern is
    the JAX package's exactly; the values come from ``torch.Generator``
    streams seeded with ``seed`` (not JAX's), made on ``device`` (the CUDA
    device by default; see :func:`~diaglib_tpu_torch._device.resolve_device`).
    """
    if n % block:
        raise ValueError("n must be divisible by block")
    nbr = n // block
    B = block
    # ---- host: sparsity pattern ----
    pair_set = set()
    for r in range(nbr):
        for jj in range(blocks_per_row - 1):
            c = (r + 1 + jj * max(1, nbr // blocks_per_row)) % nbr
            lo, hi = min(r, c), max(r, c)
            if lo != hi:
                pair_set.add((lo, hi))
    pairs = sorted(pair_set)                      # upper-triangle pairs
    n_pairs = len(pairs)
    entries = [(r, r, -1, False) for r in range(nbr)]   # (row, col, pair, transposed)
    for pidx, (r, c) in enumerate(pairs):
        entries.append((r, c, pidx, False))
        entries.append((c, r, pidx, True))
    entries.sort(key=lambda t: (t[0], t[1]))
    rows = np.asarray([t[0] for t in entries], np.int32)
    cols = np.asarray([t[1] for t in entries], np.int32)
    pair_of = np.asarray([t[2] for t in entries], np.int32)
    transposed = np.asarray([t[3] for t in entries], bool)
    nnzb = len(entries)

    rng = np.random.default_rng(seed)
    low_rows = np.sort(rng.choice(n, size=min(n_low_modes, n), replace=False))
    low_vals = np.linspace(0.5, 4.0, len(low_rows))

    # ---- device: block data ----
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    scale = float(off_scale / np.sqrt(B))
    off = scale * torch.randn((max(n_pairs, 1), B, B), generator=gen,
                              dtype=dtype, device=dev)
    sym = torch.randn((nbr, B, B), generator=gen, dtype=dtype, device=dev) \
        * float(1.0 / np.sqrt(B))
    # exact symmetry by construction: mirror the strict lower triangle so
    # (i, j) and (j, i) are the same stored value
    low = torch.tril(sym, -1)
    sym = low + low.transpose(1, 2) + torch.diag_embed(
        torch.diagonal(sym, dim1=1, dim2=2))
    del low

    # diagonal dominance: per-row accumulated off-block row/col mass
    row_mass = off.abs().sum(dim=2).amax(dim=1)
    col_mass = off.abs().sum(dim=1).amax(dim=1)
    # summed on the host: on a card, index_add_ adds a row's terms in the
    # order its atomics land, and the last bit of the largest sum moves
    # every diagonal entry (base), so two builds from one seed could differ
    boost = torch.zeros((nbr,), dtype=dtype)
    if n_pairs:
        p_rows = torch.as_tensor([p[0] for p in pairs])
        p_cols = torch.as_tensor([p[1] for p in pairs])
        boost.index_add_(0, p_rows, row_mass.cpu()).index_add_(
            0, p_cols, col_mass.cpu())
    boost = boost.to(dev)
    sym_rowmax = sym.abs().sum(dim=2).amax(dim=1)
    base = (boost + sym_rowmax).max() + 1.0

    diag_vals = base + 10.0 + 3.0 * torch.rand((n,), generator=gen,
                                               dtype=dtype, device=dev)
    diag_vals[torch.as_tensor(low_rows, device=dev)] = \
        base + torch.as_tensor(low_vals, dtype=dtype, device=dev)
    dia = sym + torch.diag_embed(diag_vals.reshape(nbr, B))
    del sym

    # assemble blocks_t (entry e stores A(r_e, c_e)^T)
    blocks_t = torch.empty((nnzb, B, B), dtype=dtype, device=dev)
    blocks_t[torch.as_tensor(np.nonzero(pair_of < 0)[0], device=dev)] = dia
    if n_pairs:
        fwd = np.nonzero((pair_of >= 0) & ~transposed)[0]
        bwd = np.nonzero((pair_of >= 0) & transposed)[0]
        # A(r,c) = G  -> store G^T;  A(c,r) = G^T -> store G
        blocks_t[torch.as_tensor(fwd, device=dev)] = \
            off[torch.as_tensor(pair_of[fwd], device=dev)].transpose(1, 2)
        blocks_t[torch.as_tensor(bwd, device=dev)] = \
            off[torch.as_tensor(pair_of[bwd], device=dev)]

    return BSRMatrix(
        blocks_t=blocks_t,
        rows=torch.as_tensor(rows, device=dev),
        cols=torch.as_tensor(cols, device=dev),
        row_start=torch.as_tensor(
            np.searchsorted(rows, np.arange(nbr)).astype(np.int32),
            device=dev),
        n=n,
        block=block,
    )
