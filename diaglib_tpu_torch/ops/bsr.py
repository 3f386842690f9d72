"""Block-sparse-row (BSR) matrix container (port of the container parts of
``diaglib_tpu/ops/bsr.py``).

Vectors are rows (k, n) as everywhere in this library; entry e stores the
block A(rows[e], cols[e]) TRANSPOSED, ready for ``x_blk @ blocks_t[e]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["BSRMatrix", "bsr_to_dense", "bsr_diagonal", "random_bsr_spd",
           "bsr_from_arrays"]


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


def bsr_from_arrays(d: dict, device=None) -> BSRMatrix:
    """BSRMatrix from a dict of the JAX dataclass's fields (as numpy arrays
    or numbers, static fields included), e.g.
    ``{f.name: np.asarray(getattr(m, f.name)) for f in dataclasses.fields(m)}``."""
    def t(name, dtype=None):
        return torch.as_tensor(np.array(d[name]), dtype=dtype, device=device)

    return BSRMatrix(blocks_t=t("blocks_t"), rows=t("rows", torch.int32),
                     cols=t("cols", torch.int32),
                     row_start=t("row_start", torch.int32), n=int(d["n"]),
                     block=int(d["block"]))


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
    streams seeded with ``seed`` (not JAX's), made on ``device``.
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
    dev = torch.device(device) if device is not None else torch.device("cpu")
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
    boost = torch.zeros((nbr,), dtype=dtype, device=dev)
    if n_pairs:
        p_rows = torch.as_tensor([p[0] for p in pairs], device=dev)
        p_cols = torch.as_tensor([p[1] for p in pairs], device=dev)
        boost.index_add_(0, p_rows, row_mass).index_add_(0, p_cols, col_mass)
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
