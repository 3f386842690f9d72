"""ELLPACK sparse operator for scalar (non-block) sparsity (port of
``diaglib_tpu/ops/ell.py``).

Every row is padded to a fixed ``L`` slots, so that the matvec is L
gathers of x and L elementwise multiply-adds, one a slot, in slot order,
as the reference's ``lax.scan`` over the slots.  The reference runs it as
plain XLA, with no Pallas kernel, so it is plain torch here.  Padding
slots point at column 0 with value 0.0.

The builders run on the host with numpy, as the reference's do, and move
the result to ``device`` (the card unless the caller names another).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import host_array, resolve_device
from ..utils.graphs import replayable

__all__ = ["ELLMatrix", "ell_from_dense", "ell_from_coo", "ell_matvec",
           "ell_diagonal", "ell_to_dense"]


@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """Row-padded sparse matrix: vals (float) and cols (int32) are (n, L)."""

    vals: torch.Tensor
    cols: torch.Tensor
    n: int

    @property
    def slots(self) -> int:
        return self.vals.shape[1]

    @property
    def nnz(self) -> int:
        return int((self.vals != 0.0).sum())


def ell_from_coo(rows, cols, vals, n: int, device=None) -> ELLMatrix:
    """Build from COO triplets on the host (duplicates are summed), then
    move to ``device``."""
    dev = resolve_device(device)
    rows, cols, vals = host_array(rows), host_array(cols), host_array(vals)
    # sum duplicates (np.unique sorts by key; no presort needed)
    key = rows.astype(np.int64) * n + cols
    uniq, inv = np.unique(key, return_inverse=True)
    acc = np.zeros(len(uniq), vals.dtype)
    np.add.at(acc, inv, vals)
    rows, cols, vals = (uniq // n).astype(np.int32), (uniq % n).astype(
        np.int32), acc
    counts = np.bincount(rows, minlength=n)
    L = max(1, int(counts.max()))
    v = np.zeros((n, L), vals.dtype)
    c = np.zeros((n, L), np.int32)
    slot = np.concatenate([np.arange(k) for k in counts]) if len(rows) else []
    v[rows, slot] = vals
    c[rows, slot] = cols
    return ELLMatrix(vals=torch.as_tensor(v, device=dev),
                     cols=torch.as_tensor(c, device=dev), n=n)


def ell_from_dense(a, device=None) -> ELLMatrix:
    """Build from a dense (n, n) matrix (numpy or torch) on the host."""
    a = host_array(a)
    r, c = np.nonzero(a)
    return ell_from_coo(r, c, a[r, c], a.shape[0], device=device)


def ell_to_dense(m: ELLMatrix) -> torch.Tensor:
    out = torch.zeros((m.n, m.n), dtype=m.vals.dtype, device=m.vals.device)
    rows = torch.arange(m.n, device=m.vals.device)[:, None].expand(
        m.cols.shape)
    return out.index_put_((rows, m.cols.long()), m.vals, accumulate=True)


def ell_diagonal(m: ELLMatrix) -> torch.Tensor:
    hit = m.cols == torch.arange(m.n, device=m.cols.device)[:, None]
    return torch.where(hit, m.vals, 0.0).sum(dim=1)


def ell_matvec(m: ELLMatrix):
    """Matvec closure ``x: (k, n) -> (k, n)``; one gather and multiply-add
    a slot, in slot order."""
    vals_t = m.vals.T.contiguous()
    cols_t = m.cols.T.long().contiguous()

    def mv(x):
        out = torch.zeros_like(x)
        for v, c in zip(vals_t, cols_t):
            out += v[None, :] * x[:, c]
        return out

    return replayable(mv)
