"""Eigenvector guess validation (port of ``check_guess`` of
``diaglib_tpu/utils/guess.py``)."""

from __future__ import annotations

import torch

from ..ortho.core import ortho_cd
from .mm import current_sharding, mmT, sum_n

__all__ = ["check_guess"]


def check_guess(evec: torch.Tensor, generator: torch.Generator | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Validate/repair a guess block (rows are vectors).

    If ``evec`` is identically zero, draw a uniform random guess from
    ``generator`` and orthonormalize it.  Otherwise re-orthonormalize
    unless the valid rows are exactly orthonormal by the overlap's
    diagonal/off-diagonal norms (exact float comparisons, as the
    reference does).

    Under a sharding ``evec`` is the rank's column shard; the norm and the
    overlap are reduced over the ranks, and the random fallback draws the
    global (m, n) block and keeps its columns, so a sharded solve starts
    where the unsharded one does (given equally seeded generators).
    """
    m, n = evec.shape
    if mask is None:
        mask = torch.ones((m,), dtype=torch.bool, device=evec.device)
    mvalid = int(mask.sum())
    e = torch.where(mask[:, None], evec, 0.0)
    fac = float(torch.sqrt(sum_n(e * e)))
    if fac == 0.0:
        sh = current_sharding()
        shape = (m, n if sh is None else sh.n)
        rnd = torch.rand(shape, generator=generator, dtype=evec.dtype,
                         device=evec.device)
        if sh is not None:
            rnd = sh.local_cols(rnd)
        e = torch.where(mask[:, None], rnd, 0.0)
    overlap = mmT(e, e)
    diag = torch.diagonal(overlap)
    diag_norm = float((torch.where(mask, diag, 0.0) ** 2).sum()
                      / max(mvalid, 1))
    outer = mask[:, None] & mask[None, :]
    strict = torch.triu(torch.where(outer, overlap, 0.0), diagonal=1)
    out_norm = float((strict ** 2).sum())
    if fac == 0.0 or diag_norm != 1.0 or out_norm != 0.0:
        e, _, _ = ortho_cd(e, mask)
    return e
