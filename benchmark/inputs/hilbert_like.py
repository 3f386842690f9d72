"""Generator ``hilbert_like``: the upstream diaglib's own symmetric test
matrix (``main.f90`` test_symm, lines 311-317), ``a(i,i) = i+1`` and
``a(i,j) = 1/(i+j)`` for 1-based i, j, in float64, dense, handed over as
a block-sparse matrix with every block stored.

The matrix holds no random numbers: the seed changes nothing in it (each
solve's guess draws its noise from the seed elsewhere).  Configuration
``params``: ``n`` and ``block`` (the block size the dense matrix is cut
into; ``n`` a multiple of it).
"""

from __future__ import annotations

import torch


def build(n: int, block: int, *, device) -> dict:
    """The matrix as arrays on ``device``: ``blocks_t`` (nbr^2, B, B),
    float64, entry e holding block (rows[e], cols[e]) transposed, entries
    in (row, column) order; ``rows``, ``cols``, ``row_start`` (int32);
    ``n``; ``block``."""
    if n % block:
        raise ValueError("n must be divisible by block")
    nbr, B = n // block, block
    dev = torch.device(device)
    idx = torch.arange(1, n + 1, dtype=torch.float64, device=dev)
    idx = idx.reshape(nbr, B)
    # blocks_t[r, c, j, k] = a(rB+k, cB+j) = 1 / (i + j'), made in one call
    blocks_t = 1.0 / (idx[:, None, None, :] + idx[None, :, :, None])
    # the view [r, k] of blocks_t[r, r, k, k]
    blocks_t.diagonal(dim1=0, dim2=1).diagonal(dim1=0, dim2=1).copy_(
        idx + 1.0)
    r = torch.arange(nbr, dtype=torch.int32, device=dev)
    return {
        "blocks_t": blocks_t.reshape(nbr * nbr, B, B),
        "rows": r.repeat_interleave(nbr),
        "cols": r.repeat(nbr),
        "row_start": r * nbr,
        "n": n,
        "block": block,
    }


def make(params: dict, seed: int, device) -> dict:
    """The configuration's inputs: ``{"a": arrays}`` (the same for every
    seed)."""
    return {"a": build(params["n"], params["block"], device=device)}


def shapes(params: dict) -> dict:
    """Sizes of the operator, from the configuration alone: ``n``,
    ``block``, the stored blocks (all of them) and the distinct ones (the
    diagonal blocks and one of each mirrored pair)."""
    nbr = params["n"] // params["block"]
    return {"a": {"n": params["n"], "block": params["block"],
                  "stored_blocks": nbr * nbr,
                  "distinct_blocks": nbr * (nbr + 1) // 2}}
