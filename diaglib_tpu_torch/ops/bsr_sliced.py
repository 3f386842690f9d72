"""Shared parts of the integer-sliced BSR operators (port of the pieces of
``diaglib_tpu/ops/bsr_sliced.py`` that the symmetric store uses).

7-bit slices on a half power-of-two grid (|t| <= 1/2 keeps every plane at
|q| <= 64, inside int8): 8 planes cover 7*8-1 = 55 >= 53 mantissa bits.
The float64 tier slices x into nx = 8 planes, the float32 tier into 4.
"""

from __future__ import annotations

import torch

from .slicing import slice_operand

_BITS = 7


def _slice_x(x: torch.Tensor, nx: int):
    """Row-aligned int8 planes of x, ``(nx*k, n)``, and the row scales
    ``sx`` (``(k, 1)``, ``sx = 2 * pow2_grid(max|x|)``).  The float64 tier
    (nx > 4) peels x in float64; the float32 tier keeps x's dtype and
    returns sx in it."""
    k, n = x.shape
    work = x.to(torch.float64) if nx > 4 else x
    planes, sx = slice_operand(work, n_slices=nx, bits=_BITS)
    if x.dtype != torch.float64:
        sx = sx.to(x.dtype)
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
