"""Eigenvector guess generation and validation (port of
``diaglib_tpu/utils/guess.py``): the test driver's ``guess_evec``
strategies 1-6 (main.f90:1312-1397) and ``check_guess``
(diaglib.f90:3734-3786).  Random draws come from a ``torch.Generator``;
jax.random's streams are not reproduced."""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .mm import current_sharding, mmT, sum_n

__all__ = ["guess_evec", "check_guess"]


def _ortho_cd(*args, **kwargs):
    # imported lazily: ortho.core imports utils.masking, so a top-level
    # import here would be circular through the package __init__s
    from ..ortho.core import ortho_cd

    return ortho_cd(*args, **kwargs)


def guess_evec(strategy: int, generator: torch.Generator | None, n: int,
               m: int, diagonal=None, dtype=torch.float64,
               device=None) -> torch.Tensor:
    """Build an (m, n) guess block (rows are vectors).

    Strategies (main.f90:1337-1395):
      1: unit vectors at the m smallest diagonal entries
      2: unit vectors at the m largest diagonal entries
      3: uniform random in [0, 1)
      4: uniform random in [-0.5, 0.5)
      5: 0.01*random + unit vectors at the m largest diagonal entries
      6: 0.01*random + unit vectors at the m smallest diagonal entries

    The block is made on the diagonal's device when a diagonal tensor is
    given, else on ``device`` (the card by default, see
    ``_device.resolve_device``).  Ties in the diagonal are ordered as the
    reference orders them: a stable ascending sort of the diagonal (1, 6)
    or of its negation (2, 5), after the cast to ``dtype``.
    """
    if isinstance(diagonal, torch.Tensor):
        dev = diagonal.device
    else:
        dev = resolve_device(device)
        if diagonal is not None:
            diagonal = torch.as_tensor(np.asarray(diagonal), device=dev)

    def draw():
        return torch.rand((m, n), generator=generator, dtype=dtype,
                          device=dev)

    if strategy in (1, 2, 5, 6):
        if diagonal is None:
            raise ValueError("diagonal required for strategies 1/2/5/6")
        d = diagonal.to(dtype)
        order = torch.argsort(d if strategy in (1, 6) else -d, stable=True)
        onehots = torch.zeros((m, n), dtype=dtype, device=dev)
        onehots[torch.arange(m, device=dev), order[:m]] = 1.0
        if strategy in (1, 2):
            return onehots
        return 0.01 * draw() + onehots
    if strategy == 3:
        return draw()
    if strategy == 4:
        return draw() - 0.5
    raise ValueError(f"unknown guess strategy {strategy}")


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
        e, _, _ = _ortho_cd(e, mask)
    return e
