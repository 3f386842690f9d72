"""Row and mask helpers of the solvers (port of the parts of
``diaglib_tpu/utils/masking.py`` the Davidson slice uses).

The solvers keep their subspaces in fixed ``(lda_pad, n)`` buffers, like
the JAX package, so the state matches it row for row.  Starts and counts
may be Python ints or 0-d tensors on the buffers' device: the Davidson
iteration keeps them on the device, so that its steps read nothing back
and can be captured as CUDA graphs (``utils/graphs.py``).
:func:`scatter_rows` writes in place, since a captured step must write
into buffers whose addresses do not move.
"""

from __future__ import annotations

import torch

from . import reduced

__all__ = ["prefix_mask", "gather_rows", "scatter_rows", "masked_cholesky",
           "masked_eigh", "masked_eigh_prefix", "masked_svd", "prefix_lock"]


def prefix_mask(k: int, count, dtype=torch.bool,
                device=None) -> torch.Tensor:
    """(k,) mask of ``dtype``, true (1) for indices < count (an int or a
    0-d tensor on ``device``)."""
    return (torch.arange(k, device=device) < count).to(dtype)


def _row_index(start, width: int, rows: int, device) -> torch.Tensor:
    """Indices ``start + [0, width)``, clamped to ``[0, rows)``."""
    return (start + torch.arange(width, device=device)).clamp(0, rows - 1)


def gather_rows(x: torch.Tensor, start, width: int,
                count=None) -> torch.Tensor:
    """Rows ``[start, start+width)`` of x (indices clipped to the buffer),
    rows >= ``count`` (relative) zeroed."""
    out = x.index_select(0, _row_index(start, width, x.shape[0], x.device))
    if count is not None:
        drop = torch.arange(width, device=x.device) >= count
        out = out.masked_fill(drop.view((width,) + (1,) * (x.ndim - 1)), 0)
    return out


def scatter_rows(x: torch.Tensor, block: torch.Tensor,
                 start) -> torch.Tensor:
    """Write ``block`` into x at row ``start``, in place, and return x; the
    start is clamped so the block fits, as ``lax.dynamic_update_slice``
    does."""
    k = block.shape[0]
    first = (start.clamp(0, x.shape[0] - k) if isinstance(start, torch.Tensor)
             else min(max(int(start), 0), x.shape[0] - k))
    idx = first + torch.arange(k, device=x.device)
    return x.index_copy_(0, idx, block.to(x.dtype))


def masked_cholesky(a: torch.Tensor, mask: torch.Tensor):
    """Lower Cholesky factor of the masked SPD matrix (identity padding).

    Returns (L, failed): ``failed`` is a 0-d bool tensor, true when the
    matrix is not numerically positive definite (the factorization stopped
    or produced non-finite entries)."""
    outer = mask[:, None] & mask[None, :]
    a_m = torch.where(outer, a, 0.0) + torch.diag(
        torch.where(mask, 0.0, 1.0).to(a.dtype))
    chol, info = torch.linalg.cholesky_ex(a_m)
    failed = (info != 0) | ~torch.isfinite(chol).all()
    return chol, failed


def _pad_value(a: torch.Tensor, outer: torch.Tensor) -> torch.Tensor:
    """Gershgorin-style strict upper bound on |eigenvalues| of the masked
    part."""
    return torch.where(outer, a, 0.0).abs().sum(dim=1).max() + 1.0


def masked_pad(a: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The matrix :func:`masked_eigh` solves: masked rows and columns of
    symmetric ``a`` replaced by a diagonal pad above the genuine spectrum
    (device ops only, so a captured step can make it)."""
    outer = mask[:, None] & mask[None, :]
    pad = _pad_value(a, outer)
    return torch.where(outer, a, 0.0) + torch.diag(
        torch.where(mask, 0.0, pad).to(a.dtype))


def masked_eigh(a: torch.Tensor, mask: torch.Tensor,
                method: str = "device", v0=None, off_tol=0.0):
    """eigh of the masked symmetric matrix.

    Masked rows and columns are replaced by a diagonal pad above the
    genuine spectrum (:func:`masked_pad`), so the genuine eigenpairs come
    first (ascending) and their eigenvectors are exactly zero on masked
    rows (the padded matrix is block diagonal).  ``method``, ``v0`` and
    ``off_tol`` as utils.reduced.eigh.
    """
    return reduced.eigh(masked_pad(a, mask), method, v0=v0, off_tol=off_tol)


def masked_svd(a: torch.Tensor, mask: torch.Tensor, method: str = "device",
               off_tol=0.0):
    """SVD of the masked square matrix, genuine triplets leading.

    Masked rows and columns are padded with a diagonal strictly above the
    genuine spectrum (a Frobenius bound + 2), so that no pad singular value
    falls among the genuine ones; the triplets are then stably re-sorted by
    genuineness (a left singular vector supported on valid rows is
    genuine), which gives the SVD of the compacted matrix at the leading
    positions.  ``method`` and ``off_tol`` as utils.reduced.svd.
    """
    outer = mask[:, None] & mask[None, :]
    a_v = torch.where(outer, a, 0.0)
    pad = torch.sqrt((a_v * a_v).sum()) + 2.0
    a_m = a_v + torch.diag(torch.where(mask, 0.0, pad).to(a.dtype))
    u, s, vt = reduced.svd(a_m, method, off_tol=off_tol)
    score = (torch.where(mask[:, None], u, 0.0) ** 2).sum(dim=0)
    order = torch.argsort((score <= 0.5).to(torch.int8), stable=True)
    return u[:, order], s[order], vt[order, :]


def masked_eigh_prefix(a: torch.Tensor, ldu: int, method: str = "device",
                       v0=None, off_tol=0.0):
    """eigh of the leading ``ldu x ldu`` block of symmetric ``a``, padded
    to a's full size: the genuine eigenpairs ascending in the leading
    positions, the rest at a Gershgorin bound above the genuine spectrum
    with zero eigenvector columns.  ``method`` and ``off_tol`` as
    utils.reduced.eigh; ``v0``, a full-width warm start (the previous
    call's ``v``), is cut to the block, its zero columns replaced by
    identity columns so that it stays orthonormal when the block grew."""
    full = a.shape[0]
    lead = a[:ldu, :ldu]
    pad = lead.abs().sum(dim=1).max() + 1.0
    if v0 is not None:
        v0 = v0[:ldu, :ldu]
        fill = (v0 * v0).sum(dim=0) == 0.0
        v0 = v0 + torch.diag(fill.to(a.dtype))
    w, v = reduced.eigh(lead, method, v0=v0, off_tol=off_tol)
    w_out = torch.cat([w, pad.expand(full - ldu)])
    v_out = torch.zeros((full, full), dtype=a.dtype, device=a.device)
    v_out[:ldu, :ldu] = v
    return w_out, v_out


def prefix_lock(done: torch.Tensor, conv: torch.Tensor,
                n_targ: int) -> torch.Tensor:
    """Contiguous-prefix locking: a root is locked iff it and every
    preceding root (within the first ``n_targ``) converged or was locked;
    roots past ``n_targ`` are never locked."""
    cand = (done | conv).to(torch.int32)
    prefix = torch.cumprod(cand, dim=0).to(torch.bool)
    return prefix & (torch.arange(done.shape[0], device=done.device) < n_targ)
