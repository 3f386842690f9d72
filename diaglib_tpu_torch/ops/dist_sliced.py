"""Distributed integer-sliced BSR SpMM (port of
``diaglib_tpu/ops/dist_sliced.py``).

The halo-exchange partition of ``ops/dist_bsr.py`` over the general int8
slice store of ``ops/bsr_sliced.py``: the block rows are split over the D
ranks, each entry grouped by its ring offset s, and each rank's group s
contracts the x shard of rank (rank + s) mod D, fetched with one ring
permute (float64 payload on the float64 tier) and sliced on the consuming
rank.  Per-(row, shard) slicing grids are independently exact, so each
group's levels combine in float64 with that group's own x scales, and no
grid is aligned across ranks.

:func:`group_spmm` is the wrapper of the CUDA kernel ``csrc/group_spmm.cu``
(kernel K6, one group's int32 level sums); on CPU tensors it runs
:func:`group_spmm_plain`.  Rows a group does not cover come out as zeros,
so the matvec needs no mask.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from .bsr_sliced import (
    _BITS,
    SlicedBSR,
    _combine_levels,
    _launch_level_sums,
    _slice_x,
    _tier_params,
    sliced_spmm_plain,
)
from .dist_bsr import (
    _check_group,
    _gather,
    _rank_of,
    _ring_offset_groups,
    _shards,
)
from .slicing import combine_weights

__all__ = ["DistSlicedBSR", "distribute_sliced_bsr", "dist_sliced_matvec",
           "dist_sliced_from_arrays", "group_spmm", "group_spmm_plain",
           "group_row_start"]

_GATHER_CHUNK = 64    # entries gathered at a time (128 MiB at B = 512)


@dataclasses.dataclass(frozen=True)
class DistSlicedBSR:
    """Sliced BSR operator partitioned by block row over D ranks.

    Per nonempty ring offset ``steps[i]``:

    slices[i]:   (D, P_i, B, na*B) int8 slice planes (zero-padded entries);
    loc_rows[i]: (D, P_i) int32 block row LOCAL to the owning shard;
                 padding entries point at the extra row ``nbr_loc``;
    loc_cols[i]: (D, P_i) int32 block col LOCAL to the source x shard;
                 rows sorted per device, padding last.
    col_scale:   (n,) float64 power-of-two output-column scales.
    diagonal:    (n,) float64 main diagonal (for preconditioners).

    ``rank`` None holds every shard stacked, as the reference does;
    ``rank = r`` holds rank r's groups without the leading D axis and the
    rank's ``(n_local,)`` slices of ``col_scale`` and ``diagonal``.
    """

    slices: tuple
    loc_rows: tuple
    loc_cols: tuple
    col_scale: torch.Tensor
    diagonal: torch.Tensor
    steps: tuple
    n: int
    block: int
    na: int
    ndev: int
    rank: int | None = None

    @property
    def n_local(self) -> int:
        return self.n // self.ndev

    @property
    def nbr_loc(self) -> int:
        return self.n_local // self.block

    def shard(self, r: int) -> "DistSlicedBSR":
        """Rank r's groups and columns (views of the stacked arrays)."""
        if self.rank is not None:
            if self.rank != r:
                raise ValueError(f"this is rank {self.rank}'s shard, not {r}")
            return self
        r = _rank_of(r, self.ndev)
        cols = slice(r * self.n_local, (r + 1) * self.n_local)
        return dataclasses.replace(
            self, slices=tuple(a[r] for a in self.slices),
            loc_rows=tuple(a[r] for a in self.loc_rows),
            loc_cols=tuple(a[r] for a in self.loc_cols),
            col_scale=self.col_scale[cols], diagonal=self.diagonal[cols],
            rank=r)


def distribute_sliced_bsr(ms: SlicedBSR, n_shards: int, *,
                          rank: int | None = None) -> DistSlicedBSR:
    """Partition a SlicedBSR's block rows over ``n_shards`` ranks.

    The same ring-offset grouping as :func:`~.dist_bsr.distribute_bsr`
    (shared helper), padding included.  The int8 planes are gathered on the
    store's device a chunk of entries at a time, so the transient is one
    copy of the (rank's) groups; a group that is the store in its own order
    (one shard) is a view of it.  ``rank=None`` returns every shard stacked;
    ``rank=r`` only rank r's groups.
    """
    B = ms.block
    D = int(n_shards)
    nbr_loc = _shards(ms.n, B, D)
    rank = _rank_of(rank, D)
    # padding entries point at the extra output row nbr_loc
    steps, groups = _ring_offset_groups(ms.rows.cpu().numpy(),
                                        ms.cols.cpu().numpy(), nbr_loc, D,
                                        pad_row=nbr_loc)
    dev = ms.slices.device
    sel = slice(None) if rank is None else rank
    slices_l, lrows_l, lcols_l = [], [], []
    for idx, lr, lc in groups:
        slices_l.append(_gather(ms.slices, idx[sel], _GATHER_CHUNK))
        lrows_l.append(torch.as_tensor(lr[sel], device=dev))
        lcols_l.append(torch.as_tensor(lc[sel], device=dev))
    n_loc = ms.n // D
    cols = (slice(None) if rank is None
            else slice(rank * n_loc, (rank + 1) * n_loc))
    return DistSlicedBSR(
        slices=tuple(slices_l), loc_rows=tuple(lrows_l),
        loc_cols=tuple(lcols_l),
        col_scale=ms.col_scale[cols], diagonal=ms.diagonal[cols],
        steps=steps, n=ms.n, block=B, na=ms.na, ndev=D, rank=rank)


def dist_sliced_from_arrays(d, rank: int, device=None) -> DistSlicedBSR:
    """Rank ``rank``'s shard from the JAX ``DistSlicedBSR``'s fields: the
    dataclass itself, or a dict of numpy arrays and numbers whose
    ``slices``/``loc_rows``/``loc_cols`` are sequences of (D, P_i, ...)
    arrays, one per step (the reference kernel's ``first`` flags are not
    read: the port's kernel finds the rows' starts in the sorted rows).

    Rejects arrays the kernel would misread: shapes that do not fit the
    static fields, local rows outside 0..nbr_loc or not sorted within a
    group, local columns outside the x shard, or padding entries whose
    planes are not zero.  Built on the current CUDA device unless
    ``device`` names another (RuntimeError without a card: pass
    ``device="cpu"``)."""
    device = resolve_device(device)
    if not isinstance(d, dict):
        d = {f.name: getattr(d, f.name) for f in dataclasses.fields(d)}
    steps = tuple(int(s) for s in np.asarray(d["steps"]).reshape(-1))
    n, B, na, D = (int(d[k]) for k in ("n", "block", "na", "ndev"))
    ok = B > 0 and D > 0 and n % (B * D) == 0 and na > 0
    if not ok or not 0 <= int(rank) < D:
        raise ValueError("dist_sliced_from_arrays: malformed store arrays")
    n_loc = n // D
    nbr_loc = n_loc // B
    fields = ("slices", "loc_rows", "loc_cols")
    ok = (len(steps) == len(set(steps)) and all(0 <= s < D for s in steps)
          and all(len(d[k]) == len(steps) for k in fields)
          and np.asarray(d["col_scale"]).shape == (n,)
          and np.asarray(d["diagonal"]).shape == (n,))
    groups = [tuple(np.asarray(d[k][i]) for k in fields)
              for i in range(len(steps))] if ok else []
    for sl, lr, lc in groups:
        p = lr.shape[-1] if lr.ndim == 2 else -1
        ok = ok and (sl.shape == (D, p, B, na * B) and lr.shape == (D, p)
                     and lc.shape == (D, p) and sl.dtype == np.int8)
        if not ok:
            break
        r_lr, r_lc = lr[rank], lc[rank]
        ok = (bool(((r_lr >= 0) & (r_lr <= nbr_loc)).all())
              and bool(((r_lc >= 0) & (r_lc < nbr_loc)).all())
              and bool((np.diff(r_lr) >= 0).all())
              and not sl[rank][r_lr == nbr_loc].any())
    if not ok:
        raise ValueError("dist_sliced_from_arrays: malformed store arrays")
    cols = slice(rank * n_loc, (rank + 1) * n_loc)

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return DistSlicedBSR(
        slices=tuple(t(g[0][rank], torch.int8) for g in groups),
        loc_rows=tuple(t(g[1][rank], torch.int32) for g in groups),
        loc_cols=tuple(t(g[2][rank], torch.int32) for g in groups),
        col_scale=t(np.asarray(d["col_scale"])[cols], torch.float64),
        diagonal=t(np.asarray(d["diagonal"])[cols], torch.float64),
        steps=steps, n=n, block=B, na=na, ndev=D, rank=int(rank))


def group_row_start(loc_rows: torch.Tensor, nbr_loc: int) -> torch.Tensor:
    """(nbr_loc + 1,) int32: the first entry of each local block row of a
    group (rows sorted, the padding row nbr_loc last)."""
    return torch.searchsorted(
        loc_rows.contiguous(),
        torch.arange(nbr_loc + 1, dtype=loc_rows.dtype,
                     device=loc_rows.device)).to(torch.int32)


def group_spmm_plain(xs, slices, loc_rows, loc_cols, *, nx: int, na: int,
                     nlev: int, nbr_loc: int) -> torch.Tensor:
    """The plain torch version of kernel K6: one group's int32 level sums
    ``(nlev*k, nbr_loc*B)`` on this rank.

    ``xs`` (nx*k, n_local) int8 planes of the x shard; ``slices``
    (P, B, width*B) int8, of which the leading ``na`` planes are used;
    ``loc_rows``/``loc_cols`` (P,) local block coordinates, padding entries
    at row ``nbr_loc``.  K5's plain version with one more output block row,
    the padding row, which is dropped; rows no entry covers are zero.
    """
    B = slices.shape[1]
    acc = sliced_spmm_plain(xs, slices, loc_rows, loc_cols, None, nx=nx,
                            na=na, nlev=nlev, n_out=(nbr_loc + 1) * B)
    return acc[:, :nbr_loc * B]


def group_spmm(xs, slices, loc_rows, loc_cols, *, nx: int, na: int,
               nlev: int, nbr_loc: int,
               row_start: torch.Tensor | None = None) -> torch.Tensor:
    """One group's level sums on this rank (kernel K6).

    Arguments as :func:`group_spmm_plain`; ``row_start`` is
    :func:`group_row_start` of ``loc_rows`` (computed when not given).  On
    CPU tensors this is the plain version; on CUDA tensors it launches
    ``csrc/group_spmm.cu`` (one CTA per local block row, padding row
    included, and tile; each output written once, uncovered rows as zeros,
    bitwise equal to the plain version) or raises.  Returns the
    ``(nlev*k, nbr_loc*B)`` levels without the padding row.
    """
    if xs.device.type == "cpu":
        return group_spmm_plain(xs, slices, loc_rows, loc_cols, nx=nx, na=na,
                                nlev=nlev, nbr_loc=nbr_loc)
    if xs.device.type != "cuda":
        raise ValueError(f"group_spmm: unsupported device {xs.device}")
    B = slices.shape[1]
    if xs.shape[-1] != nbr_loc * B or loc_rows.shape != loc_cols.shape:
        raise ValueError(f"group_spmm: x shard {tuple(xs.shape)} or local "
                         f"rows {tuple(loc_rows.shape)} do not fit "
                         f"nbr_loc={nbr_loc} B={B}")
    if row_start is None:
        row_start = group_row_start(loc_rows, nbr_loc)
    acc = _launch_level_sums(group_spmm, xs, slices, loc_cols, row_start,
                             nx=nx, na=na, nlev=nlev,
                             n_out=(nbr_loc + 1) * B)
    return acc[:, :nbr_loc * B]


group_spmm.launches = 0


def dist_sliced_matvec(dm: DistSlicedBSR, sharding, *, dtype=torch.float64,
                       nx: int | None = None, nlev: int | None = None):
    """Sharded matvec closure ``x: (k, n_local) -> (k, n_local)`` at the
    requested tier.

    ``sharding`` is a VectorSharding over exactly ``dm.ndev`` ranks; ``dm``
    is the stacked operator or this rank's shard.  The float64 tier gives
    the full sliced accuracy (~1e-15 relative), the float32 tier the fast
    path.  Per nonempty offset: the x shard s ranks up the ring is fetched
    (every permute is started before the local group runs), sliced on this
    rank (kernel K2 on the card), contracted by :func:`group_spmm` (K6),
    and its levels combined in float64 (float32 on the fast tier) with its
    own x scales; the sum is scaled by the local ``col_scale``.  It reads
    nothing back from the device (the row starts are made here, once), so
    a captured solver step holds it whole, its ring permutes included.
    """
    sh = _check_group(dm, sharding)
    B = sh.block
    nbr_loc = sh.nbr_loc
    nx, na_used, nlev = _tier_params(sh.na, dtype, nx, nlev)
    acc_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    w = combine_weights(nlev, _BITS, acc_dtype, device=sh.col_scale.device)
    cs = sh.col_scale[None, :].to(acc_dtype)
    row_starts = [group_row_start(lr, nbr_loc) for lr in sh.loc_rows]
    # the float32 tier slices x in float32, the float64 tier as it comes
    x_acc = None if dtype == torch.float64 else torch.float32

    def mv(x):
        k, n_loc = x.shape
        pending = [sharding.permute(x, s, wait=False) for s in sh.steps]
        y = torch.zeros((k, n_loc), dtype=acc_dtype, device=x.device)
        for i, pend in enumerate(pending):
            x_s = pend.wait()
            xs, sx = _slice_x(x_s, nx, acc_dtype=x_acc)
            p = group_spmm(xs, sh.slices[i], sh.loc_rows[i], sh.loc_cols[i],
                           nx=nx, na=na_used, nlev=nlev, nbr_loc=nbr_loc,
                           row_start=row_starts[i])
            g = _combine_levels(p, w, nlev, k, n_loc, acc_dtype)
            y = y + g * sx.to(acc_dtype)
        return (y * cs).to(dtype)

    return mv
