"""Distributed BSR SpMM: row-partitioned blocks and a ring halo exchange
(port of ``diaglib_tpu/ops/dist_bsr.py``).

The block rows of a :class:`~diaglib_tpu_torch.ops.bsr.BSRMatrix` are split
contiguously over the D ranks of a
:class:`~diaglib_tpu_torch.parallel.VectorSharding` (the same column ranges
the solvers give each rank).  Entry A(r, c) lives on the rank owning block
row r and is grouped by its ring offset ``s = (shard(c) - shard(r)) mod D``:
``s = 0`` consumes the rank's own x shard, and each nonempty ``s != 0``
fetches the shard s ranks up the ring with one permute
(``VectorSharding.permute``); empty offsets are skipped, so a banded
operator exchanges with its ring neighbours only.  The permutes are
started before the local product and waited for after it.

Each group's entry list is padded to the largest count over the ranks
(the reference's static shapes; padding points at an all-zero block added
into local row 0).  The local product is the plain segment product, as the
reference's ``_segment_spmm`` (no kernel on this path).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bsr import BSRMatrix, entry_products, row_slots, segment_sum

__all__ = ["DistBSRMatrix", "distribute_bsr", "dist_bsr_matvec"]

_CHUNK = 64           # entries gathered at a time


def _ring_offset_groups(rows, cols, nbr_loc: int, D: int, pad_row: int):
    """Group entries by ring offset ``s = (shard(col) - shard(row)) mod D``.

    Host-side (numpy) pattern reorganization shared by the plain and the
    integer-sliced distributed operators.  Returns ``(steps, groups)`` where
    ``groups[i] = (idx, lr, lc)`` are (D, P_i) int32 arrays per nonempty
    offset ``steps[i]``: global entry index, LOCAL block row on the owning
    shard, LOCAL block col on the source x shard.  Rows per device stay
    sorted (``rows`` is sorted globally).  Padding slots get
    ``idx = len(rows)`` (one past the end), ``lr = pad_row``, ``lc = 0``.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    dest = rows // nbr_loc
    src = cols // nbr_loc
    s_of = (src - dest) % D
    steps = tuple(sorted(set(int(s) for s in s_of)))
    groups = []
    for s in steps:
        counts = [int(np.sum((dest == d) & (s_of == s))) for d in range(D)]
        p = max(counts)
        idx = np.full((D, p), len(rows), np.int32)
        lr = np.full((D, p), pad_row, np.int32)
        lc = np.zeros((D, p), np.int32)
        for d in range(D):
            sel = np.nonzero((dest == d) & (s_of == s))[0]
            idx[d, : len(sel)] = sel
            lr[d, : len(sel)] = rows[sel] - d * nbr_loc
            lc[d, : len(sel)] = cols[sel] % nbr_loc
        groups.append((idx, lr, lc))
    return steps, groups


def _shards(n: int, block: int, n_shards: int) -> int:
    """Block rows a shard (``nbr_loc``); raises when they do not divide."""
    nbr = n // block
    D = int(n_shards)
    if D <= 0 or nbr % D:
        raise ValueError(f"block rows ({nbr}) must divide over {D} shards")
    return nbr // D


def _rank_of(rank, D: int):
    if rank is not None and not 0 <= int(rank) < D:
        raise ValueError(f"rank {rank} outside 0..{D - 1}")
    return None if rank is None else int(rank)


def _gather(src: torch.Tensor, idx: np.ndarray, chunk: int) -> torch.Tensor:
    """``src[idx]`` along the first axis, with zeros where idx is one past
    the end (padding), built on src's device a chunk of entries at a time
    (no full-size index temporaries)."""
    m = src.shape[0]
    flat = idx.reshape(-1)
    if flat.size == m and np.array_equal(flat, np.arange(m)):
        return src.reshape(idx.shape + tuple(src.shape[1:]))   # a view
    out = torch.empty((flat.size,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    for s in range(0, flat.size, chunk):
        part = flat[s:s + chunk]
        real = part < m
        dst = out[s:s + len(part)]
        if real.all():
            dst.copy_(src[torch.as_tensor(part, device=src.device).long()])
        else:
            dst.zero_()
            keep = np.nonzero(real)[0]
            if keep.size:
                dst[torch.as_tensor(keep, device=src.device)] = src[
                    torch.as_tensor(part[keep], device=src.device).long()]
    return out.reshape(idx.shape + tuple(src.shape[1:]))


@dataclasses.dataclass(frozen=True)
class DistBSRMatrix:
    """BSR matrix partitioned by block row over D ranks.

    Per nonempty ring offset ``steps[i]``: ``blocks_t[i]`` (D, P_i, B, B)
    pre-transposed blocks (zero-padded), ``loc_rows[i]`` / ``loc_cols[i]``
    (D, P_i) int32 local block row on the owning shard / local block col on
    the source x shard.  ``rank`` None holds every shard stacked as the
    reference does; ``rank = r`` holds only rank r's groups, without the
    leading D axis.
    """

    blocks_t: tuple
    loc_rows: tuple
    loc_cols: tuple
    steps: tuple
    n: int
    block: int
    ndev: int
    rank: int | None = None

    @property
    def n_local(self) -> int:
        return self.n // self.ndev

    def shard(self, r: int) -> "DistBSRMatrix":
        """Rank r's groups (views of the stacked arrays)."""
        if self.rank is not None:
            if self.rank != r:
                raise ValueError(f"this is rank {self.rank}'s shard, not {r}")
            return self
        r = _rank_of(r, self.ndev)
        return dataclasses.replace(
            self, blocks_t=tuple(a[r] for a in self.blocks_t),
            loc_rows=tuple(a[r] for a in self.loc_rows),
            loc_cols=tuple(a[r] for a in self.loc_cols), rank=r)


def distribute_bsr(m: BSRMatrix, n_shards: int, *,
                   rank: int | None = None) -> DistBSRMatrix:
    """Partition a BSRMatrix's block rows over ``n_shards`` ranks.

    The pattern is reorganized on the host (index arrays only); the blocks
    are gathered on their device.  The block-row count must divide evenly.
    ``rank=None`` returns every shard stacked; ``rank=r`` only rank r's.
    """
    B = m.block
    D = int(n_shards)
    nbr_loc = _shards(m.n, B, D)
    rank = _rank_of(rank, D)
    steps, groups = _ring_offset_groups(m.rows.cpu().numpy(),
                                        m.cols.cpu().numpy(), nbr_loc, D,
                                        pad_row=0)
    dev = m.blocks_t.device
    sel = slice(None) if rank is None else rank
    blocks_l, lrows_l, lcols_l = [], [], []
    for idx, lr, lc in groups:
        blocks_l.append(_gather(m.blocks_t, idx[sel], _CHUNK))
        lrows_l.append(torch.as_tensor(lr[sel], device=dev))
        lcols_l.append(torch.as_tensor(lc[sel], device=dev))
    return DistBSRMatrix(blocks_t=tuple(blocks_l), loc_rows=tuple(lrows_l),
                         loc_cols=tuple(lcols_l), steps=steps, n=m.n,
                         block=B, ndev=D, rank=rank)


def _check_group(dm, sharding):
    if sharding.size != dm.ndev:
        raise ValueError(f"matrix distributed over {dm.ndev} shards but the "
                         f"sharding has {sharding.size} ranks")
    if sharding.n != dm.n:
        raise ValueError(f"matrix has n={dm.n}, the sharding n={sharding.n}")
    return dm.shard(sharding.rank)


def _segment_spmm(xb, lc, blocks, init, slots):
    """``init[r] += sum of xb[lc[e]] @ blocks[e]`` over the entries e of
    row r, each row's sum in entry order (``slots``, :func:`~.bsr.row_slots`
    of the entries' rows: the same bits on every call); xb (nbr_loc, k,
    B), init (nbr_loc, k, B), updated in place."""
    init += segment_sum(entry_products(lc, blocks, xb), slots)
    return init


def dist_bsr_matvec(dm: DistBSRMatrix, sharding):
    """Sharded matvec closure ``x: (k, n_local) -> (k, n_local)``.

    ``sharding`` is a VectorSharding over exactly ``dm.ndev`` ranks; ``dm``
    is the stacked matrix or this rank's shard.  The closure drops into any
    solver as its ``matvec`` next to the same ``sharding``; it reads
    nothing back from the device (the row slots are made here, once), so
    a captured solver step holds it whole, its ring permutes included.
    """
    sh = _check_group(dm, sharding)
    B = dm.block
    nbr_loc = dm.n_local // B
    slots = [row_slots(lr, nbr_loc) for lr in sh.loc_rows]

    def mv(x):
        k = x.shape[0]
        pending = [sharding.permute(x, s, wait=False) for s in sh.steps]
        y = torch.zeros((nbr_loc, k, B), dtype=x.dtype, device=x.device)
        for i, p in enumerate(pending):
            x_s = p.wait()
            xb = x_s.reshape(k, nbr_loc, B).transpose(0, 1)
            _segment_spmm(xb, sh.loc_cols[i], sh.blocks_t[i], y, slots[i])
        return y.transpose(0, 1).reshape(k, nbr_loc * B)

    return mv
