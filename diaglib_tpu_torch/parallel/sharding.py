"""Sharding policy for row-vector blocks over a ``torch.distributed`` group
(port of ``diaglib_tpu/parallel/sharding.py``).

Every O(n) array is split along its last axis into equal contiguous column
ranges, one per rank, in rank order; the small reduced matrices are
replicated.  The JAX package lets XLA insert the collectives of a sharded
``jit``; the eager port calls them explicitly: the solvers enter
:func:`~diaglib_tpu_torch.utils.mm.mm_sharding`, under which every
contraction over n (``mmT``) and every n-axis sum or maximum is
all-reduced, so each rank holds bit-identical reduced matrices and takes
the same branches.

The reference's ``make_mesh`` (a 1-D device mesh) becomes
:func:`make_group`, a process group over the given ranks (the world by
default); one rank is one device.  :func:`make_mesh` keeps the reference's
name and signature for it.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

__all__ = ["VectorSharding", "make_group", "make_mesh"]


def make_group(ranks=None):
    """The process group over ``ranks`` (all ranks, the default group,
    when None).  Every rank of the world must call it, as
    ``torch.distributed.new_group`` requires."""
    if ranks is None:
        return dist.group.WORLD
    return dist.new_group(ranks=sorted(int(r) for r in ranks))


def _check_axis(axis_name: str) -> None:
    if axis_name != "n":
        raise ValueError(f"axis_name={axis_name!r}: the port's groups have "
                         "one axis, 'n'")


def make_mesh(devices=None, axis_name: str = "n"):
    """The reference's 1-D device mesh as a process group: ``devices`` are
    ranks (all ranks when None), and this is :func:`make_group`.  The one
    axis is ``"n"``; any other name raises ``ValueError``."""
    _check_axis(axis_name)
    return make_group(devices)


class _Pending:
    """A ring permute in flight: ``wait()`` returns the received shard."""

    def __init__(self, buf, works, sent=None):
        # the sent shard stays referenced until the permute completes
        self.buf, self.works, self.sent = buf, works, sent

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        return self.buf


class VectorSharding:
    """The n axis of length ``n`` split over the ranks of ``group``.

    Rank r holds columns ``[r * n_local, (r + 1) * n_local)``.  Pass it as
    ``sharding=`` to the solvers and to the distributed operators; the
    solver's blocks are then the rank's ``(k, n_local)`` shards, and the
    user's ``matvec`` / ``precnd`` callbacks get and return shards.
    """

    def __init__(self, n: int, group=None):
        if not dist.is_initialized():
            raise RuntimeError("VectorSharding needs an initialized "
                               "torch.distributed process group "
                               "(see parallel.multihost.initialize)")
        self.group = dist.group.WORLD if group is None else group
        self.n = int(n)
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        if self.n % self.size:
            raise ValueError(f"n={self.n} does not split over {self.size} "
                             "ranks")
        self.n_local = self.n // self.size
        self.lo = self.rank * self.n_local
        self._kept = None

    def __repr__(self):
        return (f"VectorSharding(n={self.n}, rank={self.rank}, "
                f"size={self.size})")

    @property
    def backend(self) -> str:
        """The group's backend: "nccl" (whose collectives a CUDA graph
        can capture) or "gloo"."""
        return str(dist.get_backend(self.group))

    @contextlib.contextmanager
    def keep_alive(self, kept: list):
        """Under it, every ring permute appends the shards it sends and
        receives to ``kept``: a captured step's permutes keep them for as
        long as its graph lives (``utils.graphs.StepGraphs``)."""
        prev, self._kept = self._kept, kept
        try:
            yield kept
        finally:
            self._kept = prev

    def _global(self, r: int) -> int:
        if self.group is dist.group.WORLD:
            return r
        return dist.get_global_rank(self.group, r)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor, same on all)."""
        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the ranks."""
        out = t.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The full ``(..., n)`` array from every rank's ``(..., n_local)``
        shard, in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=-1)

    def local_cols(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a replicated ``(..., n)`` array."""
        if full.shape[-1] != self.n:
            raise ValueError(f"local_cols: last axis {full.shape[-1]} != "
                             f"n={self.n}")
        return full[..., self.lo:self.lo + self.n_local]

    def permute(self, x: torch.Tensor, s: int, wait: bool = True):
        """Ring permute by offset ``s``: this rank (d) sends its shard ``x``
        to rank (d - s) mod D and receives the shard of rank (d + s) mod D
        (the reference's ``lax.ppermute`` with pairs (j, (j - s) mod D)).
        With ``wait=False`` it returns a pending permute whose ``wait()``
        gives the received shard, so that local work can overlap it.

        gloo matches a send to its receive by the tag ``s``; NCCL ignores
        tags and matches the sends from one rank to another in the order
        the two ranks post them.  So every rank of the group posts its
        permutes in the same order: the distributed operators post one
        for each offset of their global ``steps``, ascending, on every
        rank, and wait for them in that order.  Under NCCL the exchange
        runs on the communicator's own stream; ``wait()`` makes the
        current stream wait for it before the received shard is read.
        Inside a captured solver step (``utils.graphs``) the exchange is
        part of the graph and is waited within the same step."""
        s %= self.size
        if s == 0:
            return x if wait else _Pending(x, [])
        x = x.contiguous()
        buf = torch.empty_like(x)
        dst = self._global((self.rank - s) % self.size)
        src = self._global((self.rank + s) % self.size)
        if self._kept is not None:
            self._kept += [x, buf]
        ops = [dist.P2POp(dist.isend, x, dst, group=self.group, tag=s),
               dist.P2POp(dist.irecv, buf, src, group=self.group, tag=s)]
        pending = _Pending(buf, dist.batch_isend_irecv(ops), x)
        return pending.wait() if wait else pending
