"""Multi-process execution over ``torch.distributed`` (port of
``diaglib_tpu/parallel/multihost.py``).

One process is one rank and owns one device: a CUDA card under NCCL (the
default), or the CPU under gloo when the caller asks for it, as the tests
do.  There is no quiet fallback from NCCL to gloo: ``initialize()`` on a
machine without a card raises.

* :func:`initialize` wraps ``torch.distributed.init_process_group`` with an
  explicit rendezvous (``init_method``: ``tcp://host:port`` or a shared
  ``file://`` store) and pins the rank's device.
* :func:`global_sharding` is the :class:`VectorSharding` over the world,
  and :func:`global_mesh` the world group itself (the world group is the
  mesh).
* :func:`make_global` / :func:`make_replicated` turn an array that every
  process holds in full (deterministically generated) into the rank's
  column shard / a replicated tensor on the rank's device.

Ranks are ordered by process, so a contiguous range of the n axis lives on
each process, as in the reference's process-major mesh.
"""

from __future__ import annotations

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from .sharding import VectorSharding, _check_axis

__all__ = ["initialize", "global_mesh", "global_sharding", "make_global",
           "make_replicated", "rank_device", "free_port"]


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None, *,
               backend: str | None = None, device=None,
               timeout: float = 300.0) -> torch.device:
    """Join (or start) the process group; returns this rank's device.

    ``backend`` defaults to "nccl" on ``cuda:<local rank>`` (the local rank
    is ``LOCAL_RANK`` or ``rank`` modulo the card count) and raises
    ``RuntimeError`` without a card, or when the local rank names a card
    the machine does not have.  NCCL's communicator is created here, on
    that card, for every rank at once (``device_id=``), so the first
    collective or ring permute of a solve needs no lazy setup.
    ``backend="gloo"`` or ``device="cpu"`` runs the ranks on the CPU.
    ``world_size`` and
    ``rank`` default to ``WORLD_SIZE`` / ``RANK`` from the environment,
    else 1 and 0; a one-rank group with no ``init_method`` rendezvouses on
    a free loopback port, and a larger one must name its ``init_method``.
    """
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if device is not None and torch.device(device).type == "cpu":
        backend = backend or "gloo"
    backend = backend or "nccl"
    if backend == "nccl":
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"nccl needs a CUDA device, got {device}")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize: no CUDA device for the nccl backend; pass "
                "backend='gloo' (or device='cpu') to run the ranks on the CPU")
        if device is None:
            local = int(os.environ.get("LOCAL_RANK",
                                       rank % torch.cuda.device_count()))
            device = torch.device("cuda", local)
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if not 0 <= device.index < torch.cuda.device_count():
            raise RuntimeError(
                f"initialize: rank {rank} wants {device}, but this machine "
                f"has {torch.cuda.device_count()} card(s)")
        torch.cuda.set_device(device)
        if torch.cuda.current_device() != device.index:
            raise RuntimeError(f"initialize: set_device({device}) left "
                               f"cuda:{torch.cuda.current_device()} current")
    elif backend == "gloo":
        device = torch.device("cpu" if device is None else device)
    else:
        raise ValueError(f"unsupported backend {backend!r}")
    if init_method is None:
        if world_size != 1:
            raise ValueError("initialize: a group of more than one rank "
                             "needs an explicit init_method")
        init_method = f"tcp://127.0.0.1:{free_port()}"
    kw = dict(device_id=device) if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout), **kw)
    return device


def rank_device() -> torch.device:
    """The device of this rank: the current CUDA device under NCCL, else
    the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_mesh(axis_name: str = "n"):
    """The reference's process-spanning mesh: the world group, whose ranks
    are ordered by process.  The one axis is ``"n"``; any other name
    raises ``ValueError``."""
    _check_axis(axis_name)
    return dist.group.WORLD


def global_sharding(n: int) -> VectorSharding:
    """VectorSharding of length ``n`` over all ranks of the world."""
    return VectorSharding(n)


def _full(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def make_global(x, sharding: VectorSharding, device=None) -> torch.Tensor:
    """This rank's column shard of an array every process holds in full
    (numpy or torch), on ``device`` (the rank's device by default)."""
    part = sharding.local_cols(_full(x))
    return part.to(device or rank_device()).contiguous()


def make_replicated(x, device=None) -> torch.Tensor:
    """The same full array on every rank, on ``device`` (the rank's device
    by default)."""
    return _full(x).to(device or rank_device())
