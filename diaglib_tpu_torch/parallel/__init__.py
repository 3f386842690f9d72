"""Distributed execution over ``torch.distributed`` (port of
``diaglib_tpu/parallel``).

The scalable dimension is the vector length n: every (k, n) block of a
solve is split along n over the ranks of a process group, the Gram and
Rayleigh-Ritz contractions are all-reduced, and the small reduced
problems stay replicated.  One rank is one device: a CUDA card under NCCL,
or the CPU under gloo when asked.  The reference's meshes become process
groups: :func:`make_mesh` is :func:`make_group` over the given ranks, and
:func:`global_mesh` the world group.
"""

from .multihost import (
    global_mesh,
    global_sharding,
    initialize,
    make_global,
    make_replicated,
)
from .sharding import VectorSharding, make_group, make_mesh

__all__ = [
    "VectorSharding",
    "make_group",
    "make_mesh",
    "initialize",
    "global_mesh",
    "global_sharding",
    "make_global",
    "make_replicated",
]
