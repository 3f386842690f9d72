"""Distributed execution over ``torch.distributed`` (port of
``diaglib_tpu/parallel``).

The scalable dimension is the vector length n: every (k, n) block of a
solve is split along n over the ranks of a process group, the Gram and
Rayleigh-Ritz contractions are all-reduced, and the small reduced
problems stay replicated.  One rank is one device: a CUDA card under NCCL,
or the CPU under gloo when asked.  The reference's ``make_mesh`` /
``global_mesh`` become :func:`make_group` (the world group is the mesh).
"""

from .multihost import (
    global_sharding,
    initialize,
    make_global,
    make_replicated,
)
from .sharding import VectorSharding, make_group

__all__ = [
    "VectorSharding",
    "make_group",
    "initialize",
    "global_sharding",
    "make_global",
    "make_replicated",
]
