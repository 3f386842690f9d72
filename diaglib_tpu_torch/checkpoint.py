"""Checkpoint and resume for long solves (port of
``diaglib_tpu/checkpoint.py``).

Every solver result's ``evec`` (or the Casida pair rows) is a valid
warm-start guess, so checkpoint/resume is::

    save(path, res)                      # after any solve or ladder stage
    res = load(path, like=res_struct)    # later, in another process
    res2 = davidson(mv, pc, res.evec, opts)   # resumes where it left off

A tree is a tensor, a plain scalar, or a dict, tuple or list of trees, or
one of the package's frozen result dataclasses.  It is written with
``torch.save`` as a flat dict from key paths to CPU tensors and plain
scalars (no pickled classes) and read back with ``weights_only=True``;
:func:`load` rebuilds ``like``'s structure and types.  Under an initialized
``torch.distributed`` group each rank writes and reads its own file
(``rank{r}.pt``), so a sharded result keeps each rank's shards, as the
reference's orbax checkpoints keep each host's addressable shards.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re

import torch
import torch.distributed as dist

from ._tree import children

__all__ = ["save", "load"]

_SCALARS = (bool, int, float, str, type(None))


def _rank_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _flatten(tree, prefix="", out=None):
    out = {} if out is None else out
    kids = children(tree)
    if kids is None:
        if isinstance(tree, torch.Tensor):
            out[prefix] = tree.detach().cpu()
        elif isinstance(tree, _SCALARS):
            out[prefix] = tree
        else:
            raise TypeError(f"checkpoint: unsupported leaf {type(tree)} at "
                            f"{prefix or '<root>'}")
        return out
    for k, v in kids:
        _flatten(v, f"{prefix}/{k}" if prefix else k, out)
    return out


def _rebuild(like, flat, prefix=""):
    kids = children(like)
    if kids is None:
        if prefix not in flat:
            raise ValueError(f"checkpoint: no entry {prefix or '<root>'}")
        got = flat[prefix]
        if isinstance(like, torch.Tensor):
            if not isinstance(got, torch.Tensor):
                raise ValueError(f"checkpoint: {prefix} is not a tensor")
            if got.shape != like.shape or got.dtype != like.dtype:
                raise ValueError(
                    f"checkpoint: {prefix} is {tuple(got.shape)} "
                    f"{got.dtype}, like is {tuple(like.shape)} {like.dtype}")
            return got.to(like.device)
        return got
    vals = [_rebuild(v, flat, f"{prefix}/{k}" if prefix else k)
            for k, v in kids]
    if isinstance(like, dict):
        return dict(zip(like.keys(), vals))
    if isinstance(like, (tuple, list)):
        return type(like)(vals)
    return type(like)(**{f.name: v for f, v in
                         zip(dataclasses.fields(like), vals)})


def save(path: str, tree) -> None:
    """Durably write ``tree`` (e.g. a SolverResult, or a guess block) into
    the directory ``path``, created with its parents and overwritten if
    present.  Under torch.distributed every rank of the world calls it and
    writes its own file; it returns when all have."""
    path = os.path.abspath(path)
    rank, world = _rank_world()
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    target = os.path.join(path, f"rank{rank}.pt")
    tmp = target + ".tmp"
    torch.save(flat, tmp)
    os.replace(tmp, target)
    if rank == 0:
        # files of ranks past this world are stale shards of an older save
        for f in glob.glob(os.path.join(path, "rank*.pt")):
            m = re.fullmatch(r"rank(\d+)\.pt", os.path.basename(f))
            if m and int(m.group(1)) >= world:
                os.remove(f)
    if world > 1:
        dist.barrier()


def load(path: str, like):
    """Read the tree written by :func:`save` into ``like``'s structure and
    types (``like`` is e.g. the result of an identically configured solve).
    Each tensor goes to ``like``'s device; a shape or dtype that differs
    from ``like``'s raises ``ValueError``."""
    rank, _ = _rank_world()
    flat = torch.load(os.path.join(os.path.abspath(path), f"rank{rank}.pt"),
                      map_location="cpu", weights_only=True)
    return _rebuild(like, flat)
