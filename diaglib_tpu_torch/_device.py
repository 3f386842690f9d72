"""The device of the package's problem generators, and host copies.

The generators (``random_bsr_spd``, ``bsr_gen_problem``, ``symm_matrix``,
``metric_matrix``, ``nonsym_matrix``, ``bsr_nonsym_similarity``) make
their tensors on the card unless the caller names another device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "host_array"]


def host_array(x) -> np.ndarray:
    """``x`` (a tensor on any device, or array-like) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device.  Raises ``RuntimeError`` when ``None`` is given and there is no
    CUDA device: the generators never fall back to the CPU unasked (pass
    ``device="cpu"`` for that)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: diaglib_tpu_torch builds on the card by "
            "default; pass device='cpu' to build on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
