"""The plain reference of a symmetric eigenproblem ``A x = lambda x``
(inputs ``{"a": arrays}``): its lowest eigenpairs, and the comparison that
judges a solver's pairs against them."""

from __future__ import annotations

import torch

from benchmark.reference import plain

# the reference's stopping rule, and the control's (float32 stops short of
# it: its residuals stall near float32's rounding)
REL_TOL = {torch.float64: 1e-9, torch.float32: 2e-5}
MAX_ITER = {torch.float64: 300, torch.float32: 300}


def lowest(inputs: dict, k: int, dtype, seed: int):
    """``(eig, vecs)``: the k lowest pairs, computed in ``dtype`` from the
    benchmark's blocks; vecs' rows have unit norm."""
    a = inputs["a"]
    dev = a["blocks_t"].device
    theta, x, _ = plain.lowest_pairs(
        lambda v: plain.bsr_product(a, v), None, plain.bsr_diagonal(a),
        None, a["n"], k, dtype=dtype, device=dev, seed=seed,
        rel_tol=REL_TOL[dtype], max_iter=MAX_ITER[dtype])
    return theta, x


def judge(inputs: dict, eig: torch.Tensor, vecs: torch.Tensor,
          ref_eig: torch.Tensor) -> dict:
    """The numbers compared, for k returned pairs (rows of vecs), in
    float64: ``resid_rms``, the largest ||A v - lambda v|| / sqrt(n) (the
    solver's own rms); ``eig_rel``, the largest |lambda - the reference's|
    over |the reference's|; ``ortho``, the largest |V V^T - I|."""
    a = inputs["a"]
    v = vecs.to(torch.float64)
    lam = eig.to(torch.float64)
    r = plain.bsr_product(a, v) - lam[:, None] * v
    eye = torch.eye(v.shape[0], dtype=torch.float64, device=v.device)
    each = r.norm(dim=1) / a["n"] ** 0.5
    return {
        "resid_rms": float(each.max()),
        "resid_rms_each": each,
        "eig_rel": float(((lam - ref_eig) / ref_eig).abs().max()),
        "ortho": float((v @ v.T - eye).abs().max()),
    }
