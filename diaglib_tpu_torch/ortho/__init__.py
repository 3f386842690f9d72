"""Orthogonalization."""

from .core import (
    b_ortho,
    b_ortho_svd,
    b_ortho_vs_x,
    biortho_vs_x,
    norm_est,
    ortho_cd,
    ortho_qr,
    ortho_vs_x,
    svd_biortho,
)

__all__ = ["norm_est", "ortho_cd", "ortho_qr", "ortho_vs_x", "b_ortho",
           "b_ortho_svd", "b_ortho_vs_x", "svd_biortho", "biortho_vs_x"]
