"""Orthogonalization."""

from .core import norm_est, ortho_cd, ortho_qr, ortho_vs_x

__all__ = ["norm_est", "ortho_cd", "ortho_qr", "ortho_vs_x"]
