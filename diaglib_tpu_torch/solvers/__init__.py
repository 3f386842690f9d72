"""Eigensolver drivers."""

from .davidson import davidson
from .mixed import davidson_ladder

__all__ = ["davidson", "davidson_ladder"]
