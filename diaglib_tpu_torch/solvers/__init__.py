"""Eigensolver drivers."""

from .davidson import davidson, gen_david
from .lobpcg import lobpcg
from .mixed import davidson_ladder, gen_david_ladder, lobpcg_ladder

__all__ = ["davidson", "gen_david", "lobpcg", "davidson_ladder",
           "gen_david_ladder", "lobpcg_ladder"]
