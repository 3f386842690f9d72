"""Eigensolver drivers."""

from .davidson import davidson, gen_david
from .lobpcg import lobpcg
from .mixed import (
    davidson_ladder,
    gen_david_ladder,
    lobpcg_ladder,
    nonsym_ladder,
)
from .nonsym import (
    NonsymPassResult,
    nonsym,
    nonsym_finalize,
    nonsym_pass,
    nonsym_seed_left,
)

__all__ = ["davidson", "gen_david", "lobpcg", "nonsym", "nonsym_pass",
           "NonsymPassResult", "nonsym_seed_left", "nonsym_finalize",
           "davidson_ladder", "gen_david_ladder", "lobpcg_ladder",
           "nonsym_ladder"]
