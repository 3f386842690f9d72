"""Eigensolver drivers."""

from .caslr import caslr, caslr_eff
from .davidson import davidson, gen_david
from .lobpcg import lobpcg
from .mixed import (
    LROps,
    caslr_eff_ladder,
    caslr_ladder,
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

__all__ = ["LROps", "davidson", "gen_david", "lobpcg", "caslr", "caslr_eff",
           "nonsym", "nonsym_pass", "NonsymPassResult", "nonsym_seed_left",
           "nonsym_finalize", "davidson_ladder", "gen_david_ladder",
           "lobpcg_ladder", "caslr_ladder", "caslr_eff_ladder",
           "nonsym_ladder"]
