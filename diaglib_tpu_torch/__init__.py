"""diaglib_tpu_torch: the PyTorch + CUDA port of diaglib_tpu for NVIDIA Hopper.

This package carries the float32 -> float64 solve ladders of the symmetric
drivers: Davidson (standard and generalized) and LOBPCG (standard and
generalized), over the symmetric integer-sliced BSR operator or the plain
BSR operator.  Plain tensor code is PyTorch; the kernels are CUDA C++ in
``csrc/``, built by ``nvcc`` at first use: the slice peel
(``ops.slicing.peel_rows``), the symmetric sliced SpMM
(``ops.bsr_sliced_sym.sym_spmm``), the exact wide-rotation product
(``ops.slicing.sliced_wide_mm``) and the plain BSR SpMM
(``ops.bsr.bsr_spmm``).  On CPU tensors they run their plain torch
versions.
"""

from .ops.bsr import bsr_from_dense, bsr_matvec
from .solvers import (
    davidson,
    davidson_ladder,
    gen_david,
    gen_david_ladder,
    lobpcg,
    lobpcg_ladder,
)
from .types import SolverOptions, SolverResult

__all__ = ["SolverOptions", "SolverResult", "davidson", "gen_david",
           "lobpcg", "davidson_ladder", "gen_david_ladder", "lobpcg_ladder",
           "bsr_matvec", "bsr_from_dense"]
