"""diaglib_tpu_torch: the PyTorch + CUDA port of diaglib_tpu for NVIDIA Hopper.

This slice carries the float32 -> float64 Davidson ladder over the
symmetric integer-sliced BSR operator.  Plain tensor code is PyTorch; the
two kernels of the sliced matvec (``ops.slicing.peel_rows`` and
``ops.bsr_sliced_sym.sym_spmm``) are CUDA C++ in ``csrc/``, built by
``nvcc`` at first use.  On CPU tensors they run their plain torch versions.
"""

from .solvers import davidson, davidson_ladder
from .types import SolverOptions, SolverResult

__all__ = ["SolverOptions", "SolverResult", "davidson", "davidson_ladder"]
