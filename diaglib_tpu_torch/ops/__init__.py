"""Operators: the BSR container and its SpMM kernel, integer slicing, and
the general and symmetric sliced BSR stores with their CUDA kernels."""

from .bsr import (
    BSRMatrix,
    bsr_diagonal,
    bsr_from_dense,
    bsr_matvec,
    bsr_to_dense,
    random_bsr_spd,
)
from .bsr_sliced import (
    SlicedBSR,
    slice_bsr,
    sliced_bsr_matvec,
    sliced_store_from_arrays,
)
from .bsr_sliced_sym import (
    SymSlicedBSR,
    slice_bsr_sym,
    sliced_matvec_any,
    sym_sliced_matvec,
)

__all__ = ["BSRMatrix", "bsr_diagonal", "bsr_from_dense", "bsr_matvec",
           "bsr_to_dense", "random_bsr_spd", "SlicedBSR", "slice_bsr",
           "sliced_bsr_matvec", "sliced_store_from_arrays", "SymSlicedBSR",
           "slice_bsr_sym", "sliced_matvec_any", "sym_sliced_matvec"]
