"""Operators: the BSR container and its SpMM kernel, integer slicing, the
general and symmetric sliced BSR stores with their CUDA kernels, and the
distributed (row-partitioned, ring halo exchange) BSR and sliced
operators, the exact sliced long contractions, and the ELLPACK scalar
sparse operator."""

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
from .dist_bsr import DistBSRMatrix, dist_bsr_matvec, distribute_bsr
from .dist_sliced import (
    DistSlicedBSR,
    dist_sliced_from_arrays,
    dist_sliced_matvec,
    distribute_sliced_bsr,
)
from .ell import (
    ELLMatrix,
    ell_diagonal,
    ell_from_coo,
    ell_from_dense,
    ell_matvec,
    ell_to_dense,
)
from .slicing import sliced_mm, sliced_mmT, sliced_mTm

__all__ = ["BSRMatrix", "bsr_diagonal", "bsr_from_dense", "bsr_matvec",
           "bsr_to_dense", "random_bsr_spd", "SlicedBSR", "slice_bsr",
           "sliced_bsr_matvec", "sliced_store_from_arrays", "SymSlicedBSR",
           "slice_bsr_sym", "sliced_matvec_any", "sym_sliced_matvec",
           "DistBSRMatrix", "distribute_bsr", "dist_bsr_matvec",
           "DistSlicedBSR", "distribute_sliced_bsr", "dist_sliced_matvec",
           "dist_sliced_from_arrays", "ELLMatrix", "ell_diagonal",
           "ell_from_coo", "ell_from_dense", "ell_matvec", "ell_to_dense",
           "sliced_mm", "sliced_mmT", "sliced_mTm"]
