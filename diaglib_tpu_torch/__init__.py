"""diaglib_tpu_torch: the PyTorch + CUDA port of diaglib_tpu for NVIDIA Hopper.

This package carries the float32 -> float64 solve ladders of the symmetric
drivers (Davidson, standard and generalized, and LOBPCG, standard and
generalized), of the Casida linear-response solvers (``caslr``, both
reduced-solve algorithms, and ``caslr_eff``) and of the two-sided
nonsymmetric Davidson, over the symmetric and general integer-sliced BSR
operators or the plain BSR operator.  Plain tensor code is PyTorch; the
kernels are CUDA C++ in ``csrc/``, built by ``nvcc`` at first use: the
slice peel, which also
takes the whole x side of a sliced matvec in one launch
(``ops.slicing.slice_rows``, ``peel_rows``), the symmetric sliced SpMM
(``ops.bsr_sliced_sym.sym_spmm``), the exact wide-rotation product
(``ops.slicing.sliced_wide_mm``), the plain BSR SpMM
(``ops.bsr.bsr_spmm``), the general sliced SpMM
(``ops.bsr_sliced.sliced_spmm``) and the distributed group SpMM
(``ops.dist_sliced.group_spmm``).  On CPU tensors they run their plain
torch versions.  The problem generators, and the functions that carry
the JAX package's stores across, make their tensors on the CUDA device
unless the caller names another.

Every driver and ladder also runs sharded over a ``torch.distributed``
group (``sharding=`` a :class:`~diaglib_tpu_torch.parallel.VectorSharding`;
NCCL on the cards, gloo on the CPU when asked), with the distributed BSR
and sliced operators of ``ops.dist_bsr`` / ``ops.dist_sliced`` as their
matvecs.  Every option of the JAX package's ``SolverOptions`` and drivers
is taken: the reduced solves on the device, the host or by cyclic Jacobi
(``reduced_solver``), the exact sliced long contractions
(``sliced_mm="always"``), and the nonsymmetric reduced solve on the device
by Eberlein's method (``nonsym(driver="device")``).
"""

from . import config, ops, ortho, parallel, solvers, utils
from .ops.bsr import bsr_from_dense, bsr_matvec
from .solvers import (
    NonsymPassResult,
    caslr,
    caslr_eff,
    caslr_eff_ladder,
    caslr_ladder,
    davidson,
    davidson_ladder,
    gen_david,
    gen_david_ladder,
    lobpcg,
    lobpcg_ladder,
    nonsym,
    nonsym_finalize,
    nonsym_ladder,
    nonsym_pass,
    nonsym_seed_left,
)
from .types import (
    LROps,
    LRSolverResult,
    NonsymResult,
    SolverOptions,
    SolverResult,
)

__all__ = ["SolverOptions", "SolverResult", "LROps", "LRSolverResult",
           "NonsymResult", "davidson", "gen_david", "lobpcg", "caslr",
           "caslr_eff", "nonsym", "nonsym_pass", "NonsymPassResult",
           "nonsym_seed_left", "nonsym_finalize", "davidson_ladder",
           "gen_david_ladder", "lobpcg_ladder", "caslr_ladder",
           "caslr_eff_ladder", "nonsym_ladder", "bsr_matvec",
           "bsr_from_dense"]
