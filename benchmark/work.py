"""The least time the card could take for a solver's operator work, from
the configuration's shapes alone, whatever implements the operator.

An application of an operator to an ``(n_max, n)`` block reads the
operator's distinct blocks (the diagonal blocks and one of each mirrored
pair of a symmetric operator) once, at float32's 4 bytes an entry: the
least that either stage of a ladder reads, since the float32 stage needs
no more and the float64 stage needs twice that.  It reads the block x
once and writes y once, and performs 2 nnz n_max operations, nnz
counting the stored entries of both triangles.  x and y are counted at
4 bytes an entry in both stages, and both stages' operations at the same
peak, so one figure holds for every application and the share it gives
is a lower bound.  This is the work whatever reads the operator: it does
not count the int8 planes the present kernels read.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
# full 700 W power limit): HBM3 bandwidth, and the float32 (outside the
# tensor cores) and float64 tensor-core rates.
HBM_BYTES_PER_S = 3.35e12
FLOAT32_FLOPS = 67e12
FLOAT64_FLOPS = 67e12

ENTRY_BYTES = 4        # a float32 entry of the operator and of x, y


def application_bytes(op: dict, width: int) -> int:
    """Bytes of one application of one operator: its distinct blocks, its
    x block read and its y block written."""
    return (op["distinct_blocks"] * op["block"] ** 2 + 2 * width * op["n"]) \
        * ENTRY_BYTES


def application_flops(op: dict, width: int) -> int:
    """Operations of one application of one operator: 2 nnz width."""
    return 2 * op["stored_blocks"] * op["block"] ** 2 * width


def least_s(nbytes: float, flops: float) -> float:
    """The larger of the bytes over the bandwidth and the operations over
    the lower of the two precisions' peaks."""
    return max(nbytes / HBM_BYTES_PER_S,
               flops / min(FLOAT32_FLOPS, FLOAT64_FLOPS))


def least_application_s(shapes: dict, width: int) -> float:
    """The least time of one operator application, averaged over the
    configuration's operators (a configuration of two operators applies
    each in turn)."""
    return sum(least_s(application_bytes(op, width),
                       application_flops(op, width))
               for op in shapes.values()) / len(shapes)
