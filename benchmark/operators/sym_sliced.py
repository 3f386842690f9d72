"""Operator route ``sym_sliced``: the symmetric int8 slice store
(``slice_bsr_sym``) of the configuration's operator ``a``, its float32 and
float64 tiers (``sym_sliced_matvec``: kernels K2, K1) and their diagonal
preconditioners.  The store keeps nothing of ``a``'s blocks."""

from __future__ import annotations

from types import SimpleNamespace

import torch

from diaglib_tpu_torch.ops.bsr import BSRMatrix
from diaglib_tpu_torch.ops.bsr_sliced_sym import (
    slice_bsr_sym,
    sym_sliced_matvec,
)
from diaglib_tpu_torch.problems import diag_precnd


def bsr(a: dict) -> BSRMatrix:
    """The port's BSR matrix over the benchmark's arrays (no copy)."""
    return BSRMatrix(a["blocks_t"], a["rows"], a["cols"], a["row_start"],
                     a["n"], a["block"])


# the device kernels of one application: K2 (the x side, once) and K1
KERNELS = ("slice_rows_kernel", "sym_spmm_kernel")


def operator_time(trace: dict):
    """(applications, device seconds) of the operator in a traced run: K2's
    launches, and K2's and K1's device time wherever they ran."""
    by_kernel = trace["by_kernel"]
    count = by_kernel.get(KERNELS[0], (0, 0.0))[0]
    ms = sum(by_kernel.get(k, (0, 0.0))[1] for k in KERNELS)
    return count, ms / 1e3


def build(inputs: dict, traffic: dict) -> SimpleNamespace:
    store = slice_bsr_sym(bsr(inputs["a"]))
    f32 = torch.float32
    return SimpleNamespace(
        n=store.n, mv_lo=sym_sliced_matvec(store, dtype=f32),
        pc_lo=diag_precnd(store.diagonal.to(f32)),
        mv_hi=sym_sliced_matvec(store), pc_hi=diag_precnd(store.diagonal),
        diagonal=store.diagonal, device=store.diagonal.device,
        state=store)
