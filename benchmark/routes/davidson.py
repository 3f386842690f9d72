"""Ladder route ``davidson``: diaglib_tpu_torch's float64 Davidson
(``solvers/davidson.py::davidson``) alone, as the source runs it, over an
operator route's float64 tier; its control is the same solve over the
float32 tier."""

from __future__ import annotations

import torch

from diaglib_tpu_torch import davidson

from benchmark.routes import options, start


def _build(matvec, precnd, dtype, ops, traffic: dict, config: dict):
    opts = options(traffic, config)

    def solve(gen):
        guess = start(traffic, ops, opts.n_max, dtype, gen)
        return davidson(matvec, precnd, guess, opts, generator=gen)

    return solve


def build(ops, traffic: dict, config: dict):
    return _build(ops.mv_hi, ops.pc_hi, torch.float64, ops, traffic, config)


def build_float32(ops, traffic: dict, config: dict):
    return _build(ops.mv_lo, ops.pc_lo, torch.float32, ops, traffic, config)
