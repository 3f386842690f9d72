"""Ladder route ``davidson_ladder``: diaglib_tpu_torch's float32-then-
float64 Davidson (``solvers/mixed.py::davidson_ladder``) over an operator
route's two tiers."""

from __future__ import annotations

import torch

from diaglib_tpu_torch import davidson, davidson_ladder

from benchmark.routes import float32_options, options, start


def build(ops, traffic: dict, config: dict):
    opts = options(traffic, config)

    def solve(gen):
        guess = start(traffic, ops, opts.n_max, torch.float64, gen)
        return davidson_ladder(ops.mv_lo, ops.pc_lo, ops.mv_hi, ops.pc_hi,
                               guess, opts, lo_tol=traffic["lo_tol"],
                               lo_iter=traffic["lo_iter"], generator=gen)

    return solve


def build_float32(ops, traffic: dict, config: dict):
    opts = float32_options(traffic, config)

    def solve(gen):
        guess = start(traffic, ops, opts.n_max, torch.float32, gen)
        return davidson(ops.mv_lo, ops.pc_lo, guess, opts, generator=gen)

    return solve
