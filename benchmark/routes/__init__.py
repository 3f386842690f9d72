"""Ladder routes: one module a solver entry of ``diaglib_tpu_torch``.
Each has ``build(ops, traffic, config) -> solve``, where
``solve(generator)`` runs one solve from the traffic's start
(:func:`start`), its random part drawn from ``generator``, and returns
the solver's result, and ``build_float32(ops, traffic, config)``, the same
solve by the program's own float32 path (a ladder's float32 stage alone,
a solver over the float32 tier): the control of the comparison that
decides ``correct``."""

from __future__ import annotations

import dataclasses

import torch

from diaglib_tpu_torch import SolverOptions


def options(traffic: dict, config: dict) -> SolverOptions:
    """The solve's options: roots and block from the traffic, tolerance
    and limits from the configuration."""
    return SolverOptions(n_targ=traffic["n_targ"], n_max=traffic["n_max"],
                         max_iter=config["max_iter"], tol=config["tol"],
                         max_dav=config["max_dav"])


def float32_options(traffic: dict, config: dict) -> SolverOptions:
    """The options the ladders give their float32 stage."""
    return dataclasses.replace(options(traffic, config),
                               tol=max(config["tol"], traffic["lo_tol"]),
                               max_iter=traffic["lo_iter"])


def start(traffic: dict, ops, n_max: int, dtype, generator):
    """The solve's guess block, by the source's ``guess_evec`` strategy
    (``main.f90``:1312-1397) that the traffic's ``guess`` names: 4, a
    random start, which the solver draws itself from ``generator`` when
    handed zeros; 6, unit vectors at the ``n_max`` smallest diagonal
    entries plus 0.01 times uniform [0, 1) noise from ``generator``."""
    kind = traffic.get("guess", 4)
    if kind not in (4, 6):
        raise ValueError(f"no guess strategy {kind!r}")
    if kind == 4:
        return torch.zeros((n_max, ops.n), dtype=dtype, device=ops.device)
    block = 0.01 * torch.rand((n_max, ops.n), generator=generator,
                              dtype=dtype, device=ops.device)
    rows = torch.argsort(ops.diagonal, stable=True)[:n_max]
    block[torch.arange(n_max, device=ops.device), rows] += 1.0
    return block
