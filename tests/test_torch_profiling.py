"""``profiling`` of the port: the trace file and the solvers' phase scopes,
the host timers, and ``collective_inventory`` in both forms, the HLO parse
held against the JAX package's on tests/test_collectives.py's fixture (the
same dict), and the recorded ``torch.distributed`` calls of one sharded
Davidson iteration pinned in a 4-rank gloo fleet, as
tests/test_sharding.py pins the collectives of JAX's compiled step.
"""

import glob
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from diaglib_tpu.profiling import collective_inventory as j_inventory
from diaglib_tpu_torch import SolverOptions, davidson
from diaglib_tpu_torch.parallel import mh_dryrun
from diaglib_tpu_torch.problems import dense_matvec, diag_precnd, symm_matrix
from diaglib_tpu_torch.profiling import (
    collective_inventory,
    phase_timings,
    trace,
    wall,
)
from tests import torch_fleet

HERE = Path(__file__).resolve().parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU threads and XLA's contend in one process
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fixture():
    spec = importlib.util.spec_from_file_location(
        "hlo_fixture", HERE / "test_collectives.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._FIXTURE


def test_hlo_inventory_is_the_reference_dict():
    text = _fixture()
    assert collective_inventory(text) == j_inventory(text)
    empty = "ENTRY %m { ROOT %x = f32[2]{0} add(%a,%b) }"
    assert collective_inventory(empty) == j_inventory(empty) == {}


def test_hlo_inventory_takes_the_reference_keyword():
    """The first parameter is named as the reference names it, so a call
    by keyword reads the same text in both packages."""
    text = _fixture()
    got = collective_inventory(hlo_text=text)
    assert got == j_inventory(hlo_text=text) and got


def test_wall_and_phase_timings():
    a = symm_matrix(128, device="cpu")
    x = torch.ones((4, 128), dtype=torch.float64)
    assert phase_timings(dense_matvec(a), x, reps=3) > 0
    res, secs = wall(lambda: dense_matvec(a)(x))
    assert secs > 0 and res.shape == (4, 128)


def test_trace_writes_the_phase_scopes(tmp_path):
    a = symm_matrix(128, device="cpu")
    guess = torch.from_numpy(np.random.default_rng(0).uniform(
        -0.5, 0.5, (4, 128)))
    opts = SolverOptions(n_targ=2, n_max=4, max_iter=30, tol=1e-6)
    with trace(str(tmp_path)) as prof:
        res = davidson(dense_matvec(a), diag_precnd(torch.diagonal(a)),
                       guess, opts)
    assert res.ok
    files = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert {"matvec", "rayleigh-ritz", "expand-ortho"} <= names
    scopes = {e.key: e.count for e in prof.key_averages()}
    assert scopes["matvec"] == scopes["rayleigh-ritz"] == res.n_iter


def test_inventory_of_an_unsharded_solve_is_empty():
    a = symm_matrix(64, device="cpu")
    guess = torch.from_numpy(np.random.default_rng(0).uniform(
        -0.5, 0.5, (4, 64)))
    assert collective_inventory(
        davidson, dense_matvec(a), diag_precnd(torch.diagonal(a)), guess,
        SolverOptions(n_targ=2, n_max=4, max_iter=3, tol=1e-6)) == {}


N, N_EIG = 64, 6


@pytest.fixture(scope="module")
def fleet_inventory():
    inp = {"a": symm_matrix(N, device="cpu").numpy(),
           "guess": np.random.default_rng(4).uniform(-0.5, 0.5, (N_EIG, N)),
           "options": dict(n_targ=3, n_max=N_EIG, max_iter=10, tol=1e-8)}
    _, outs = mh_dryrun.run_fleet(torch_fleet.JOBS["inventory"], inp,
                                  num_processes=4, backend="gloo",
                                  device="cpu", timeout=120)
    return [o["inventory"] for o in outs]


def test_sharded_iteration_inventory_pinned(fleet_inventory):
    """One iteration of the sharded Davidson, each rank holding its rows of
    a dense operator: 21 all-reduces (check_guess's norm and overlap and
    ortho_cd's Gram rounds on the guess, the reduced-matrix rows, the
    residual norms and maxima, the expansion's projections and Gram
    rounds) and one all-gather, the matvec's (n_max, n) block.  If an
    intentional change alters the inventory, re-record it from the failure
    message."""
    inv = fleet_inventory[0]
    assert all(other == inv for other in fleet_inventory)
    counts = {k: v["count"] for k, v in inv.items()}
    assert counts == {"all-reduce": 21, "all-gather": 1}, inv
    # the gathered block is the (n_max, n) vector block, never the operator
    assert inv["all-gather"]["bytes"] == N_EIG * N * 8
    # reductions stay reduced-space sized
    lda_pad = 11 * N_EIG
    ar = inv["all-reduce"]
    assert ar["bytes"] / ar["count"] <= N_EIG * lda_pad * 8, inv
