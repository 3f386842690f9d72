"""``checkpoint.save`` / ``load`` of the port: the contract of
tests/test_aux.py (an interrupted solve saved and loaded back bit for bit,
resumed to convergence in fewer iterations than a solve from scratch, with
eigenvalues within 1e-9 of the dense oracle), the tree types the package
returns, the refusals, and a sharded save and load in a 4-rank gloo fleet
(each rank writes and reads its own file of shards).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from diaglib_tpu_torch import (
    LRSolverResult,
    NonsymResult,
    SolverOptions,
    SolverResult,
    checkpoint,
    davidson,
)
from diaglib_tpu_torch.parallel import mh_dryrun
from diaglib_tpu_torch.problems import dense_matvec, diag_precnd, symm_matrix
from tests import torch_fleet

N = 120


def _fields_equal(a, b):
    assert type(a) is type(b)
    for x, y in zip(dataclasses.astuple(a), dataclasses.astuple(b)):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def _problem():
    a = symm_matrix(N, device="cpu")
    guess = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.5, 0.5, (6, N)))
    return dense_matvec(a), diag_precnd(torch.diagonal(a)), guess, a


def test_roundtrip_and_resume(tmp_path):
    mv, pc, guess, a = _problem()
    part = davidson(mv, pc, guess, SolverOptions(n_targ=3, n_max=6,
                                                 max_iter=4, tol=1e-10))
    assert not part.ok                       # deliberately interrupted
    ckpt = str(tmp_path / "deep" / "solve_ckpt")   # parents are created
    checkpoint.save(ckpt, part)
    restored = checkpoint.load(ckpt, like=part)
    _fields_equal(restored, part)
    opts = SolverOptions(n_targ=3, n_max=6, max_iter=100, tol=1e-10)
    res = davidson(mv, pc, restored.evec, opts)
    assert res.ok
    w = np.linalg.eigvalsh(a.numpy())[:3]
    np.testing.assert_allclose(res.eig[:3].numpy(), w, rtol=0, atol=1e-9)
    scratch = davidson(mv, pc, guess, opts)
    assert res.n_iter < scratch.n_iter


def test_trees_of_every_result_type(tmp_path):
    t = torch.arange(6.0, dtype=torch.float64).reshape(2, 3)
    z = torch.zeros(2, dtype=torch.bool)
    sr = SolverResult(t, t, True, 3, 9, z, t, t, t, False)
    lr = LRSolverResult(t, t, False, 1, 2, z, t, t, t, True)
    nr = NonsymResult(t, t, t, True, 4, 5, z, t, t, t, t, t, True)
    tree = {"sr": sr, "pair": (lr, [nr, t.float()]), "n": 7, "tag": "x",
            "none": None}
    checkpoint.save(str(tmp_path), tree)
    back = checkpoint.load(str(tmp_path), like=tree)
    assert set(back) == set(tree) and back["n"] == 7 and back["tag"] == "x"
    assert back["none"] is None
    _fields_equal(back["sr"], sr)
    assert isinstance(back["pair"], tuple)
    assert isinstance(back["pair"][1], list)
    _fields_equal(back["pair"][0], lr)
    _fields_equal(back["pair"][1][0], nr)
    assert back["pair"][1][1].dtype == torch.float32
    # the file holds tensors and plain scalars only, under key paths
    flat = torch.load(tmp_path / "rank0.pt", weights_only=True)
    assert torch.equal(flat["sr/evec"], t) and flat["pair/0/ok"] is False


def test_save_overwrites_and_load_refuses_mismatch(tmp_path):
    a = torch.ones((3, 4), dtype=torch.float64)
    checkpoint.save(str(tmp_path), a)
    checkpoint.save(str(tmp_path), 2.0 * a)
    assert torch.equal(checkpoint.load(str(tmp_path), like=a), 2.0 * a)
    with pytest.raises(ValueError, match="like is"):
        checkpoint.load(str(tmp_path), like=torch.ones((4, 3),
                                                       dtype=torch.float64))
    with pytest.raises(ValueError, match="like is"):
        checkpoint.load(str(tmp_path), like=a.float())
    with pytest.raises(ValueError, match="no entry"):
        checkpoint.load(str(tmp_path), like={"a": a})
    with pytest.raises(TypeError, match="unsupported leaf"):
        checkpoint.save(str(tmp_path), {"a": object()})


def test_sharded_save_and_load_in_a_fleet(tmp_path):
    a = symm_matrix(64, device="cpu").numpy()
    guess = np.random.default_rng(3).uniform(-0.5, 0.5, (6, 64))
    inp = {"a": a, "guess": guess, "partial_iter": 4, "dir": str(
        tmp_path / "sharded"), "options": dict(n_targ=3, n_max=6,
                                               max_iter=100, tol=1e-10)}
    _, outs = mh_dryrun.run_fleet(torch_fleet.JOBS["checkpoint"], inp,
                                  num_processes=4, backend="gloo",
                                  device="cpu", timeout=120)
    assert sorted(os.listdir(tmp_path / "sharded")) == [
        f"rank{r}.pt" for r in range(4)]
    w = np.linalg.eigvalsh(a)[:3]
    for r, out in enumerate(outs):
        assert not out["part_ok"] and out["loaded_equal"]
        assert out["part_evec"].shape == (6, 16)     # the rank's shard
        flat = torch.load(tmp_path / "sharded" / f"rank{r}.pt",
                          weights_only=True)
        np.testing.assert_array_equal(flat["evec"].numpy(),
                                      out["part_evec"])
        assert out["resumed_ok"]
        assert out["resumed_iter"] < out["scratch_iter"]
        np.testing.assert_allclose(out["resumed_eig"][:3], w, rtol=0,
                                   atol=1e-9)
