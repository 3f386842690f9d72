"""The multi-card path of the PyTorch port, rehearsed on gloo ranks on the
CPU: the flagship's fleet job (job ``ladders`` of ``tests/torch_fleet.py``,
run by ``parallel.mh_dryrun.run_fleet``) at a toy size, the order in which
the distributed operators post their ring permutes, and NCCL fleets that
must refuse to run without cards.

The fleet's store is JAX's ``random_bsr_spd(1024, 64, 4)`` (float32
blocks), sliced and partitioned by JAX and carried to the ranks as arrays;
its sharded ``davidson_ladder`` and ``lobpcg_ladder`` over four gloo ranks
are held against JAX's unsharded ladders on the same store (Pallas in
interpret mode) and against rank 0's unsharded ladder over
``sliced_bsr_matvec`` (K5's plain version).  Tolerances: eigenvalues within
1e-10 * max(1, |lambda|), iterations within +-2 and matvecs within +-2
blocks (2 n_max), the returned pairs' residuals by the float64 product of
the original blocks (``dist_bsr_matvec``): rms < 1e-10, max < 1e-9.

LOBPCG's counts are printed, not held.  On this store (the 20 clustered
low modes of ``random_bsr_spd``) its float32 stage ends at another
iteration whenever its float32 arithmetic changes, and the float64 stage,
which starts from where the float32 one ended, with it: the sharded
ladder's float32 operator slices each received shard on its own grid and
sums each contraction over n rank by rank; rank 0's unsharded ladder runs
on one thread; and the unsharded ladder from a guess changed by 1e-9
relative moves as far (``test_lobpcg_float32_stage_count_follows_rounding``).
The eigenvalues and the residuals do not move.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.ops import dist_sliced as jds
from diaglib_tpu.ops import random_bsr_spd as j_random_bsr_spd
from diaglib_tpu.ops import slice_bsr as j_slice_bsr
from diaglib_tpu.ops import sliced_bsr_matvec as j_sliced_matvec
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.solvers import davidson_ladder as j_davidson_ladder
from diaglib_tpu.solvers import lobpcg_ladder as j_lobpcg_ladder
from diaglib_tpu_torch.parallel import mh_dryrun
from tests import torch_fleet

ROOT = Path(__file__).resolve().parents[1]
N, B, BPR = 1024, 64, 4
OPTS = dict(n_targ=4, n_max=8, max_iter=150, tol=1e-10, max_dav=10,
            sliced_mm="never")
LO_TOL, LO_ITER = 2e-6, {"davidson": 35, "lobpcg": 70}
LADDERS = ("davidson", "lobpcg")


def _fields(obj):
    """A JAX dataclass's fields as numpy (tuples of arrays as lists)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, tuple):
            v = [np.asarray(a) for a in v]
        elif hasattr(v, "shape"):
            v = np.asarray(v)
        out[f.name] = v
    return out


@pytest.fixture(scope="module")
def fleet():
    jm = j_random_bsr_spd(N, B, BPR, jax.random.PRNGKey(0),
                          dtype=jnp.float32)
    js = j_slice_bsr(jm)
    guess = np.random.default_rng(21).uniform(-0.5, 0.5,
                                              (OPTS["n_max"], N))
    inputs = dict(carried=dict(bsr=_fields(jm), general=_fields(js),
                               store=_fields(jds.distribute_sliced_bsr(js,
                                                                       4))),
                  ladders=list(LADDERS), options=OPTS, lo_tol=LO_TOL,
                  lo_iter=LO_ITER, guess=guess, unsharded=True, warm=False)
    _, results = mh_dryrun.run_fleet(torch_fleet.JOBS["ladders"], inputs,
                                     num_processes=4, backend="gloo",
                                     device="cpu", timeout=120)
    return js, guess, results


def _reference(js, guess, name):
    ladder = {"davidson": j_davidson_ladder, "lobpcg": j_lobpcg_ladder}[name]
    f32 = jnp.float32
    return ladder(j_sliced_matvec(js, dtype=f32, interpret=True),
                  j_diag_precnd(js.diagonal.astype(f32)),
                  j_sliced_matvec(js, interpret=True),
                  j_diag_precnd(js.diagonal), jnp.asarray(guess),
                  JOptions(**OPTS), key=jax.random.PRNGKey(1), lo_tol=LO_TOL,
                  lo_iter=LO_ITER[name])


def _close(out, tag, eig, counts):
    """Eigenvalues within 1e-10 * max(1, |lambda|); the counts of
    ``counts`` within +-2, matvecs within +-2 blocks."""
    n_targ = OPTS["n_targ"]
    got = out[f"{tag}_eig"][:n_targ]
    atol = 1e-10 * max(1.0, float(np.max(np.abs(eig[:n_targ]))))
    np.testing.assert_allclose(got, eig[:n_targ], rtol=0, atol=atol)
    for key, want in counts.items():
        band = 2 * OPTS["n_max"] if key == "matvec" else 2
        assert abs(out[f"{tag}_{key}"] - want) <= band, (key,
                                                        out[f"{tag}_{key}"],
                                                        want)


def _counts(name, n_iter, n_matvec):
    """The counts held: Davidson's (LOBPCG's are printed; see above)."""
    return {"iter": n_iter, "matvec": n_matvec} if name == "davidson" else {}


@pytest.mark.parametrize("name", LADDERS)
def test_sharded_ladder_matches_reference(fleet, name):
    js, guess, results = fleet
    ref = _reference(js, guess, name)
    assert bool(ref.ok)
    f64_iter = int(np.isfinite(np.asarray(ref.rms_history)[:, 0]).sum())
    print(f"{name}: JAX unsharded {int(ref.n_iter)} iterations (float64 "
          f"{f64_iter}), {int(ref.n_matvec)} matvecs; port sharded "
          f"{results[0][f'{name}_iter']} ({results[0][f'{name}_f64_iter']}), "
          f"{results[0][f'{name}_matvec']}")
    for out in results:
        assert out[f"{name}_ok"] and out[f"{name}_ortho_ok"]
        _close(out, name, np.asarray(ref.eig),
               _counts(name, int(ref.n_iter), int(ref.n_matvec)))


@pytest.mark.parametrize("name", LADDERS)
def test_sharded_ladder_matches_rank0_unsharded(fleet, name):
    _, _, results = fleet
    k5 = results[0]
    assert k5[f"{name}_k5_ok"]
    assert all(f"{name}_k5_eig" not in out for out in results[1:])
    print(f"{name}: rank 0 unsharded {k5[f'{name}_k5_iter']} iterations "
          f"(float64 {k5[f'{name}_k5_f64_iter']}), {k5[f'{name}_k5_matvec']} "
          f"matvecs; sharded {k5[f'{name}_iter']} ({k5[f'{name}_f64_iter']}), "
          f"{k5[f'{name}_matvec']}")
    for out in results:
        _close(out, name, k5[f"{name}_k5_eig"],
               _counts(name, k5[f"{name}_k5_iter"], k5[f"{name}_k5_matvec"]))
    for tag in (name, f"{name}_k5"):
        assert np.max(k5[f"{tag}_res_rms"]) < 1e-10
        assert np.max(k5[f"{tag}_res_max"]) < 1e-9


@pytest.mark.parametrize("name", LADDERS)
def test_reduced_results_bit_identical_across_ranks(fleet, name):
    """What is all-reduced (every reduced solve's eigenvalues, the Gram
    matrix of the returned vectors) is bit-identical on every rank, and
    so are the results every rank returns."""
    _, _, results = fleet
    for out in results:
        for key in (f"{name}_eig_ranks", f"{name}_gram_ranks"):
            assert all(np.array_equal(h, out[key][0]) for h in out[key])
        for key in (f"{name}_eig", f"{name}_res_rms", f"{name}_res_max"):
            np.testing.assert_array_equal(out[key], results[0][key])
        assert out[f"{name}_iter"] == results[0][f"{name}_iter"]


def test_lobpcg_float32_stage_count_follows_rounding(fleet):
    """The unsharded LOBPCG ladder of rank 0, again in this process from
    the guess changed by 1e-9 relative: the same pairs, within 1e-10; the
    counts (printed) move."""
    from diaglib_tpu_torch import SolverOptions, lobpcg_ladder
    from diaglib_tpu_torch.ops.bsr_sliced import (
        sliced_bsr_matvec,
        sliced_store_from_arrays,
    )
    from diaglib_tpu_torch.problems import diag_precnd

    js, guess, results = fleet
    k5 = results[0]
    ws = sliced_store_from_arrays(_fields(js), device="cpu")
    f32 = torch.float32
    noise = np.random.default_rng(5).standard_normal(guess.shape)
    res = lobpcg_ladder(
        sliced_bsr_matvec(ws, dtype=f32), diag_precnd(ws.diagonal.to(f32)),
        sliced_bsr_matvec(ws), diag_precnd(ws.diagonal),
        torch.from_numpy(guess * (1.0 + 1e-9 * noise)), SolverOptions(**OPTS),
        lo_tol=LO_TOL, lo_iter=LO_ITER["lobpcg"])
    f64_iter = int(torch.isfinite(res.rms_history[:, 0]).sum())
    print(f"lobpcg unsharded: {k5['lobpcg_k5_iter']} iterations (float64 "
          f"{k5['lobpcg_k5_f64_iter']}); from the guess changed by 1e-9: "
          f"{res.n_iter} ({f64_iter})")
    assert res.ok
    _close({"x_eig": res.eig.numpy()}, "x", k5["lobpcg_k5_eig"], {})


def test_permutes_posted_in_the_same_order_on_every_rank(fleet):
    _, _, results = fleet
    torch_fleet.check_permute_order(results)
    # one float64 and one float32 sliced matvec, then one BSR product:
    # three offsets each at D = 4
    assert [c[0] for c in results[0]["permutes"]] == [1, 2, 3] * 3
    assert [c[4] for c in results[0]["permutes"]] == (
        ["torch.float64"] * 3 + ["torch.float32"] * 3 + ["torch.float64"] * 3)
    for r, out in enumerate(results):
        for s, dst, src, shape, _ in out["permutes"]:
            assert dst == (r - s) % 4 and src == (r + s) % 4
            assert shape == (15, N // 4)


def test_order_check_catches_a_rank_out_of_order(fleet):
    _, _, results = fleet
    swapped = [dict(out) for out in results]
    calls = list(swapped[2]["permutes"])
    calls[0], calls[2] = calls[2], calls[0]
    swapped[2]["permutes"] = calls
    with pytest.raises(AssertionError, match="other orders"):
        torch_fleet.check_permute_order(swapped)
    # the same offsets, but rank 1 sends rank 0 a float32 shard first
    mixed = [dict(out) for out in results]
    calls = list(mixed[1]["permutes"])
    calls[0:3], calls[3:6] = calls[3:6], calls[0:3]
    mixed[1]["permutes"] = calls
    with pytest.raises(AssertionError, match="sends"):
        torch_fleet.check_permute_order(mixed)


def test_k6_on_received_planes(fleet):
    """Every rank ran K6 (here its plain version) on each group at both
    tiers on the shard it received through the ring, and the levels of the
    ranks differ (each slices another shard)."""
    _, _, results = fleet
    for out in results:
        for tier in ("f64", "f32"):
            assert out[f"k6_{tier}_equal"]
            assert out[f"k6_{tier}_max_err"] == 0
    assert len({out["k6_f64_digest"] for out in results}) == 4


def test_nccl_fleet_without_a_card_raises(monkeypatch):
    started = []
    monkeypatch.setattr(mh_dryrun.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for job in ("dryrun", "ladders"):
        with pytest.raises(RuntimeError, match="no CUDA device for the nccl"):
            mh_dryrun.run_fleet(torch_fleet.JOBS[job], {}, num_processes=4)
    with pytest.raises(RuntimeError, match="no CUDA device for the nccl"):
        mh_dryrun.launch(2)
    assert not started      # no worker was started, on gloo or otherwise


def test_nccl_fleet_with_too_few_cards_raises(monkeypatch):
    monkeypatch.setattr(mh_dryrun.subprocess, "Popen",
                        lambda *a, **k: pytest.fail("a worker started"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(RuntimeError, match="4 NCCL ranks need as many "
                       "cards, this machine has 3"):
        mh_dryrun.run_fleet(torch_fleet.JOBS["ladders"], {},
                            num_processes=4, backend="nccl")


def test_fleet_timeouts_default_by_backend(monkeypatch):
    seen = []

    class Stop(Exception):
        pass

    def popen(cmd, **kw):
        seen.append(float(cmd[cmd.index("--timeout") + 1]))
        raise Stop

    monkeypatch.setattr(mh_dryrun.subprocess, "Popen", popen)
    with pytest.raises(Stop):
        mh_dryrun.run_fleet("dryrun", {}, 2, backend="gloo", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(mh_dryrun, "_build_kernels", lambda: None)
    with pytest.raises(Stop):
        mh_dryrun.run_fleet("dryrun", {}, 2)
    assert seen == [120.0, mh_dryrun.NCCL_TIMEOUT]
    assert mh_dryrun.NCCL_TIMEOUT > 120.0


def test_job_inputs_cover_every_job(tmp_path):
    """Every job but the flagship's has inputs made without JAX, of numpy
    arrays and plain values, and the carried store is one the ranks
    accept."""
    from diaglib_tpu_torch.ops.dist_sliced import dist_sliced_from_arrays

    for job in torch_fleet.JOBS:
        if job == "ladders":
            with pytest.raises(ValueError):
                torch_fleet.job_inputs(job)
            continue
        inp = torch_fleet.job_inputs(job, 4, workdir=str(tmp_path))
        leaves = list(inp.values())
        while leaves:
            v = leaves.pop()
            if isinstance(v, dict):
                leaves.extend(v.values())
            elif isinstance(v, (list, tuple)):
                leaves.extend(v)
            else:
                assert isinstance(v, (np.ndarray, int, float, str)), (job, v)
    store = torch_fleet.job_inputs("dist_sliced", 4)["store"]
    for r in range(4):
        dm = dist_sliced_from_arrays(store, r, "cpu")
        assert dm.rank == r and dm.ndev == 4 and dm.steps == (0, 1, 2, 3)


def test_chip_smoke_four_ranks_needs_cards():
    """``chip_smoke.py --ranks 4`` exits non-zero without four cards and
    prints no result line."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--ranks", "4"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
