"""The port's sharded solvers and distributed BSR operator over
``torch.distributed`` gloo ranks on the CPU.

The ranks are worker processes of ``parallel.mh_dryrun.run_fleet`` (one
spawn of 4 ranks with its own timeout, several checks batched); the
unsharded runs they are held to are the port's own in this process.
Tolerances: eigenvalues within 1e-10, iterations and matvec blocks within
+-2 (the reference's tests/test_sharding.py and tests/test_dist_bsr.py);
the distributed matvec within 1e-12 of the serial one; what is all-reduced
(the reduced matrices, the eigenvalues) bit-identical on every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.ops import dist_bsr as jdb
from diaglib_tpu.ops import random_bsr_spd as j_random_bsr_spd
from diaglib_tpu.parallel import VectorSharding as JVectorSharding
from diaglib_tpu.parallel import make_mesh
from diaglib_tpu.problems import casida_blocks as j_casida_blocks
from diaglib_tpu.problems import dense_matvec as j_dense_matvec
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.problems import metric_matrix as j_metric_matrix
from diaglib_tpu.problems import nonsym_matrix as j_nonsym_matrix
from diaglib_tpu.solvers import nonsym as j_nonsym
from diaglib_tpu.utils.guess import guess_evec
from diaglib_tpu_torch import (
    SolverOptions,
    caslr,
    caslr_eff,
    davidson,
    gen_david,
    lobpcg,
    nonsym,
)
from diaglib_tpu_torch.ops.bsr import (
    as_arrays,
    bsr_diagonal,
    bsr_from_arrays,
    bsr_matvec,
    bsr_to_dense,
    random_bsr_spd,
)
from diaglib_tpu_torch.ops.bsr_sliced import slice_bsr, sliced_bsr_matvec
from diaglib_tpu_torch.ops.dist_bsr import dist_bsr_matvec, distribute_bsr
from diaglib_tpu_torch.ops.dist_sliced import (
    dist_sliced_matvec,
    distribute_sliced_bsr,
)
from diaglib_tpu_torch.parallel import (
    VectorSharding,
    initialize,
    make_global,
    make_group,
)
from diaglib_tpu_torch.ortho.core import ortho_qr
from diaglib_tpu_torch.parallel import mh_dryrun
from diaglib_tpu_torch.problems import (
    dense_matvec,
    diag_precnd,
    lrprec_eff,
    lrprec_std,
    symm_matrix,
)
from diaglib_tpu_torch.utils.guess import check_guess
from tests import torch_fleet

N, B = 256, 32
OPTS = dict(n_targ=4, n_max=8, max_iter=200, tol=1e-8, max_dav=10)
NONSYM = dict(n_targ=5, n_max=5, max_iter=200, tol=1e-8, max_dav=10)


@pytest.fixture(scope="module")
def fleet():
    rng = np.random.default_rng(3)
    a = symm_matrix(N, device="cpu").numpy()
    s = np.array(j_metric_matrix(N, jax.random.PRNGKey(1)))
    m = random_bsr_spd(2 * N, B, 4, seed=11, dtype=torch.float64,
                       device="cpu")
    blk = j_casida_blocks(N, jax.random.PRNGKey(17))
    casida = {k: np.asarray(blk[k]) for k in ("apb", "amb", "spd", "smd")}
    casida.update(aa=np.diagonal(np.asarray(blk["aa"])).copy(),
                  sigma=np.diagonal(np.asarray(blk["sigma"])).copy())
    casida_guess = rng.uniform(-0.5, 0.5, (8, 2 * N))
    zero = casida_guess.copy()
    zero[4:] = 0.0
    ns = j_nonsym_matrix(N, jax.random.PRNGKey(1), variant=4)
    ns_guess = guess_evec(6, jax.random.PRNGKey(7), N, NONSYM["n_max"],
                          diagonal=jnp.diagonal(ns))
    inputs = dict(a=a, s=s, guess=rng.uniform(-0.5, 0.5, (8, N)),
                  options=OPTS, bsr=as_arrays(m),
                  x=rng.standard_normal((5, 2 * N)),
                  bsr_guess=rng.uniform(-0.5, 0.5, (8, 2 * N)),
                  casida=casida, casida_guess=casida_guess,
                  casida_zero_guess=zero, nonsym=np.asarray(ns),
                  nonsym_guess=np.asarray(ns_guess), nonsym_options=NONSYM)
    _, results = mh_dryrun.run_fleet(torch_fleet.JOBS["sharded_solvers"],
                                     inputs, num_processes=4, backend="gloo",
                                     device="cpu", timeout=120)
    return inputs, m, results


def _gathered(results, key):
    return np.concatenate([r[key] for r in results], axis=-1)


@pytest.mark.parametrize("solver", ["davidson", "gen_david", "lobpcg"])
def test_sharded_equals_unsharded(fleet, solver):
    inputs, _, results = fleet
    a = torch.from_numpy(inputs["a"])
    guess = torch.from_numpy(inputs["guess"])
    mv, pc = dense_matvec(a), diag_precnd(torch.diagonal(a))
    opts = SolverOptions(**OPTS)
    if solver == "davidson":
        ref = davidson(mv, pc, guess, opts)
    elif solver == "gen_david":
        ref = gen_david(mv, pc, dense_matvec(torch.from_numpy(inputs["s"])),
                        guess, opts)
    else:
        ref = lobpcg(mv, pc, guess, opts)
    assert ref.ok
    n_targ = OPTS["n_targ"]
    for r in results:
        assert r[f"{solver}_ok"]
        np.testing.assert_allclose(r[f"{solver}_eig"][:n_targ],
                                   ref.eig[:n_targ].numpy(), rtol=0,
                                   atol=1e-10)
        assert abs(r[f"{solver}_iter"] - ref.n_iter) <= 2
        assert abs(r[f"{solver}_matvec"] - ref.n_matvec) <= 2 * OPTS["n_max"]
    # the same vectors up to sign, in the solve's metric
    ev = _gathered(results, f"{solver}_evec")[:n_targ]
    metric = inputs["s"] if solver == "gen_david" else np.eye(N)
    np.testing.assert_allclose(
        np.abs(ev @ metric @ ref.evec[:n_targ].numpy().T), np.eye(n_targ),
        rtol=0, atol=1e-7)


@pytest.mark.parametrize("solver", ["davidson", "gen_david", "lobpcg"])
def test_reduced_results_bit_identical_across_ranks(fleet, solver):
    """Every rank's eigenvalue history (one reduced solve of the
    all-reduced matrix an iteration), all-gathered, is the same bits."""
    _, _, results = fleet
    for r in results:
        hist = r[f"{solver}_eig_ranks"]
        assert hist.shape[0] == 4
        assert all(np.array_equal(h, hist[0]) for h in hist[1:])
    assert all(np.array_equal(r[f"{solver}_eig"], results[0][f"{solver}_eig"])
               for r in results)


def test_all_reduced_gram_bit_identical_across_ranks(fleet):
    _, _, results = fleet
    for r in results:
        g = r["gram_ranks"]
        assert g.shape == (4, 8, 8)
        assert all(np.array_equal(x, g[0]) for x in g[1:])
    inputs = fleet[0]
    full = inputs["guess"] @ (inputs["guess"] @ inputs["a"].T).T
    np.testing.assert_allclose(results[0]["gram_ranks"][0], full, rtol=1e-12,
                               atol=1e-12 * np.abs(full).max())


def test_sharded_qr_fallback_and_random_guess(fleet):
    """ortho_qr factors the all-gathered block on every rank: its columns
    are the unsharded QR's, bit for bit.  check_guess's random fallback
    draws the global block and keeps its columns, so the sharded start is
    the unsharded one."""
    inputs, _, results = fleet
    guess = torch.from_numpy(inputs["guess"])
    np.testing.assert_array_equal(_gathered(results, "qr"),
                                  ortho_qr(guess).numpy())
    want = check_guess(torch.zeros_like(guess),
                       torch.Generator().manual_seed(5)).numpy()
    np.testing.assert_allclose(_gathered(results, "random_guess"), want,
                               rtol=0, atol=1e-13)


@pytest.mark.parametrize("solver", ["davidson", "lobpcg"])
def test_rms_uses_the_global_length(fleet, solver):
    """The first iteration's rms is ||r|| / sqrt(n) with the global n: it
    equals the unsharded run's (the local width would make it 2x larger
    over 4 ranks)."""
    inputs, _, results = fleet
    a = torch.from_numpy(inputs["a"])
    run = davidson if solver == "davidson" else lobpcg
    ref = run(dense_matvec(a), diag_precnd(torch.diagonal(a)),
              torch.from_numpy(inputs["guess"]), SolverOptions(**OPTS))
    want = ref.rms_history[0].numpy()
    for r in results:
        np.testing.assert_allclose(r[f"{solver}_rms0"], want, rtol=1e-9)


def _casida_serial(inputs, run, guess, **kw):
    c = {k: torch.from_numpy(np.array(v))
         for k, v in inputs["casida"].items()}
    ops = {f"{k}mul": dense_matvec(c[k]) for k in ("apb", "amb", "spd",
                                                   "smd")}
    opts = SolverOptions(**OPTS)
    if run == "caslr_eff":
        return caslr_eff(lrprec=lrprec_eff(c["aa"], c["sigma"]),
                         evec_guess=torch.from_numpy(guess), options=opts,
                         **ops, **kw)
    return caslr(lrprec=lrprec_std(c["aa"], c["sigma"]),
                 evec_guess=torch.from_numpy(guess), options=opts,
                 algorithm=0, **ops, **kw)


def _paired(results, key):
    """(k, 2n) paired rows from every rank's [Y_local | Z_local]."""
    half = results[0][key].shape[1] // 2
    return np.concatenate(
        [np.concatenate([r[key][:, :half] for r in results], axis=1),
         np.concatenate([r[key][:, half:] for r in results], axis=1)],
        axis=1)


@pytest.mark.parametrize("run,guess", [("caslr", "casida_guess"),
                                       ("caslr_eff", "casida_guess"),
                                       ("caslr_zero", "casida_zero_guess")])
def test_sharded_casida_equals_unsharded(fleet, run, guess):
    """caslr (algorithm 0) and caslr_eff over 4 ranks, each passing and
    receiving [Y_local | Z_local], against the unsharded runs: the same
    eigenvalues, counts and paired vectors (up to sign), and the same
    first-iteration residuals (global n).  From a guess with zero rows the
    fill is drawn at global width, so the sharded start is the unsharded
    one and so are the first residuals."""
    inputs, _, results = fleet
    kw = ({"generator": torch.Generator().manual_seed(5)}
          if run == "caslr_zero" else {})
    ref = _casida_serial(inputs, "caslr_eff" if run == "caslr_eff"
                         else "caslr", inputs[guess], **kw)
    assert ref.ok and ref.ortho_ok
    n_targ = OPTS["n_targ"]
    for r in results:
        assert r[f"{run}_ok"]
        np.testing.assert_allclose(r[f"{run}_eig"][:n_targ],
                                   ref.eig[:n_targ].numpy(), rtol=0,
                                   atol=1e-10)
        assert abs(r[f"{run}_iter"] - ref.n_iter) <= 2
        assert abs(r[f"{run}_matvec"] - ref.n_matvec) <= 4 * OPTS["n_max"]
        np.testing.assert_allclose(r[f"{run}_rms0"],
                                   ref.rms_history[0].numpy(), rtol=1e-9)
        hist = r[f"{run}_eig_ranks"]
        assert all(np.array_equal(h, hist[0]) for h in hist[1:])
    ev = _paired(results, f"{run}_evec")[:n_targ]
    want = ref.evec[:n_targ].numpy()
    cos = np.abs(np.sum(ev * want, axis=1)) / (
        np.linalg.norm(ev, axis=1) * np.linalg.norm(want, axis=1))
    np.testing.assert_allclose(cos, 1.0, rtol=0, atol=1e-8)


def _nonsym_serial(inputs, driver):
    a = torch.from_numpy(np.array(inputs["nonsym"]))
    return nonsym(dense_matvec(a), dense_matvec(a.T),
                  diag_precnd(torch.diagonal(a)),
                  torch.from_numpy(np.array(inputs["nonsym_guess"])),
                  SolverOptions(**NONSYM), side="c", driver=driver)


@pytest.mark.parametrize("driver", ["host", "device"])
def test_sharded_nonsym_equals_unsharded(fleet, driver):
    """nonsym side "c" over 4 ranks (host dgeev and the device Eberlein
    route, each rank solving the same all-reduced reduced matrix) against
    the unsharded run of the same driver: ok, eigenvalues within 1e-10,
    counts within +-2 (+-2 blocks), the same right and left vectors up to
    sign, biorthonormal across the ranks, and every rank's eigenvalue
    history the same bits."""
    inputs, _, results = fleet
    ref = _nonsym_serial(inputs, driver)
    assert ref.ok
    k = NONSYM["n_targ"]
    tag = f"nonsym_{driver}"
    for r in results:
        assert r[f"{tag}_ok"]
        np.testing.assert_allclose(r[f"{tag}_eig"][:k], ref.eig[:k].numpy(),
                                   rtol=0, atol=1e-10)
        assert abs(r[f"{tag}_iter"] - ref.n_iter) <= 2
        assert abs(r[f"{tag}_matvec"] - ref.n_matvec) <= 2 * NONSYM["n_max"]
        hist = r[f"{tag}_eig_ranks"]
        assert all(np.array_equal(h, hist[0]) for h in hist[1:])
    ev_r = _gathered(results, f"{tag}_evec_r")[:k]
    ev_l = _gathered(results, f"{tag}_evec_l")[:k]
    for got, want in ((ev_r, ref.evec_r), (ev_l, ref.evec_l)):
        want = want[:k].numpy()
        cos = np.abs(np.sum(got * want, axis=1)) / (
            np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1))
        np.testing.assert_allclose(cos, 1.0, rtol=0, atol=1e-8)
    np.testing.assert_allclose(ev_l @ ev_r.T, np.eye(k), rtol=0, atol=1e-8)


def test_sharded_nonsym_device_matches_the_reference_sharded(fleet):
    """The port's 4-rank device-driver run against the JAX package's
    sharded ``driver="device"`` run on the 8-device CPU mesh, from the
    same guess: eigenvalues within tests/test_sharding.py's 1e-7."""
    inputs, _, results = fleet
    a = jnp.asarray(inputs["nonsym"])
    ref = j_nonsym(j_dense_matvec(a), j_dense_matvec(a.T),
                   j_diag_precnd(jnp.diagonal(a)),
                   jnp.asarray(inputs["nonsym_guess"]), JOptions(**NONSYM),
                   side="c", sharding=JVectorSharding(make_mesh()),
                   driver="device")
    assert bool(ref.ok)
    k = NONSYM["n_targ"]
    np.testing.assert_allclose(results[0]["nonsym_device_eig"][:k],
                               np.asarray(ref.eig[:k]), rtol=0, atol=1e-7)


def test_dist_bsr_matvec_equals_serial(fleet):
    inputs, m, results = fleet
    x = torch.from_numpy(inputs["x"])
    y = _gathered(results, "bsr_y")
    ref = bsr_matvec(m)(x).numpy()
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-12)
    assert results[0]["bsr_steps"] == distribute_bsr(m, 4).steps


def test_davidson_on_dist_bsr_equals_serial(fleet):
    """The sharded solve over the halo-exchange matvec against the serial
    solve over bsr_matvec (tests/test_dist_bsr.py:92-111)."""
    inputs, m, results = fleet
    ref = davidson(bsr_matvec(m), diag_precnd(bsr_diagonal(m)),
                   torch.from_numpy(inputs["bsr_guess"]),
                   SolverOptions(**OPTS))
    assert ref.ok
    for r in results:
        assert r["bsr_davidson_ok"]
        assert abs(r["bsr_davidson_iter"] - ref.n_iter) <= 2
        np.testing.assert_allclose(r["bsr_davidson_eig"][:4],
                                   ref.eig[:4].numpy(), rtol=0, atol=1e-10)
    w = np.linalg.eigvalsh(bsr_to_dense(m).numpy())[:4]
    np.testing.assert_allclose(results[0]["bsr_davidson_eig"][:4], w,
                               rtol=0, atol=1e-7)


def test_distribute_bsr_bit_equal_to_reference():
    jm = j_random_bsr_spd(2 * N, B, 4, jax.random.PRNGKey(11),
                          dtype=jnp.float64)
    tm = bsr_from_arrays(jm, device="cpu")
    for D in (4, 8):
        jd = jdb.distribute_bsr(jm, D)
        td = distribute_bsr(tm, D)
        assert td.steps == jd.steps
        for name in ("blocks_t", "loc_rows", "loc_cols"):
            for got, ref in zip(getattr(td, name), getattr(jd, name)):
                np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                              err_msg=name)
        own = distribute_bsr(tm, D, rank=D - 1)
        for got, ref in zip(own.blocks_t, td.shard(D - 1).blocks_t):
            assert torch.equal(got, ref)


def test_banded_operator_skips_empty_ring_offsets():
    banded = random_bsr_spd(2 * N, B, 2, seed=23, dtype=torch.float64,
                            device="cpu")
    dm = distribute_bsr(banded, 8)
    assert 0 in dm.steps and set(dm.steps) <= {0, 1, 7}, dm.steps
    ds = distribute_sliced_bsr(slice_bsr(banded), 8)
    assert ds.steps == dm.steps


def test_indivisible_rows_rejected():
    m = random_bsr_spd(2 * N, B, 4, seed=11, dtype=torch.float64,
                       device="cpu")
    with pytest.raises(ValueError):
        distribute_bsr(m, 5)
    with pytest.raises(ValueError):
        distribute_sliced_bsr(slice_bsr(m), 3)


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, torn down after the test."""
    initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, backend="gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_single_rank_degenerates_to_serial(one_rank):
    m = random_bsr_spd(2 * N, B, 4, seed=11, dtype=torch.float64,
                       device="cpu")
    sh = VectorSharding(m.n, make_group())
    assert (sh.rank, sh.size, sh.n_local) == (0, 1, m.n)
    dm = distribute_bsr(m, 1)
    assert dm.steps == (0,)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, m.n)))
    np.testing.assert_allclose(dist_bsr_matvec(dm, sh)(x).numpy(),
                               bsr_matvec(m)(x).numpy(), rtol=0, atol=1e-12)
    ms = slice_bsr(m)
    ds = distribute_sliced_bsr(ms, 1)
    assert ds.steps == (0,) and ds.slices[0][0].data_ptr() == \
        ms.slices.data_ptr()                      # the store, not a copy
    for dt in (torch.float64, torch.float32):
        assert torch.equal(dist_sliced_matvec(ds, sh, dtype=dt)(x.to(dt)),
                           sliced_bsr_matvec(ms, dtype=dt)(x.to(dt)))
    assert torch.equal(make_global(x, sh), x)
    # a guess whose width is not the rank's share is refused
    with pytest.raises(ValueError, match="wide"):
        davidson(bsr_matvec(m), diag_precnd(torch.ones(m.n // 2)),
                 x[:, :m.n // 2].repeat(3, 1)[:8],
                 SolverOptions(n_targ=2, n_max=8), sharding=sh)


def test_operator_and_group_sizes_must_match(one_rank):
    m = random_bsr_spd(2 * N, B, 2, seed=1, dtype=torch.float64,
                       device="cpu")
    sh = VectorSharding(2 * N)
    with pytest.raises(ValueError, match="shards"):
        dist_bsr_matvec(distribute_bsr(m, 2, rank=0), sh)
    with pytest.raises(ValueError, match="shards"):
        dist_sliced_matvec(distribute_sliced_bsr(slice_bsr(m), 2), sh)
    with pytest.raises(ValueError):
        VectorSharding(2 * N).local_cols(torch.zeros(3, N))


def test_initialize_without_a_card_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize("tcp://127.0.0.1:1", 1, 0, backend="nccl")
    assert not dist.is_initialized()


def test_mh_dryrun_launch_two_ranks():
    out = mh_dryrun.launch(2, backend="gloo", device="cpu", timeout=120)
    assert out.count("MH_DRYRUN_OK") == 2


def test_mh_dryrun_launch_defaults_to_the_card():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device for the nccl"):
        mh_dryrun.launch(1, timeout=60)
