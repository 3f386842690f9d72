"""The distributed sliced operator of the PyTorch port against the JAX
package: the partition, kernel K6's plain version, the sharded matvec and
the sharded Davidson solves.

JAX runs on the 8-device CPU mesh of ``tests/conftest.py`` (Pallas in
interpret mode); the port's ranks are gloo worker processes
(``diaglib_tpu_torch.parallel.mh_dryrun.run_fleet``), which import no JAX,
each spawn with its own timeout.  Shapes are the reference's
(``tests/test_dist_sliced.py``): N = 512, B = 32, 4 blocks a row.

Tolerances are the reference's own: the float64 matvec within
1e-14 max|y| of JAX's distributed matvec and of the single-device one, the
float32 tier within 2^-17 of a dense oracle; solves within 1e-10 of JAX's
sharded eigenvalues and within +-2 iterations and matvec blocks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.ops import bsr_from_dense as j_bsr_from_dense
from diaglib_tpu.ops import bsr_to_dense as j_bsr_to_dense
from diaglib_tpu.ops import dist_sliced as jds
from diaglib_tpu.ops import random_bsr_spd as j_random_bsr_spd
from diaglib_tpu.ops import slice_bsr as j_slice_bsr
from diaglib_tpu.ops import slice_bsr_sym as j_slice_bsr_sym
from diaglib_tpu.ops.bsr_sliced import _slice_x as j_slice_x
from diaglib_tpu.parallel import VectorSharding as JSharding
from diaglib_tpu.parallel import make_mesh
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.solvers import davidson as j_davidson
from diaglib_tpu.solvers import davidson_ladder as j_davidson_ladder
from diaglib_tpu_torch.ops.bsr import bsr_from_arrays
from diaglib_tpu_torch.ops.bsr_sliced import (
    _slice_x,
    _tier_params,
    sliced_bsr_matvec,
    sliced_store_from_arrays,
)
from diaglib_tpu_torch.ops.bsr_sliced_sym import sym_store_from_arrays
from diaglib_tpu_torch.ops.dist_sliced import (
    dist_sliced_from_arrays,
    distribute_sliced_bsr,
    group_spmm,
    group_spmm_plain,
)
from diaglib_tpu_torch.parallel.mh_dryrun import run_fleet
from tests.torch_fleet import JOBS

N, B, BPR = 512, 32, 4
GROUP_FIELDS = ("slices", "loc_rows", "loc_cols")
OPTS = dict(n_targ=4, n_max=8, max_iter=100, tol=1e-9, max_dav=10,
            wide_mm="never", sliced_mm="never")
LADDER = dict(lo_tol=1e-4, lo_iter=35)


def _store_arrays(dm):
    """The JAX DistSlicedBSR's fields as numpy (tuples as lists)."""
    out = {k: [np.asarray(a) for a in getattr(dm, k)]
           for k in GROUP_FIELDS + ("first",)}
    out.update(col_scale=np.asarray(dm.col_scale),
               diagonal=np.asarray(dm.diagonal), steps=list(dm.steps),
               n=dm.n, block=dm.block, na=dm.na, ndev=dm.ndev)
    return out


@pytest.fixture(scope="module")
def problem():
    jm = j_random_bsr_spd(N, B, BPR, jax.random.PRNGKey(11),
                          dtype=jnp.float64)
    js = j_slice_bsr(jm)
    return (js, sliced_store_from_arrays(js, device="cpu"),
            np.asarray(j_bsr_to_dense(jm)))


def _irregular():
    """The reference's padded pattern: block diagonal plus blocks on a
    few shards only (tests/test_dist_sliced.py:85-116)."""
    nbr = N // B
    rng = np.random.default_rng(29)
    dense = np.zeros((N, N))
    for r, c in {(r, r) for r in range(nbr)} | {(0, 2), (1, 3), (4, 6)}:
        dense[r*B:(r+1)*B, c*B:(c+1)*B] = rng.standard_normal((B, B))
    js = j_slice_bsr(j_bsr_from_dense(jnp.asarray(dense), B))
    return js, sliced_store_from_arrays(js, device="cpu"), dense


@pytest.mark.parametrize("D", [4, 8])
def test_partition_bit_equal(problem, D):
    js, ts, _ = problem
    jd = jds.distribute_sliced_bsr(js, D)
    td = distribute_sliced_bsr(ts, D)
    assert td.steps == jd.steps and td.ndev == D and td.rank is None
    for name in GROUP_FIELDS:
        for got, ref in zip(getattr(td, name), getattr(jd, name)):
            assert got.numpy().dtype == np.asarray(ref).dtype, name
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                          err_msg=name)
    for name in ("col_scale", "diagonal"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)))
    # JAX's zeroing flags are the starts of the port's sorted local rows
    for lr, ref in zip(td.loc_rows, jd.first):
        lr = lr.numpy()
        starts = np.ones(lr.shape, np.int32)
        starts[:, 1:] = lr[:, 1:] != lr[:, :-1]
        np.testing.assert_array_equal(starts, np.asarray(ref))
    # a rank's own partition, the stacked one's view and the carried
    # shard are the same arrays
    for r in (0, D - 1):
        own = distribute_sliced_bsr(ts, D, rank=r)
        view = td.shard(r)
        carried = dist_sliced_from_arrays(_store_arrays(jd), r, device="cpu")
        for other in (view, carried):
            assert other.steps == own.steps and other.rank == r
            for name in GROUP_FIELDS:
                for a, b in zip(getattr(own, name), getattr(other, name)):
                    assert torch.equal(a, b), name
            assert torch.equal(other.col_scale, own.col_scale)
            assert torch.equal(other.diagonal, own.diagonal)


def test_irregular_partition_has_padding_and_uncovered_rows():
    js, ts, _ = _irregular()
    td = distribute_sliced_bsr(ts, 8)
    jd = jds.distribute_sliced_bsr(js, 8)
    nbr_loc = td.nbr_loc
    assert any(bool((lr == nbr_loc).any()) for lr in td.loc_rows)
    for got, ref in zip(td.loc_rows, jd.loc_rows):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    pad = [sl[lr == nbr_loc] for sl, lr in zip(td.slices, td.loc_rows)]
    assert all(not bool(p.ne(0).any()) for p in pad)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_group_levels_equal_the_reference_kernel(dtype):
    """group_spmm_plain (and the wrapper on CPU tensors) int32-equal to
    JAX's _group_spmm in interpret mode on the rows a group covers, and
    zero on the rows it does not, on every group of every device."""
    js, ts, _ = _irregular()
    D = 8
    jd = jds.distribute_sliced_bsr(js, D)
    td = distribute_sliced_bsr(ts, D)
    nbr_loc, n_loc, k = td.nbr_loc, td.n_local, 3
    nx, na, nlev = _tier_params(td.na, dtype, None, None)
    x = np.random.default_rng(7).standard_normal((k, N))
    x = x.astype(np.float64 if dtype == torch.float64 else np.float32)
    seen_uncovered = False
    for i, s in enumerate(td.steps):
        for d in range(D):
            src = (d + s) % D
            xd = x[:, src * n_loc:(src + 1) * n_loc]
            jxs, _ = j_slice_x(jnp.asarray(xd), nx)
            xs, _ = _slice_x(torch.from_numpy(xd), nx)
            np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
            ref = np.asarray(jds._group_spmm(
                jxs, jd.loc_rows[i][d], jd.loc_cols[i][d], jd.first[i][d],
                jd.slices[i][d], nx=nx, na_used=na, nlev=nlev, k=k, B=B,
                nbr_loc=nbr_loc, interpret=True))
            args = (xs, td.slices[i][d], td.loc_rows[i][d],
                    td.loc_cols[i][d])
            kw = dict(nx=nx, na=na, nlev=nlev, nbr_loc=nbr_loc)
            got = group_spmm_plain(*args, **kw)
            assert got.dtype == torch.int32
            assert got.shape == (nlev * k, n_loc)
            assert torch.equal(group_spmm(*args, **kw), got)
            lr = td.loc_rows[i][d].numpy()
            covered = np.zeros(nbr_loc, bool)
            covered[lr[lr < nbr_loc]] = True
            seen_uncovered |= not covered.all()
            g = got.numpy().reshape(nlev * k, nbr_loc, B)
            r = ref[:, :n_loc].reshape(nlev * k, nbr_loc, B)
            np.testing.assert_array_equal(g[:, covered], r[:, covered])
            assert not g[:, ~covered].any()
    assert seen_uncovered


def test_group_levels_by_explicit_loops():
    """The plain version against a loop over entries and plane pairs in
    int64, padding entries and an uncovered row included."""
    _, ts, _ = _irregular()
    td = distribute_sliced_bsr(ts, 8, rank=2)      # 1 entry + 1 padding
    i = td.steps.index(1)
    sl, lr, lc = td.slices[i], td.loc_rows[i], td.loc_cols[i]
    nbr_loc, n_loc = td.nbr_loc, td.n_local
    assert bool((lr == nbr_loc).any()) and not bool((lr == 1).any())
    nx, na, nlev, k = 4, 4, 4, 2
    xs = np.random.default_rng(5).integers(-64, 65, (nx * k, n_loc)).astype(
        np.int8)
    got = group_spmm_plain(torch.from_numpy(xs), sl, lr, lc, nx=nx, na=na,
                           nlev=nlev, nbr_loc=nbr_loc).numpy()
    x = xs.reshape(nx, k, n_loc).astype(np.int64)
    want = np.zeros((nlev, k, (nbr_loc + 1) * B), np.int64)
    for e in range(sl.shape[0]):
        r, c = int(lr[e]), int(lc[e])
        for p in range(na):
            t = sl[e].numpy()[:, p * B:(p + 1) * B].astype(np.int64)
            for ix in range(nx):
                if p + ix < nlev:
                    want[p + ix, :, r*B:(r+1)*B] += x[ix, :, c*B:(c+1)*B] @ t
    np.testing.assert_array_equal(got, want[:, :, :n_loc].reshape(
        nlev * k, n_loc))


def test_carry_rejects_malformed_arrays(problem):
    js, _, _ = problem
    d = _store_arrays(jds.distribute_sliced_bsr(js, 4))
    dist_sliced_from_arrays(d, 1, device="cpu")       # the intact arrays
    bad = []
    rows = [a.copy() for a in d["loc_rows"]]
    rows[0][1] = rows[0][1][::-1].copy()              # unsorted rows
    bad.append(dict(d, loc_rows=rows))
    cols = [a.copy() for a in d["loc_cols"]]
    cols[0][1, 0] = 99                                # outside the x shard
    bad.append(dict(d, loc_cols=cols))
    rows = [a.copy() for a in d["loc_rows"]]
    rows[0][1, -1] = d["n"] // 4 // d["block"] + 1    # past the padding row
    bad.append(dict(d, loc_rows=rows))
    bad.append(dict(d, na=d["na"] - 1))               # plane widths
    bad.append(dict(d, col_scale=d["col_scale"][:-1]))
    bad.append(dict(d, steps=d["steps"][:-1]))
    for b in bad:
        with pytest.raises(ValueError, match="malformed"):
            dist_sliced_from_arrays(b, 1, device="cpu")


def test_carried_stores_build_on_the_card_unless_told(problem, monkeypatch):
    """The four functions that carry the JAX package's stores across make
    their tensors on CUDA when no device is named, and refuse to fall back
    to the CPU where there is none; device='cpu' builds on the CPU."""
    js, _, _ = problem
    jm = j_random_bsr_spd(N, B, BPR, jax.random.PRNGKey(11),
                          dtype=jnp.float32)
    jd = _store_arrays(jds.distribute_sliced_bsr(js, 4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda **d: bsr_from_arrays(jm, **d),
             lambda **d: sym_store_from_arrays(j_slice_bsr_sym(jm), **d),
             lambda **d: sliced_store_from_arrays(js, **d),
             lambda **d: dist_sliced_from_arrays(jd, 1, **d)]
    for carry in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            carry()
        built = carry(device="cpu")
        for field in dataclasses.fields(built):
            value = getattr(built, field.name)
            for t in value if isinstance(value, tuple) else (value,):
                if isinstance(t, torch.Tensor):
                    assert t.device.type == "cpu", field.name


def test_indivisible_rows_rejected(problem):
    _, ts, _ = problem
    with pytest.raises(ValueError):
        distribute_sliced_bsr(ts, 5)
    with pytest.raises(ValueError):
        distribute_sliced_bsr(ts, 4, rank=4)


@pytest.fixture(scope="module")
def fleet(problem):
    """One 4-rank gloo fleet: both tiers of the matvec, the sharded
    davidson and davidson_ladder, on the store carried from JAX."""
    js, _, _ = problem
    jd = jds.distribute_sliced_bsr(js, 4)
    rng = np.random.default_rng(2)
    inputs = dict(store=_store_arrays(jd),
                  x_f64=rng.standard_normal((5, N)),
                  x_f32=rng.standard_normal((4, N)).astype(np.float32),
                  guess=rng.uniform(-0.5, 0.5, (OPTS["n_max"], N)),
                  options=OPTS, **LADDER)
    _, results = run_fleet(JOBS["dist_sliced"], inputs, num_processes=4,
                           backend="gloo", device="cpu", timeout=120)
    return jd, inputs, results


def _gather(results, key):
    return np.concatenate([r[key] for r in results], axis=-1)


def test_dist_matvec_f64_over_gloo_ranks(problem, fleet):
    js, ts, dense = problem
    jd, inputs, results = fleet
    x = inputs["x_f64"]
    y = _gather(results, "y_f64")
    sh = JSharding(make_mesh(jax.devices()[:4]))
    ref = np.asarray(jax.jit(jds.dist_sliced_matvec(jd, sh, interpret=True))(
        jnp.asarray(x)))
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-14 * scale)
    serial = sliced_bsr_matvec(ts)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, serial, rtol=0, atol=1e-14 * scale)
    np.testing.assert_allclose(y, x @ dense.T, rtol=0, atol=1e-14 * scale)


def test_dist_matvec_f32_over_gloo_ranks(problem, fleet):
    _, _, dense = problem
    _, inputs, results = fleet
    x = inputs["x_f32"]
    y = _gather(results, "y_f32")
    assert y.dtype == np.float32
    ref = x.astype(np.float64) @ dense.T
    assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 2.0 ** -17


def _check_solve(results, prefix, ref, dense):
    for r in results:
        assert r[f"{prefix}_ok"]
        # every rank took the same branches on the same all-reduced values
        assert r[f"{prefix}_iter"] == results[0][f"{prefix}_iter"]
        np.testing.assert_array_equal(r[f"{prefix}_eig"],
                                      results[0][f"{prefix}_eig"])
    n_targ = OPTS["n_targ"]
    eig = results[0][f"{prefix}_eig"][:n_targ]
    np.testing.assert_allclose(eig, np.asarray(ref.eig[:n_targ]), rtol=0,
                               atol=1e-10 * max(1.0, np.max(np.abs(eig))))
    assert abs(results[0][f"{prefix}_iter"] - int(ref.n_iter)) <= 2
    assert abs(results[0][f"{prefix}_matvec"] - int(ref.n_matvec)) <= \
        2 * OPTS["n_max"]
    w = np.linalg.eigvalsh(dense)[:n_targ]
    np.testing.assert_allclose(eig, w, rtol=0, atol=1e-9)
    ev = _gather(results, f"{prefix}_evec")[:n_targ]
    res = ev @ dense - eig[:, None] * ev
    assert np.max(np.linalg.norm(res, axis=1)) / np.sqrt(N) < 1e-9


def test_sharded_davidson_matches_reference(problem, fleet):
    _, _, dense = problem
    jd, inputs, results = fleet
    sh = JSharding(make_mesh(jax.devices()[:4]))
    ref = jax.jit(lambda g: j_davidson(
        jds.dist_sliced_matvec(jd, sh, interpret=True),
        j_diag_precnd(jd.diagonal), g, JOptions(**OPTS),
        key=jax.random.PRNGKey(1), sharding=sh))(jnp.asarray(inputs["guess"]))
    assert bool(ref.ok)
    _check_solve(results, "david", ref, dense)


def test_sharded_davidson_ladder_matches_reference(problem, fleet):
    _, _, dense = problem
    jd, inputs, results = fleet
    sh = JSharding(make_mesh(jax.devices()[:4]))
    ref = jax.jit(lambda g: j_davidson_ladder(
        jds.dist_sliced_matvec(jd, sh, dtype=jnp.float32, interpret=True),
        j_diag_precnd(jd.diagonal.astype(jnp.float32)),
        jds.dist_sliced_matvec(jd, sh, interpret=True),
        j_diag_precnd(jd.diagonal), g, JOptions(**OPTS),
        key=jax.random.PRNGKey(1), **LADDER))(jnp.asarray(inputs["guess"]))
    assert bool(ref.ok)
    _check_solve(results, "ladder", ref, dense)
    # the eigenvalue history (every reduced solve) is bit-identical on
    # every rank
    for r in results:
        hist = r["ladder_eig_ranks"]
        assert all(np.array_equal(h, hist[0]) for h in hist)
