"""The Casida ladders of the port against the JAX package, over the
symmetric sliced stores of JAX's ``bsr_casida_tdscf(256, 8, 2)`` carried
across as arrays: both ``casida_tdscf_ops`` tiers, ``caslr_eff_ladder``
and ``caslr_ladder`` (algorithms 0 and 1), and the device default of the
port's own generators.

JAX runs its Pallas kernels in interpret mode, the port their plain
versions; each JAX ladder runs once, in a module fixture, from one numpy
guess handed to both.  Tolerances: the float64 tier within 1e-14 max|y|
and the float32 tier within 2^-17 max|y| (tests/test_sliced_sym.py's
bounds), the preconditioners bit for bit; eigenvalues within 1e-10 of
JAX's, iterations within +-2 and matvecs within the band of
tests/test_iteration_parity.py, because float32 rounding order differs
between XLA and torch in the warm-start stage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.problems import bsr_casida_tdscf as j_bsr_casida_tdscf
from diaglib_tpu.problems import casida_tdscf_ops as j_casida_tdscf_ops
from diaglib_tpu.solvers import caslr_eff_ladder as j_caslr_eff_ladder
from diaglib_tpu.solvers import caslr_ladder as j_caslr_ladder
from diaglib_tpu_torch import (
    LROps,
    SolverOptions,
    caslr_eff_ladder,
    caslr_ladder,
)
from diaglib_tpu_torch.ops.bsr_sliced_sym import sym_store_from_arrays
from diaglib_tpu_torch.problems import (
    bsr_casida_tdscf,
    casida_blocks,
    casida_tdscf_ops,
)

N, N_TARG, N_MAX = 256, 2, 4
KW = dict(n_targ=N_TARG, n_max=N_MAX, max_iter=150, tol=1e-10, max_dav=10)
LADDER = dict(lo_tol=2e-6, lo_iter=60)
RUNS = ["caslr_eff", "caslr0", "caslr1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU threads and XLA's contend in one process
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def problem():
    j_lo, j_hi, j_diag, (japb, jamb) = j_bsr_casida_tdscf(
        N, 8, 2, jax.random.PRNGKey(3), interpret=True)
    apb, amb = (sym_store_from_arrays(s, device="cpu") for s in (japb, jamb))
    guess = np.random.default_rng(0).uniform(-0.5, 0.5, (N_MAX, 2 * N))
    return dict(j_eff=(j_lo, j_hi), j_std=j_casida_tdscf_ops(
        japb, jamb, interpret=True, prec="std"), j_diag=np.asarray(j_diag),
        apb=apb, amb=amb, guess=guess)


@pytest.fixture(scope="module")
def references(problem):
    """JAX's three ladders, once each."""
    guess = jnp.asarray(problem["guess"])
    key = jax.random.PRNGKey(1)
    out = {"caslr_eff": j_caslr_eff_ladder(*problem["j_eff"], guess,
                                           JOptions(**KW), key=key,
                                           **LADDER)}
    for alg in (0, 1):
        out[f"caslr{alg}"] = j_caslr_ladder(
            *problem["j_std"], guess, JOptions(**KW), algorithm=alg,
            key=key, **LADDER)
    return {k: (np.asarray(r.eig), int(r.n_iter), int(r.n_matvec),
                bool(r.ok)) for k, r in out.items()}


def test_tiers_match_reference(problem):
    """Both tiers' operator closures against JAX's, and the paired
    preconditioners bit for bit, for prec "eff" and "std"."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N_MAX, N))
    lo, hi = casida_tdscf_ops(problem["apb"], problem["amb"])
    j_lo, j_hi = problem["j_eff"]
    np.testing.assert_array_equal(
        (0.5 * (problem["apb"].diagonal + problem["amb"].diagonal)).numpy(),
        problem["j_diag"])

    def run_j(name, tier, xx):
        return np.asarray(jax.jit(getattr(tier, name))(jnp.asarray(xx)),
                          np.float64)

    for name in ("apbmul", "ambmul"):
        want = run_j(name, j_hi, x)
        got = getattr(hi, name)(torch.from_numpy(x))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-14 * np.abs(want).max())
        x32 = x.astype(np.float32)
        want32 = run_j(name, j_lo, x32)
        got32 = getattr(lo, name)(torch.from_numpy(x32))
        assert got32.dtype == torch.float32
        np.testing.assert_allclose(got32.numpy().astype(np.float64), want32,
                                   rtol=0, atol=2.0 ** -17 * np.abs(
                                       want32).max())
        # spdmul / smdmul are the identity (sigma = I, delta = 0)
        for tier in (lo, hi):
            assert tier.spdmul(got) is got and tier.smdmul(got) is got
    lo_s, hi_s = casida_tdscf_ops(problem["apb"], problem["amb"], prec="std")
    j_lo_s, j_hi_s = problem["j_std"]
    rp, rm = rng.standard_normal((2, N_MAX, N))
    for ours, theirs, dt, fac in ((hi, j_hi, np.float64, 1 / 6.5),
                                  (lo, j_lo, np.float32, 1 / 6.5),
                                  (hi_s, j_hi_s, np.float64, 6.5),
                                  (lo_s, j_lo_s, np.float32, 6.5)):
        a, b = rp.astype(dt), rm.astype(dt)
        got = ours.lrprec(torch.tensor(fac, dtype=torch.from_numpy(a).dtype),
                          torch.from_numpy(a), torch.from_numpy(b))
        want = theirs.lrprec(jnp.asarray(fac, dt), jnp.asarray(a),
                             jnp.asarray(b))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        casida_tdscf_ops(problem["apb"], problem["amb"], prec="other")


def _port_run(problem, run):
    opts = SolverOptions(**KW)
    guess = torch.from_numpy(problem["guess"])
    if run == "caslr_eff":
        tiers = casida_tdscf_ops(problem["apb"], problem["amb"])
        return caslr_eff_ladder(*tiers, guess, opts, **LADDER)
    tiers = casida_tdscf_ops(problem["apb"], problem["amb"], prec="std")
    return caslr_ladder(*tiers, guess, opts, algorithm=int(run[-1]),
                        **LADDER)


@pytest.mark.parametrize("run", RUNS)
def test_ladder_matches_reference(problem, references, run):
    res = _port_run(problem, run)
    ref_eig, ref_it, ref_mv, ref_ok = references[run]
    assert res.ok and ref_ok and res.ortho_ok
    np.testing.assert_allclose(res.eig[:N_TARG].numpy(), ref_eig[:N_TARG],
                               rtol=0, atol=1e-10)
    assert abs(res.n_iter - ref_it) <= 2
    assert abs(res.n_matvec - ref_mv) <= max(1, round(ref_mv * 2.5
                                                      / ref_it))
    assert res.eig.dtype == torch.float64
    assert res.evec.shape == (N_MAX, 2 * N)


def test_ladders_match_the_dense_oracle(problem):
    """The float64 operators the stores represent, as dense matrices: w
    from the pencil S x = e E x, E = [[A, B], [B, A]], S = diag(I, -I);
    both ladders' eigenvalues within rtol 1e-9 of it and of each other."""
    _, hi = casida_tdscf_ops(problem["apb"], problem["amb"])
    eye = torch.eye(N, dtype=torch.float64)
    apb, amb = (hi.apbmul(eye).numpy().T, hi.ambmul(eye).numpy().T)
    aa, bb = 0.5 * (apb + amb), 0.5 * (apb - amb)
    e_full = np.block([[aa, bb], [bb, aa]])
    s_full = np.diag(np.r_[np.ones(N), -np.ones(N)])
    omega = 1.0 / scipy.linalg.eigh(s_full, e_full,
                                    eigvals_only=True)[::-1][:N_TARG]
    eff, std = (_port_run(problem, r).eig[:N_TARG].numpy()
                for r in ("caslr_eff", "caslr0"))
    np.testing.assert_allclose(eff, omega, rtol=1e-9)
    np.testing.assert_allclose(std, eff, rtol=1e-9)


def test_generators_build_on_the_card_unless_told(monkeypatch):
    """bsr_casida_tdscf and casida_blocks make their tensors on CUDA with
    no device given and raise where there is none; device='cpu' builds.
    The two stores come from one seed: the same stored blocks and the same
    separated low rows."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda **d: bsr_casida_tdscf(128, 32, 2, 0, **d),
                  lambda **d: casida_blocks(8, **d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    ops_lo, ops_hi, diag_aa, (apb, amb) = bsr_casida_tdscf(128, 32, 2, 0,
                                                           device="cpu")
    assert isinstance(ops_lo, LROps) and isinstance(ops_hi, LROps)
    assert apb.rows.device.type == "cpu" and diag_aa.device.type == "cpu"
    assert casida_blocks(8, device="cpu")["apb"].device.type == "cpu"

    def blocks(s):
        nbr = s.n // s.block
        return np.sort(np.r_[s.rows.numpy() * nbr + s.cols.numpy(),
                             s.rows1.numpy() * nbr + s.cols1.numpy()])

    np.testing.assert_array_equal(blocks(apb), blocks(amb))
    low = [np.sort(np.argsort(s.diagonal.numpy())[:20]) for s in (apb, amb)]
    np.testing.assert_array_equal(low[0], low[1])
    np.testing.assert_array_equal(
        diag_aa.numpy(), 0.5 * (apb.diagonal + amb.diagonal).numpy())
