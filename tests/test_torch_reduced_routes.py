"""The reduced-solve routes the port now accepts, through the solvers,
against the JAX package: ``reduced_solver="jacobi"`` and ``"host"`` in
``davidson``, ``lobpcg``, ``caslr`` (algorithm 1, which takes the
Helmich-Paris SVDs) and ``caslr_eff``, and ``nonsym(driver="device")``.

Inputs are made once (numpy, or JAX's own generators) and handed to both
packages as numpy, with nonzero guesses.  An adaptive Jacobi solve is not
LAPACK's, so a port run under "jacobi" is held to the reference's run under
"jacobi": ok, eigenvalues within 1e-10, iterations and matvecs within the
+-2 band of tests/test_iteration_parity.py.  "host" is LAPACK in float64 as
"device" is, so a port run under "host" must give the port's "device"
counts.  The device nonsymmetric driver is held to the reference's
``driver="device"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.problems import casida_blocks as j_casida_blocks
from diaglib_tpu.problems import dense_matvec as j_dense_matvec
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.problems import lrprec_eff as j_lrprec_eff
from diaglib_tpu.problems import lrprec_std as j_lrprec_std
from diaglib_tpu.problems import nonsym_matrix as j_nonsym_matrix
from diaglib_tpu.problems import symm_matrix as j_symm_matrix
from diaglib_tpu.solvers import caslr as j_caslr
from diaglib_tpu.solvers import caslr_eff as j_caslr_eff
from diaglib_tpu.solvers import davidson as j_davidson
from diaglib_tpu.solvers import lobpcg as j_lobpcg
from diaglib_tpu.solvers import nonsym as j_nonsym
from diaglib_tpu.utils.guess import guess_evec
from diaglib_tpu_torch import (
    SolverOptions,
    caslr,
    caslr_eff,
    davidson,
    lobpcg,
    nonsym,
)
from diaglib_tpu_torch.problems import (
    dense_matvec,
    diag_precnd,
    lrprec_eff,
    lrprec_std,
)
from diaglib_tpu_torch.utils import reduced

N_SYM, N_LR = 200, 150
SYM = dict(n_targ=4, n_max=8, max_iter=100, tol=1e-8, max_dav=10)
LR = dict(n_targ=5, n_max=10, max_iter=100, tol=1e-8, max_dav=10)
SOLVERS = ["davidson", "lobpcg", "caslr1", "caslr_eff"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU threads and XLA's contend in one process
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def inputs():
    a = np.asarray(j_symm_matrix(N_SYM))
    sym_guess = np.random.default_rng(1).uniform(-0.5, 0.5, (8, N_SYM))
    blk = {k: np.asarray(v)
           for k, v in j_casida_blocks(N_LR, jax.random.PRNGKey(17)).items()}
    diag = np.diagonal(blk["aa"]) - np.diagonal(blk["sigma"])
    lr_guess = np.asarray(guess_evec(4, jax.random.PRNGKey(3), 2 * N_LR, 10,
                                     diagonal=jnp.asarray(diag)))
    return a, sym_guess, blk, lr_guess


def _run(pkg, solver, inputs, method):
    """One solve of ``solver`` by the port ("torch") or the reference
    ("jax") under ``reduced_solver=method``."""
    a, sym_guess, blk, lr_guess = inputs
    jax_side = pkg == "jax"
    arr = jnp.asarray if jax_side else _t
    dm = j_dense_matvec if jax_side else dense_matvec
    opts = (JOptions if jax_side else SolverOptions)(
        **(SYM if solver in ("davidson", "lobpcg") else LR),
        reduced_solver=method)
    if solver in ("davidson", "lobpcg"):
        run = {("jax", "davidson"): j_davidson, ("jax", "lobpcg"): j_lobpcg,
               ("torch", "davidson"): davidson,
               ("torch", "lobpcg"): lobpcg}[pkg, solver]
        pc = (j_diag_precnd if jax_side else diag_precnd)(
            arr(np.diagonal(a).copy()))
        return run(dm(arr(a)), pc, arr(sym_guess), opts)
    ops = {k: dm(arr(blk[k[:3]]))
           for k in ("apbmul", "ambmul", "spdmul", "smdmul")}
    aa, sg = (arr(np.diagonal(blk[k]).copy()) for k in ("aa", "sigma"))
    if solver == "caslr_eff":
        prec = (j_lrprec_eff if jax_side else lrprec_eff)(aa, sg)
        return (j_caslr_eff if jax_side else caslr_eff)(
            lrprec=prec, evec_guess=arr(lr_guess), options=opts, **ops)
    prec = (j_lrprec_std if jax_side else lrprec_std)(aa, sg)
    return (j_caslr if jax_side else caslr)(
        lrprec=prec, evec_guess=arr(lr_guess), options=opts, algorithm=1,
        **ops)


def _band(it, mv):
    return max(1, round(mv * 2.5 / max(it, 1)))


@pytest.mark.parametrize("solver", SOLVERS)
def test_jacobi_route_matches_the_reference(inputs, solver):
    ref = _run("jax", solver, inputs, "jacobi")
    res = _run("torch", solver, inputs, "jacobi")
    k = (SYM if solver in ("davidson", "lobpcg") else LR)["n_targ"]
    assert res.ok and bool(ref.ok)
    np.testing.assert_allclose(res.eig[:k].numpy(), np.asarray(ref.eig[:k]),
                               rtol=0, atol=1e-10)
    it, mv = int(ref.n_iter), int(ref.n_matvec)
    assert abs(res.n_iter - it) <= 2, (res.n_iter, it)
    assert abs(res.n_matvec - mv) <= _band(it, mv), (res.n_matvec, mv)


@pytest.mark.parametrize("solver", SOLVERS)
def test_host_route_counts_equal_the_device_route(inputs, solver):
    dev = _run("torch", solver, inputs, "device")
    host = _run("torch", solver, inputs, "host")
    assert host.ok and dev.ok
    assert (host.n_iter, host.n_matvec) == (dev.n_iter, dev.n_matvec)
    k = (SYM if solver in ("davidson", "lobpcg") else LR)["n_targ"]
    np.testing.assert_allclose(host.eig[:k].numpy(), dev.eig[:k].numpy(),
                               rtol=0, atol=1e-10)


def test_resolve_and_bad_method():
    assert [reduced.resolve(m) for m in ("auto", "device", "host",
                                         "jacobi")] == [
        "device", "device", "host", "jacobi"]
    with pytest.raises(ValueError, match="reduced_solver"):
        reduced.eigh(torch.eye(4, dtype=torch.float64), "bogus")
    with pytest.raises(ValueError, match="reduced_solver"):
        davidson(lambda x: x, lambda s, x: x,
                 torch.eye(2, 6, dtype=torch.float64),
                 SolverOptions(n_targ=1, n_max=2, reduced_solver="lapack"))


def test_host_cholesky_nan_on_failure():
    """LAPACK dpotrf's info: a matrix that is not positive definite gives
    NaN, not an exception; an SPD one its factor, on the input's dtype."""
    rng = np.random.default_rng(2)
    b = rng.standard_normal((9, 9))
    spd = b @ b.T + 9 * np.eye(9)
    lo = reduced.cholesky(_t(spd), "host")
    np.testing.assert_allclose(lo.numpy(), np.linalg.cholesky(spd), rtol=0,
                               atol=1e-12)
    bad = reduced.cholesky(_t(spd - 40 * np.eye(9)), "host")
    assert bad.dtype == torch.float64 and bool(torch.isnan(bad).all())
    assert reduced.cholesky(_t(spd).float(), "host").dtype == torch.float32


@pytest.fixture(scope="module")
def nonsym_toy():
    a = j_nonsym_matrix(N_SYM, jax.random.PRNGKey(1), variant=4)
    guess = guess_evec(6, jax.random.PRNGKey(7), N_SYM, 5,
                       diagonal=jnp.diagonal(a))
    return np.asarray(a), np.asarray(guess)


def test_nonsym_device_driver_matches_the_reference(nonsym_toy):
    """Side "c" with the Eberlein reduced solve on the operands' device,
    against the reference's ``driver="device"``: ok, eigenvalues within
    1e-10, the same counts within +-2, biorthonormal vectors."""
    a, guess = nonsym_toy
    kw = dict(n_targ=5, n_max=5, max_iter=200, tol=1e-8, max_dav=10)
    ja = jnp.asarray(a)
    ref = j_nonsym(j_dense_matvec(ja), j_dense_matvec(ja.T),
                   j_diag_precnd(jnp.diagonal(ja)), jnp.asarray(guess),
                   JOptions(**kw), side="c", driver="device")
    ta = _t(a)
    res = nonsym(dense_matvec(ta), dense_matvec(ta.T),
                 diag_precnd(torch.diagonal(ta)), _t(guess),
                 SolverOptions(**kw), side="c", driver="device")
    assert res.ok and bool(ref.ok) and res.ortho_ok
    np.testing.assert_allclose(res.eig[:5].numpy(), np.asarray(ref.eig[:5]),
                               rtol=0, atol=1e-10)
    it, mv = int(ref.n_iter), int(ref.n_matvec)
    assert abs(res.n_iter - it) <= 2 and abs(res.n_matvec - mv) <= _band(
        it, mv)
    np.testing.assert_allclose((res.evec_l @ res.evec_r.T).numpy(),
                               np.eye(5), rtol=0, atol=1e-8)
