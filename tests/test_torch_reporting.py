"""``reporting`` and ``config`` of the port against the JAX package.

Given the same histories (the numpy histories of one JAX result), the
port's convergence table is the reference's string, character for
character; on a port solve it has the structure tests/test_aux.py checks.
``config`` keeps the reference's epsilons exactly; ``enable_x64`` sets
torch's process-wide default dtype, so every test that calls it restores
the old default.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu import config as jconfig
from diaglib_tpu import reporting as jrep
from diaglib_tpu.problems import dense_matvec as j_dense_matvec
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.problems import symm_matrix as j_symm_matrix
from diaglib_tpu.solvers import davidson as j_davidson
from diaglib_tpu_torch import SolverOptions, config, davidson, reporting
from diaglib_tpu_torch.problems import dense_matvec, diag_precnd, symm_matrix

N, N_WANT, N_EIG = 200, 3, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU threads and XLA's contend in one process
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_result():
    a = j_symm_matrix(N)
    return j_davidson(j_dense_matvec(a), j_diag_precnd(jnp.diagonal(a)),
                      jnp.zeros((N_EIG, N)),
                      JOptions(n_targ=N_WANT, n_max=N_EIG, max_iter=60,
                               tol=1e-8), key=jax.random.PRNGKey(1))


@pytest.mark.parametrize("tol", [1e-8, None])
def test_table_is_the_reference_string(jax_result, tol):
    hist = {k: np.array(getattr(jax_result, k)) for k in (
        "eig_history", "rms_history", "max_history")}

    class Result:
        n_iter = int(jax_result.n_iter)
        eig_history = torch.from_numpy(hist["eig_history"])
        rms_history = torch.from_numpy(hist["rms_history"])
        max_history = torch.from_numpy(hist["max_history"])

    ref = jrep.convergence_table(jax_result, N_WANT, "Davidson-Liu", tol)
    assert reporting.convergence_table(Result, N_WANT, "Davidson-Liu",
                                       tol) == ref


def test_table_of_a_port_solve(capsys):
    a = symm_matrix(N, device="cpu")
    guess = torch.from_numpy(np.random.default_rng(2).uniform(
        -0.5, 0.5, (N_EIG, N)))
    res = davidson(dense_matvec(a), diag_precnd(torch.diagonal(a)), guess,
                   SolverOptions(n_targ=N_WANT, n_max=N_EIG, max_iter=60,
                                 tol=1e-8))
    txt = reporting.convergence_table(res, N_WANT, "Davidson-Liu", 1e-8)
    lines = txt.splitlines()
    assert any("iter  root" in ln for ln in lines)
    data = [ln for ln in lines if ln.strip() and ln.strip()[0].isdigit()]
    assert len(data) == res.n_iter * N_WANT
    assert data[-1].rstrip().endswith("T")
    reporting.print_convergence_table(res, N_WANT, "Davidson-Liu", 1e-8)
    assert capsys.readouterr().out == txt + "\n"


@pytest.mark.parametrize("cold", [False, True])
def test_timing_report(capsys, cold):
    reporting.timing_report("davidson", 1.23, 17, 140, includes_compile=cold)
    out = capsys.readouterr().out
    jrep.timing_report("davidson", 1.23, 17, 140)
    ref = capsys.readouterr().out
    if cold:
        assert "(includes kernel build and warm-up)" in out
        assert out.replace("  (includes kernel build and warm-up)",
                           "") == ref
    else:
        assert out == ref
    assert "davidson" in out and "operator applications" in out


@pytest.mark.parametrize("dtype,jdtype", [(torch.float64, jnp.float64),
                                          (torch.float32, jnp.float32)])
def test_epsilons(dtype, jdtype):
    assert config.eps(dtype) == jconfig.eps(jdtype)
    assert config.tol_ortho(dtype) == jconfig.tol_ortho(jdtype)


def test_enable_x64_sets_and_restores_the_default():
    old = torch.get_default_dtype()
    try:
        config.enable_x64()
        assert config.default_dtype() == torch.float64
        assert torch.zeros(1).dtype == torch.float64
        config.enable_x64(False)
        assert config.default_dtype() == torch.float32
        assert torch.zeros(1).dtype == torch.float32
    finally:
        torch.set_default_dtype(old)
    assert torch.get_default_dtype() == old
