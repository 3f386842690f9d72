"""The slice as a whole: the float32 -> float64 Davidson ladder over the
symmetric sliced BSR store, port against the JAX package.

JAX's ``random_bsr_spd`` operator is sliced by JAX and carried across as
arrays; the JAX ladder runs its Pallas kernels in interpret mode, the port
its plain versions of the same kernels.  Both get one numpy guess.

Tolerances: eigenvalues within 1e-10 * max(1, |lambda|); n_iter within +-2
and n_matvec within +-2 n_max, because float32 rounding order differs
between XLA and torch in the warm-start stage.  The port's float32 stage
reaches lo_tol here, so its stall exit (which the JAX ladder lacks) stays
shut.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.ops.bsr import bsr_to_dense as j_bsr_to_dense
from diaglib_tpu.ops.bsr import random_bsr_spd as j_random_bsr_spd
from diaglib_tpu.ops.bsr_sliced_sym import slice_bsr_sym as j_slice_bsr_sym
from diaglib_tpu.ops.bsr_sliced_sym import sym_sliced_matvec as j_matvec
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.solvers import davidson_ladder as j_ladder
from diaglib_tpu_torch import SolverOptions, davidson_ladder, profiling
from diaglib_tpu_torch.ops.bsr_sliced_sym import (
    sym_sliced_matvec,
    sym_store_from_arrays,
)
from diaglib_tpu_torch.problems import diag_precnd

N_TARG, N_MAX = 4, 8
KW = dict(n_targ=N_TARG, n_max=N_MAX, max_iter=150, tol=1e-10, max_dav=10,
          wide_mm="never", sliced_mm="never")
LADDER = dict(lo_tol=2e-6, lo_iter=35)


@pytest.fixture(scope="module")
def store():
    jm = j_random_bsr_spd(256, 64, 3, jax.random.PRNGKey(0),
                          dtype=jnp.float32)
    js = j_slice_bsr_sym(jm)
    dense = np.asarray(j_bsr_to_dense(jm), np.float64)
    ts = sym_store_from_arrays({f.name: np.asarray(getattr(js, f.name))
                                for f in dataclasses.fields(js)}, device="cpu")
    return js, ts, dense


def test_ladder_matches_reference(store):
    js, ts, dense = store
    guess = np.random.default_rng(21).uniform(-0.5, 0.5, (N_MAX, 256))
    with profiling.solve_log() as log:
        res = davidson_ladder(
            sym_sliced_matvec(ts, dtype=torch.float32),
            diag_precnd(ts.diagonal.to(torch.float32)),
            sym_sliced_matvec(ts), diag_precnd(ts.diagonal),
            torch.from_numpy(guess), SolverOptions(**KW), **LADDER)
    # the JAX ladder has no stall exit: the float32 stage ends without it
    assert [r["end"] for r in log.records] == ["tol", "tol"]
    ref = j_ladder(
        j_matvec(js, dtype=jnp.float32, interpret=True),
        j_diag_precnd(js.diagonal.astype(jnp.float32)),
        j_matvec(js, interpret=True), j_diag_precnd(js.diagonal),
        jnp.asarray(guess), JOptions(**KW), key=jax.random.PRNGKey(1),
        **LADDER)
    assert res.ok and bool(ref.ok) and res.ortho_ok
    ref_eig = np.asarray(ref.eig[:N_TARG])
    atol = 1e-10 * max(1.0, float(np.max(np.abs(ref_eig))))
    np.testing.assert_allclose(res.eig[:N_TARG].numpy(), ref_eig, rtol=0,
                               atol=atol)
    assert abs(res.n_iter - int(ref.n_iter)) <= 2
    assert abs(res.n_matvec - int(ref.n_matvec)) <= 2 * N_MAX
    # against the dense oracle: eigenvalues and independent residuals
    w = np.linalg.eigvalsh(dense)[:N_TARG]
    np.testing.assert_allclose(res.eig[:N_TARG].numpy(), w, rtol=0,
                               atol=atol)
    ev = res.evec[:N_TARG].numpy()
    r = ev @ dense - res.eig[:N_TARG, None].numpy() * ev
    assert np.max(np.linalg.norm(r, axis=1)) / np.sqrt(256) < 1e-10
    assert res.eig.dtype == torch.float64
