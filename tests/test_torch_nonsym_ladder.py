"""The nonsymmetric ladder of the PyTorch port against the JAX package:
the similarity-transformed operator R = E_- S E_+ over a symmetric sliced
store S and general sliced stores of T and T^T, its closures, and
``nonsym_ladder`` on stores carried over from JAX's
``bsr_nonsym_similarity``; then the port's own generators (its
``bsr_nonsym_similarity`` against a dense float64 oracle of its blocks,
``nonsym_matrix``, and the device default of every generator).

Tolerances: the closures agree with JAX's (interpret mode) to 1e-13 of
max|R| max|x|, as the reference's own oracle test holds them; ladder
eigenvalues within 1e-10 of JAX's and (n_iter, n_matvec) within +-2
iterations; the port's operator within 1e-13 of its dense oracle.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.problems import bsr_nonsym_similarity as j_bsr_nonsym
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.problems import nonsym_similarity_ops as j_ops
from diaglib_tpu.solvers import nonsym_ladder as j_nonsym_ladder
from diaglib_tpu.utils.guess import guess_evec
from diaglib_tpu_torch import SolverOptions, nonsym_ladder
from diaglib_tpu_torch.ops.bsr import bsr_to_dense, random_bsr_spd
from diaglib_tpu_torch.ops.bsr_sliced import sliced_store_from_arrays
from diaglib_tpu_torch.ops.bsr_sliced_sym import sym_store_from_arrays
from diaglib_tpu_torch.problems import (
    _band_bsr,
    _bsr_transpose_band,
    bsr_gen_problem,
    bsr_nonsym_similarity,
    diag_precnd,
    metric_matrix,
    nonsym_matrix,
    nonsym_similarity_ops,
    nonsym_similarity_sided,
    symm_matrix,
)

N, B, BPR = 192, 32, 3


@pytest.fixture(scope="module")
def carried():
    """JAX's stores and the port's copies of them."""
    jstores, jdiag = j_bsr_nonsym(N, B, BPR, jax.random.PRNGKey(5),
                                  t_scale=0.05)
    s, st, stt = jstores
    tstores = (sym_store_from_arrays(s, device="cpu"),
               sliced_store_from_arrays(st, device="cpu"),
               sliced_store_from_arrays(stt, device="cpu"))
    return jstores, jdiag, tstores


def _x(k=4, seed=9):
    return np.random.default_rng(seed).standard_normal((k, N))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_closures_match_the_reference(carried, dtype):
    jstores, _, tstores = carried
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    x = _x().astype(np.float64 if dtype == torch.float64 else np.float32)
    jmv, jmvl = j_ops(jstores, dtype=jdt, interpret=True)
    mv, mvl = nonsym_similarity_ops(tstores, dtype=dtype)
    sided_r = nonsym_similarity_sided(tstores[0], tstores[1], 1.0,
                                      dtype=dtype)
    sided_l = nonsym_similarity_sided(tstores[0], tstores[2], -1.0,
                                      dtype=dtype)
    tol = 1e-13 if dtype == torch.float64 else 2.0 ** -20
    for got, ref in ((mv, jmv), (mvl, jmvl)):
        y = got(torch.from_numpy(x))
        assert y.dtype == dtype
        want = np.asarray(ref(jnp.asarray(x)), np.float64)
        scale = np.max(np.abs(want))
        np.testing.assert_allclose(y.double().numpy(), want, rtol=0,
                                   atol=tol * scale)
    # the sided closure is the same computation (JAX's own test holds its
    # sided closure equal to its ops)
    xt = torch.from_numpy(x)
    assert torch.equal(sided_r(xt), mv(xt))
    assert torch.equal(sided_l(xt), mvl(xt))


def test_nonsym_ladder_matches_the_reference(carried):
    jstores, jdiag, tstores = carried
    kw = dict(n_targ=3, n_max=3, max_iter=100, tol=1e-9, max_dav=10)
    guess = np.asarray(guess_evec(6, jax.random.PRNGKey(2), N, 3,
                                  diagonal=jdiag))
    jlo = j_ops(jstores, dtype=jnp.float32, interpret=True)
    jhi = j_ops(jstores, interpret=True)
    ref = j_nonsym_ladder(
        *jlo, j_diag_precnd(jdiag.astype(jnp.float32)), *jhi,
        j_diag_precnd(jdiag), jnp.asarray(guess), JOptions(**kw), side="c",
        lo_tol=1e-5, lo_iter=30, key=jax.random.PRNGKey(1), driver="jit")
    d = tstores[0].diagonal
    res = nonsym_ladder(
        *nonsym_similarity_ops(tstores, dtype=torch.float32),
        diag_precnd(d.float()), *nonsym_similarity_ops(tstores),
        diag_precnd(d), torch.from_numpy(guess.copy()), SolverOptions(**kw),
        side="c", lo_tol=1e-5, lo_iter=30)
    assert res.ok and bool(ref.ok) and res.ortho_ok
    np.testing.assert_allclose(res.eig[:3].numpy(), np.asarray(ref.eig[:3]),
                               rtol=0, atol=1e-10)
    assert abs(res.n_iter - int(ref.n_iter)) <= 2
    assert abs(res.n_matvec - int(ref.n_matvec)) <= 2 * 3 * 2
    g = (res.evec_l @ res.evec_r.T).numpy()
    np.testing.assert_allclose(g, np.eye(3), atol=1e-10)


def _series(m, sign, terms=4):
    acc = torch.eye(m.shape[0], dtype=torch.float64)
    term = acc.clone()
    for j in range(1, terms + 1):
        term = term @ (sign * m) / j
        acc = acc + term
    return acc


def test_port_similarity_operator_against_dense_oracle():
    """The port's own generator: S from ``seed``, T from ``seed + 1``; R and
    R^T against the dense series, T^T really T transposed, the
    preconditioner diagonal S's."""
    stores, diag = bsr_nonsym_similarity(N, B, BPR, 5, t_scale=0.05,
                                         device="cpu")
    s_dense = bsr_to_dense(random_bsr_spd(N, B, BPR, 5,
                                          device="cpu")).double()
    t = _band_bsr(N, B, 6, 0.05, device="cpu")
    t_dense = bsr_to_dense(t).double()
    assert torch.equal(bsr_to_dense(_bsr_transpose_band(t)).double(),
                       t_dense.T)
    assert abs(float(torch.linalg.norm(t_dense)) - 0.05) < 0.01
    r_dense = _series(t_dense, -1.0) @ s_dense @ _series(t_dense, 1.0)
    mv, mv_l = nonsym_similarity_ops(stores)
    x = torch.from_numpy(_x())
    scale = float(r_dense.abs().max() * x.abs().max())
    assert float((mv(x) - x @ r_dense.T).abs().max()) <= 1e-13 * scale
    assert float((mv_l(x) - x @ r_dense).abs().max()) <= 1e-13 * scale
    assert torch.equal(diag, torch.diagonal(s_dense))
    # the spectrum is S's: R is similar to S up to ||T||^5/120
    w = np.sort(np.linalg.eigvals(r_dense.numpy()).real)
    np.testing.assert_allclose(w, np.linalg.eigvalsh(s_dense.numpy()),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("variant", [1, 2, 3, 4])
def test_nonsym_matrix_variants(variant):
    g = torch.Generator().manual_seed(3)
    a = nonsym_matrix(60, g, variant=variant, device="cpu").numpy()
    w = np.sort(np.linalg.eigvals(a).real)
    if variant == 1:
        np.testing.assert_allclose(w, np.arange(1, 61) + 2.0, atol=1e-9)
    elif variant == 4:
        w_s = np.linalg.eigvalsh(symm_matrix(60, device="cpu").numpy())
        np.testing.assert_allclose(w, w_s, atol=1e-12)
    else:
        s = symm_matrix(60, device="cpu").numpy()
        pert = a - s
        assert np.all(np.diagonal(pert) == 0.0)
        assert np.all((pert >= 0.0) & (pert <= 0.01))
        assert (variant == 3) == (not pert.any())
    with pytest.raises(ValueError, match="variant"):
        nonsym_matrix(4, variant=5, device="cpu")


def test_generators_build_on_the_card_unless_told(monkeypatch):
    """With no device the generators make their tensors on CUDA and refuse
    to fall back to the CPU where there is none; device='cpu' builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda **d: random_bsr_spd(128, 32, 2, 0, **d),
             lambda **d: bsr_gen_problem(128, 32, 2, 0, **d),
             lambda **d: symm_matrix(8, **d),
             lambda **d: metric_matrix(8, **d),
             lambda **d: nonsym_matrix(8, **d),
             lambda **d: bsr_nonsym_similarity(128, 32, 2, 0, **d)]
    for build in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
        leaf = build(device="cpu")
        while isinstance(leaf, tuple):
            leaf = leaf[0]
        if dataclasses.is_dataclass(leaf):
            leaf = leaf.rows
        assert leaf.device.type == "cpu"
