"""The Casida solvers of the port against the JAX package: ``caslr``
(algorithms 0 and 1) and ``caslr_eff`` on the reference's test_caslr /
test_scflr protocol, the six Casida entries of
tests/test_iteration_parity.py, the reduced solves ``cholesky`` and
``eigh_gen``, ``casida_blocks`` and the paired preconditioners.

Inputs are made once by JAX (``casida_blocks`` from threefry keys, the
guess by ``guess_evec``) and handed to both packages as numpy; each JAX
solve runs once, in a module fixture.  Tolerances: eigenvalues within
1e-10 of JAX's and within rtol 1e-9 of the dense pencil oracle and of each
other (tests/test_caslr.py); iterations within +-2 and matvecs within the
band of tests/test_iteration_parity.py (+-2.5 iterations' worth); the
reduced solves within 1e-12 of JAX's; the preconditioners bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.problems import casida_blocks as j_casida_blocks
from diaglib_tpu.problems import dense_matvec as j_dense_matvec
from diaglib_tpu.problems import lrprec_eff as j_lrprec_eff
from diaglib_tpu.problems import lrprec_std as j_lrprec_std
from diaglib_tpu.solvers import caslr as j_caslr
from diaglib_tpu.solvers import caslr_eff as j_caslr_eff
from diaglib_tpu.utils import reduced as j_reduced
from diaglib_tpu.utils.guess import guess_evec
from diaglib_tpu_torch import SolverOptions, caslr, caslr_eff
from diaglib_tpu_torch.problems import (
    casida_blocks,
    dense_matvec,
    lrprec_eff,
    lrprec_std,
)
from diaglib_tpu_torch.solvers.caslr import _nonzero_or_random
from diaglib_tpu_torch.utils import reduced

N, N_WANT, N_EIG = 150, 5, 10
TOY = dict(n_targ=N_WANT, n_max=N_EIG, max_iter=100, tol=1e-8, max_dav=10)
PATHS = ["caslr0", "caslr1", "caslr_eff"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU threads and XLA's contend in one process: one torch
    # thread runs these small solves ~10x faster
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(n, key, guess_key, n_eig, tdscf):
    """JAX's blocks and strategy-4 guess as numpy."""
    blk = {k: np.asarray(v)
           for k, v in j_casida_blocks(n, key, tdscf=tdscf).items()}
    diag = np.diagonal(blk["aa"]) - np.diagonal(blk["sigma"])
    guess = np.asarray(guess_evec(4, guess_key, 2 * n, n_eig,
                                  diagonal=jnp.asarray(diag)))
    return blk, guess


def _port_run(blk, guess, path, options, **kw):
    ops = {k: dense_matvec(_t(blk[k[:3]])) for k in
           ("apbmul", "ambmul", "spdmul", "smdmul")}
    aa, sg = _t(np.diagonal(blk["aa"])), _t(np.diagonal(blk["sigma"]))
    if path == "caslr_eff":
        return caslr_eff(lrprec=lrprec_eff(aa, sg), evec_guess=_t(guess),
                         options=SolverOptions(**options), **ops, **kw)
    return caslr(lrprec=lrprec_std(aa, sg), evec_guess=_t(guess),
                 options=SolverOptions(**options), algorithm=int(path[-1]),
                 **ops, **kw)


def _jax_run(blk, guess, path, options):
    ops = {k: j_dense_matvec(jnp.asarray(blk[k[:3]])) for k in
           ("apbmul", "ambmul", "spdmul", "smdmul")}
    aa = jnp.asarray(np.diagonal(blk["aa"]))
    sg = jnp.asarray(np.diagonal(blk["sigma"]))
    if path == "caslr_eff":
        return j_caslr_eff(lrprec=j_lrprec_eff(aa, sg), evec_guess=guess,
                           options=JOptions(**options), **ops)
    return j_caslr(lrprec=j_lrprec_std(aa, sg), evec_guess=guess,
                   options=JOptions(**options), algorithm=int(path[-1]),
                   **ops)


def _oracle(blk):
    """w (top of 1/e of S x = e E x) and the paired eigenvectors."""
    e_full = np.block([[blk["aa"], blk["bb"]], [blk["bb"], blk["aa"]]])
    s_full = np.block([[blk["sigma"], blk["delta"]],
                       [-blk["delta"], -blk["sigma"]]])
    e_vals, e_vecs = scipy.linalg.eigh(s_full, e_full)
    return 1.0 / e_vals[::-1][:N_EIG], e_vecs[:, ::-1][:, :N_EIG]


def _band(it, mv):
    """tests/test_iteration_parity.py's matvec band around ``mv``."""
    return max(1, round(mv * 2.5 / max(it, 1)))


def _setup(tdscf):
    blk, guess = _inputs(N, jax.random.PRNGKey(17), jax.random.PRNGKey(3),
                         N_EIG, tdscf)
    refs = {}
    for path in PATHS:
        r = _jax_run(blk, guess, path, TOY)
        refs[path] = (np.asarray(r.eig), int(r.n_iter), int(r.n_matvec),
                      bool(r.ok))
    ports = {path: _port_run(blk, guess, path, TOY) for path in PATHS}
    return blk, guess, refs, ports, _oracle(blk)


@pytest.fixture(scope="module")
def casida():
    return _setup(tdscf=False)


@pytest.fixture(scope="module")
def tdscf():
    return _setup(tdscf=True)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("problem", ["casida", "tdscf"])
def test_solver_matches_reference(problem, path, request):
    _, _, refs, ports, (omega, xs) = request.getfixturevalue(problem)
    ref_eig, ref_it, ref_mv, ref_ok = refs[path]
    res = ports[path]
    assert res.ok and ref_ok and res.ortho_ok
    np.testing.assert_allclose(res.eig[:N_WANT].numpy(), ref_eig[:N_WANT],
                               rtol=0, atol=1e-10)
    assert abs(res.n_iter - ref_it) <= 2
    assert abs(res.n_matvec - ref_mv) <= _band(ref_it, ref_mv)
    np.testing.assert_allclose(res.eig[:N_WANT].numpy(), omega[:N_WANT],
                               rtol=1e-9)
    # the paired vectors match the oracle's up to scale and sign
    for i in range(N_WANT):
        v = res.evec[i].numpy()
        u = xs[:, i]
        assert abs(v @ u) / (np.linalg.norm(v) * np.linalg.norm(u)) \
            > 1 - 1e-6, f"root {i}"
    assert res.evec.shape == (N_EIG, 2 * N)
    assert res.rms_history.shape == (TOY["max_iter"], N_EIG)
    assert np.isinf(res.rms_history[res.n_iter:].numpy()).all()


def test_the_three_paths_agree(casida):
    """caslr (both algorithms) and caslr_eff give the same eigenvalues, as
    the reference's caslr / cashp / caslr_eff outputs do."""
    ports = casida[3]
    e0, e1, e2 = (ports[p].eig[:N_WANT].numpy() for p in PATHS)
    np.testing.assert_allclose(e0, e1, rtol=1e-9)
    np.testing.assert_allclose(e0, e2, rtol=1e-9)


@pytest.mark.parametrize("path", ["caslr0", "caslr_eff"])
def test_half_zero_guess_repaired_per_row(casida, path):
    """A guess with some zero rows gets only those rows filled from the
    generator; the solve still converges to the oracle."""
    blk, guess, _, _, (omega, _) = casida
    half = guess.copy()
    half[N_EIG // 2:] = 0.0
    res = _port_run(blk, half, path, TOY,
                    generator=torch.Generator().manual_seed(5))
    assert res.ok and res.ortho_ok
    np.testing.assert_allclose(res.eig[:N_WANT].numpy(), omega[:N_WANT],
                               rtol=1e-9)


def test_nonzero_or_random_keeps_nonzero_rows():
    v = torch.from_numpy(np.random.default_rng(0).standard_normal((6, 40)))
    v[[1, 4]] = 0.0
    out = _nonzero_or_random(v, torch.Generator().manual_seed(2))
    keep = [0, 2, 3, 5]
    assert torch.equal(out[keep], v[keep])
    fill = out[[1, 4]]
    assert bool(((fill != 0) & (fill >= -0.5) & (fill < 0.5)).all())
    # nothing zero: the block comes back as it is and nothing is drawn
    g = torch.Generator().manual_seed(2)
    state = g.get_state()
    assert _nonzero_or_random(out, g) is out
    assert torch.equal(g.get_state(), state)


# ---- tests/test_iteration_parity.py's six Casida entries, n = 1000 ----

PARITY = {
    "caslr/caslr0": (15, 816),
    "caslr/caslr1": (15, 816),
    "caslr/caslr_eff": (15, 438),
    "scflr/caslr0": (27, 1556),
    "scflr/caslr1": (27, 1556),
    "scflr/caslr_eff": (27, 808),
}
PARITY_OPTS = dict(n_targ=10, n_max=15, max_iter=100, tol=1e-8, max_dav=20)


@pytest.fixture(scope="module")
def parity_inputs():
    key = jax.random.PRNGKey(1)
    return {tag: _inputs(1000, key, key, 15, tdscf)
            for tag, tdscf in (("caslr", False), ("scflr", True))}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_iteration_parity(parity_inputs, name):
    tag, path = name.split("/")
    blk, guess = parity_inputs[tag]
    res = _port_run(blk, guess, path, PARITY_OPTS)
    assert res.ok and res.ortho_ok
    it_exp, mv_exp = PARITY[name]
    assert abs(res.n_iter - it_exp) <= 2, (name, res.n_iter)
    assert abs(res.n_matvec - mv_exp) <= _band(it_exp, mv_exp), \
        (name, res.n_matvec)


# ---- reduced solves ----

def _spd(seed, k=12):
    m = np.random.default_rng(seed).standard_normal((k, k))
    return m @ m.T + k * np.eye(k)


def test_cholesky_matches_reference():
    a = _spd(0)
    got = reduced.cholesky(_t(a)).numpy()
    want = np.asarray(j_reduced.cholesky(jnp.asarray(a), "device"))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(got @ got.T, a, rtol=0, atol=1e-12 * 12 * 12)


def test_cholesky_returns_nans_on_failure():
    """A matrix that is not SPD gives NaNs in the lower triangle, zeros
    above, not an exception (the JAX package's contract); a batch fails
    only where it fails."""
    bad = -_spd(1)
    got = reduced.cholesky(_t(bad)).numpy()
    want = np.asarray(j_reduced.cholesky(jnp.asarray(bad), "device"))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[np.tril_indices(12)]).all()
    both = reduced.cholesky(_t(np.stack([_spd(2), bad])))
    assert bool(torch.isfinite(both[0]).all())
    np.testing.assert_array_equal(both[1].numpy(), want)


def test_eigh_gen_matches_reference():
    s = np.random.default_rng(3).standard_normal((12, 12))
    s = s + s.T
    a = _spd(4)
    e, x = reduced.eigh_gen(_t(s), _t(a))
    je, jx = (np.asarray(t) for t in j_reduced.eigh_gen(
        jnp.asarray(s), jnp.asarray(a), "device"))
    np.testing.assert_allclose(e.numpy(), je, rtol=0,
                               atol=1e-12 * np.abs(je).max())
    x = x.numpy()
    sign = np.sign(np.sum(x * jx, axis=0))
    np.testing.assert_allclose(x * sign, jx, rtol=0,
                               atol=1e-12 * np.abs(jx).max())
    # dsygv itype 1: x^T a x = I and s x = a x diag(e)
    np.testing.assert_allclose(x.T @ a @ x, np.eye(12), rtol=0, atol=1e-12)
    np.testing.assert_allclose(s @ x, a @ x * e.numpy()[None, :], rtol=0,
                               atol=1e-11)


@pytest.mark.parametrize("method", ["host", "jacobi"])
def test_unported_reduced_routes_raise(method):
    """The "host" and "jacobi" routes of the Casida reduced solves, once
    unported, now run: ``cholesky`` and ``eigh_gen`` agree with the
    "device" route (the reference's bounds, tests/test_reduced.py) and
    keep the NaN-on-failure contract; a route no package has raises."""
    a, s = _spd(0), _spd(1) - 20 * np.eye(12)
    np.testing.assert_allclose(reduced.cholesky(_t(a), method).numpy(),
                               reduced.cholesky(_t(a)).numpy(), rtol=0,
                               atol=1e-12 * np.abs(a).max())
    assert bool(torch.isnan(reduced.cholesky(_t(-a), method)).any())
    e, x = (t.numpy() for t in reduced.eigh_gen(_t(s), _t(a), method))
    np.testing.assert_allclose(e, reduced.eigh_gen(_t(s), _t(a))[0].numpy(),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(x.T @ a @ x, np.eye(12), rtol=0, atol=1e-9)
    with pytest.raises(ValueError):
        reduced.cholesky(_t(a), method + "_lapack")


# ---- problems ----

@pytest.mark.parametrize("tdscf", [False, True])
def test_casida_blocks(tdscf):
    """The deterministic blocks equal to JAX's to a rounding (XLA does not
    round 0.2/(i+j) as one division); sigma and delta (from the
    generator, not threefry) with the reference's structure."""
    n = 40
    got = casida_blocks(n, torch.Generator().manual_seed(0), tdscf=tdscf,
                        device="cpu")
    want = j_casida_blocks(n, jax.random.PRNGKey(0), tdscf=tdscf)
    names = ("apb", "amb", "aa", "bb") + (
        ("sigma", "delta", "spd", "smd") if tdscf else ())
    for k in names:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=2.3e-16, atol=0, err_msg=k)
    sg, dl = got["sigma"].numpy(), got["delta"].numpy()
    np.testing.assert_array_equal(sg, sg.T)
    np.testing.assert_array_equal(dl, -dl.T)
    assert np.linalg.eigvalsh(sg).min() >= 1.0 - 1e-12
    np.testing.assert_array_equal(got["spd"].numpy(), sg + dl)
    np.testing.assert_array_equal(got["smd"].numpy(), sg - dl)
    assert np.count_nonzero(got["amb"].numpy() - np.diag(
        np.diagonal(got["amb"].numpy()))) == 0


@pytest.mark.parametrize("kind", ["std", "eff"])
def test_lrprec_bit_for_bit(kind):
    """The paired preconditioners give JAX's bits, with a resonant row (a
    zero denominator) and a near-resonant negative one, so that
    ``_guard_denom`` fires both ways."""
    rng = np.random.default_rng(7)
    n = 32
    aa = rng.uniform(1.0, 10.0, n)
    sg = rng.uniform(0.5, 2.0, n)
    xp, xm = rng.standard_normal((3, n)), rng.standard_normal((3, n))
    if kind == "std":
        # denom = a^2 - f^2 s^2: zero at row 3, just below zero at row 9
        fac = 3.0
        aa[3], sg[3] = 3.0, 1.0
        aa[9], sg[9] = 2.9999999, 1.0
        make, j_make = lrprec_std, j_lrprec_std
    else:
        # denom = f^2 a^2 - s^2: zero at row 3, just below zero at row 9
        fac = 0.5
        aa[3], sg[3] = 2.0, 1.0
        aa[9], sg[9] = 1.9999999, 1.0
        make, j_make = lrprec_eff, j_lrprec_eff
    got = make(_t(aa), _t(sg))(torch.tensor(fac, dtype=torch.float64),
                               _t(xp), _t(xm))
    want = j_make(jnp.asarray(aa), jnp.asarray(sg))(
        jnp.asarray(fac), jnp.asarray(xp), jnp.asarray(xm))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert np.isfinite(g.numpy()).all()
    # the guard fired: the resonant row divides by +floor, the
    # near-resonant negative one by -floor
    if kind == "std":
        denom = aa * aa - fac * fac * sg * sg
        scale = aa * aa + fac * fac * sg * sg
        num = -(aa * xp + fac * sg * xm)
    else:
        denom = fac * fac * aa * aa - sg * sg
        scale = fac * fac * aa * aa + sg * sg
        num = fac * aa * xp + sg * xm
    floor = 1e-5 * np.maximum(scale, 1.0)
    for j, sign in ((3, 1.0), (9, -1.0)):
        assert abs(denom[j]) < floor[j]
        np.testing.assert_allclose(got[0][:, j].numpy(),
                                   num[:, j] / (sign * floor[j]),
                                   rtol=1e-14)


def test_the_casida_names_are_exported():
    """The names of the reference's __all__ lists this slice ports."""
    import diaglib_tpu_torch as t
    from diaglib_tpu_torch import problems, solvers

    for name in ("LROps", "LRSolverResult", "caslr", "caslr_eff",
                 "caslr_ladder", "caslr_eff_ladder"):
        assert name in t.__all__ and hasattr(t, name), name
    for name in ("caslr", "caslr_eff", "caslr_ladder", "caslr_eff_ladder"):
        assert name in solvers.__all__, name
    for name in ("casida_blocks", "lrprec_std", "lrprec_eff",
                 "bsr_casida_tdscf", "casida_tdscf_ops"):
        assert name in problems.__all__, name
    assert {"cholesky", "eigh_gen"} <= set(reduced.__all__)
