"""Orthogonalization of the PyTorch port against the JAX package.

Well-conditioned blocks: the Cholesky path is unique, so the port and the
reference agree to 1e-12.  Rank-deficient blocks: the shift ladder and the
QR fallback decide, so the test holds the port to the reference's
properties and to its ok flags instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu import ortho as jor
from diaglib_tpu_torch import ortho as tor
from diaglib_tpu_torch.ortho import core as tcore

N = 257


def _rand(seed, k, n=N):
    return np.random.default_rng(seed).standard_normal((k, n))


def _gram_err(u):
    u = np.asarray(u)
    return np.max(np.abs(u @ u.T - np.eye(u.shape[0])))


def test_norm_est_matches():
    a = np.tril(_rand(0, 12, 12))
    mask = np.arange(12) < 9
    assert abs(float(tor.norm_est(torch.from_numpy(a)))
               - float(jor.norm_est(jnp.asarray(a)))) < 1e-13
    assert abs(float(tor.norm_est(torch.from_numpy(a), torch.from_numpy(mask)))
               - float(jor.norm_est(jnp.asarray(a), jnp.asarray(mask)))) < 1e-13


def test_ortho_cd_matches_reference():
    u = _rand(1, 8)
    out, growth, ok = tor.ortho_cd(torch.from_numpy(u))
    ref, ref_growth, ref_ok = jor.ortho_cd(jnp.asarray(u))
    assert ok and bool(ref_ok)
    assert _gram_err(out.numpy()) < 1e-13
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)
    assert abs(growth - float(ref_growth)) < 1e-12 * float(ref_growth)


def test_ortho_cd_masked_rows_stay_zero():
    mask = np.arange(8) < 5
    u = _rand(2, 8) * mask[:, None]
    out, _, ok = tor.ortho_cd(torch.from_numpy(u), torch.from_numpy(mask))
    ref, _, _ = jor.ortho_cd(jnp.asarray(u), jnp.asarray(mask))
    assert ok
    assert float(out[5:].abs().max()) == 0.0
    assert _gram_err(out[:5].numpy()) < 1e-13
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


def test_ortho_qr_masked_and_second_set():
    mask = np.arange(7) < 4
    u = _rand(3, 7) * mask[:, None]
    out = tor.ortho_qr(torch.from_numpy(u), torch.from_numpy(mask)).numpy()
    assert np.max(np.abs(out[4:])) == 0.0
    assert _gram_err(out[:4]) < 1e-13
    ref = np.asarray(jor.ortho_qr(jnp.asarray(u), jnp.asarray(mask)))
    # same span as the reference's Q rows (signs may differ)
    np.testing.assert_allclose(np.abs(out[:4] @ ref[:4].T), np.eye(4),
                               atol=1e-12)
    a = _rand(4, N, N)
    a = (a + a.T) / 2
    v = _rand(5, 5)
    q, aq = tor.ortho_qr(torch.from_numpy(v), extra=torch.from_numpy(v @ a))
    assert np.max(np.abs(q.numpy() @ a - aq.numpy())) < 1e-8


def test_ortho_vs_x_matches_reference():
    x = np.array(jor.ortho_cd(jnp.asarray(_rand(6, 6)))[0])
    u = _rand(7, 4) + 0.5 * x[:4]
    out, done = tor.ortho_vs_x(torch.from_numpy(x), torch.from_numpy(u))
    ref, ref_done = jor.ortho_vs_x(jnp.asarray(x), jnp.asarray(u))
    assert done and bool(ref_done)
    assert np.max(np.abs(x @ out.numpy().T)) < 1e-13
    assert _gram_err(out.numpy()) < 1e-13
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


def test_ortho_vs_x_masked():
    xmask = np.arange(6) < 3
    x = np.array(jor.ortho_cd(jnp.asarray(_rand(8, 6) * xmask[:, None]),
                                jnp.asarray(xmask))[0])
    umask = np.arange(4) < 2
    u = _rand(9, 4) * umask[:, None]
    out, done = tor.ortho_vs_x(torch.from_numpy(x), torch.from_numpy(u),
                               xmask=torch.from_numpy(xmask),
                               umask=torch.from_numpy(umask))
    ref, ref_done = jor.ortho_vs_x(jnp.asarray(x), jnp.asarray(u),
                                   xmask=jnp.asarray(xmask),
                                   umask=jnp.asarray(umask))
    assert done == bool(ref_done)
    assert float(out[2:].abs().max()) == 0.0
    assert np.max(np.abs(x[:3] @ out.numpy()[:2].T)) < 1e-13
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12)


def _count_cholesky(monkeypatch):
    calls = []
    real = tcore.masked_cholesky

    def counting(a, mask):
        out = real(a, mask)
        calls.append(bool(out[1]))
        return out

    monkeypatch.setattr(tcore, "masked_cholesky", counting)
    return calls


def test_ortho_cd_level_shift_on_rank_deficiency(monkeypatch):
    """Nearly dependent rows (tests/test_ortho.py:71): the shifted
    Cholesky ladder fires; the port reports ok where the reference does
    and is orthonormal whenever it reports ok."""
    base = _rand(10, 3)
    dup = np.concatenate([base, base + 1e-14 * _rand(11, 3)])
    calls = _count_cholesky(monkeypatch)
    out, _, ok = tor.ortho_cd(torch.from_numpy(dup))
    assert calls[0] is True and len(calls) > 1      # the ladder fired
    _, _, ref_ok = jor.ortho_cd(jnp.asarray(dup))
    assert ok == bool(ref_ok)
    if ok:
        assert _gram_err(out.numpy()) < 1e-8


def test_ortho_cd_reports_exact_rank_deficiency(monkeypatch):
    """Exactly duplicated rows (tests/test_ortho.py:203): never
    orthonormalized by the shift ladder; ok=False as in the reference, and
    the QR fallback of ortho_vs_x's helper still returns orthonormal rows
    on the valid span."""
    base = _rand(12, 3)
    dup = np.concatenate([base, base])
    calls = _count_cholesky(monkeypatch)
    _, _, ok = tor.ortho_cd(torch.from_numpy(dup))
    assert calls[0] is True and len(calls) > 1
    _, _, ref_ok = jor.ortho_cd(jnp.asarray(dup))
    assert not ok and not bool(ref_ok)
    u, _, cd_ok = tcore._ortho_or_qr(torch.from_numpy(dup), None)
    assert not cd_ok and _gram_err(u.numpy()) < 1e-12


def test_ortho_vs_x_impossible_reports_failure():
    x = np.eye(4)
    u = _rand(13, 2, 4)
    _, done = tor.ortho_vs_x(torch.from_numpy(x), torch.from_numpy(u))
    _, ref_done = jor.ortho_vs_x(jnp.asarray(x), jnp.asarray(u))
    assert not done and not bool(ref_done)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ortho_cd_keeps_dtype(dtype):
    out, _, ok = tor.ortho_cd(torch.from_numpy(_rand(14, 6)).to(dtype))
    assert ok and out.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    assert _gram_err(out.double().numpy()) < tol
