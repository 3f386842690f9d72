"""Forms of the reference's public API that the port refused or misread,
held against the JAX package: ``bsr_matvec(force_reference=True)``,
``sliced_wide_mm(n_slices=, bits=)``, ``slice_operand(x, axis)``, ``prefix_mask(k, count, dtype)``,
the re-exports of ``utils``, ``solvers`` and the top-level package, and
the solvers' verbose progress line.

Tolerances: the forced reference BSR path within 1e-6 max|y| of JAX's in
float32 (both sum in float32, in other orders) and 1e-12 in float64; the
exact wide product bit for bit against JAX's kernel in interpret mode
(the same integer planes and levels, combined into the same float32
triple); slice_operand's planes and scales exactly; the masks exactly; the progress line in the reference's format,
line for line, its running eigenvalue within 1e-6 * max(1, |eig|) of
JAX's line (two float64 solves whose early Ritz values differ by the
reduced solves' rounding) and within 1e-10 of JAX's result on the last
line.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diaglib_tpu.ops import bsr as jbsr
from diaglib_tpu.ops import slicing as jsl
from diaglib_tpu.problems import dense_matvec as j_dense_matvec
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.problems import symm_matrix as j_symm_matrix
from diaglib_tpu.solvers import davidson as j_davidson
from diaglib_tpu.utils import masking as jmask
from diaglib_tpu import SolverOptions as JOptions
import diaglib_tpu_torch
from diaglib_tpu_torch import SolverOptions, reporting
from diaglib_tpu_torch.ops import bsr as tbsr
from diaglib_tpu_torch.ops import slicing as tsl
from diaglib_tpu_torch.problems import (
    casida_blocks,
    dense_matvec,
    diag_precnd,
    lrprec_std,
    nonsym_matrix,
    symm_matrix,
)
from diaglib_tpu_torch.solvers import caslr, davidson, lobpcg, nonsym
from diaglib_tpu_torch.utils.masking import prefix_mask

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU threads and XLA's contend in one process
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---- bsr_matvec(force_reference=True) ----

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_bsr_matvec_force_reference(dtype, monkeypatch):
    jm = jbsr.random_bsr_spd(256, 32, 3, jax.random.PRNGKey(0), dtype=dtype)
    x = np.random.default_rng(4).standard_normal((5, 256)).astype(dtype)
    ref = np.asarray(jbsr.bsr_matvec(jm, force_reference=True)(
        jnp.asarray(x)))
    m = tbsr.bsr_from_arrays(jm, device="cpu")

    def no_kernel(*a, **k):
        raise AssertionError("force_reference reached bsr_spmm")

    monkeypatch.setattr(tbsr, "bsr_spmm", no_kernel)
    y = tbsr.bsr_matvec(m, force_reference=True)(torch.from_numpy(x))
    assert y.dtype == torch.from_numpy(x).dtype
    tol = 1e-6 if dtype == jnp.float32 else 1e-12
    np.testing.assert_allclose(y.numpy(), ref, rtol=0,
                               atol=tol * np.max(np.abs(ref)))
    if dtype == jnp.float32:
        # the default path takes K4 (its plain version on the CPU)
        with pytest.raises(AssertionError, match="reached bsr_spmm"):
            tbsr.bsr_matvec(m)(torch.from_numpy(x))


# ---- sliced_wide_mm(n_slices=, bits=) ----

def _wide_operands():
    r = np.random.default_rng(11)
    a = r.standard_normal((15, 165)) * np.exp(2.0 * r.standard_normal(
        (15, 165)))
    return a, r.standard_normal((165, 2048))


@pytest.mark.parametrize("n_slices,bits", [(8, 7), (6, 7), (8, 6), (5, 6)])
def test_sliced_wide_mm_planes_and_bits(n_slices, bits):
    a, b = _wide_operands()
    y = tsl.sliced_wide_mm(torch.from_numpy(a), torch.from_numpy(b),
                           n_slices=n_slices, bits=bits).numpy()
    ref = np.asarray(jsl.sliced_wide_mm(jnp.asarray(a), jnp.asarray(b),
                                        n_slices=n_slices, bits=bits,
                                        interpret=True))
    np.testing.assert_array_equal(y, ref)
    assert np.array_equal(
        y, tsl.sliced_wide_mm_plain(torch.from_numpy(a), torch.from_numpy(b),
                                    n_slices, bits).numpy())


def test_sliced_wide_mm_int32_bound_follows_bits():
    # K = 300000 fits the int32 bound at 6 bits (2^11 a product), not at 7
    a = torch.zeros((1, 300000), dtype=torch.float64)
    b = torch.zeros((300000, 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="overflows"):
        tsl.sliced_wide_mm(a, b)
    assert float(tsl.sliced_wide_mm(a, b, n_slices=4, bits=6).abs().max()) \
        == 0.0


# ---- prefix_mask(k, count, dtype) ----

@pytest.mark.parametrize("dtype,jdtype", [(torch.bool, bool),
                                          (torch.float64, jnp.float64),
                                          (torch.int32, jnp.int32)])
def test_prefix_mask_dtype(dtype, jdtype):
    ref = np.asarray(jmask.prefix_mask(5, 3, jdtype))
    got = prefix_mask(5, 3, dtype)
    assert got.dtype == dtype and got.device == CPU
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(prefix_mask(5, 3, device=CPU),
                       torch.tensor([True, True, True, False, False]))


# ---- re-exports ----

def test_reexports():
    from diaglib_tpu_torch import config, solvers, types, utils
    from diaglib_tpu_torch.utils import guess, masking

    assert diaglib_tpu_torch.config is config
    assert solvers.LROps is types.LROps
    for name in ("gather_rows", "masked_cholesky", "masked_eigh",
                 "masked_svd", "prefix_lock", "prefix_mask", "scatter_rows"):
        assert getattr(utils, name) is getattr(masking, name)
    assert utils.check_guess is guess.check_guess
    assert utils.guess_evec is guess.guess_evec
    assert "LROps" in solvers.__all__ and "guess_evec" in utils.__all__


# ---- the verbose line ----

LINE = re.compile(r"^(\w+) it=(\d+) n_act=(\d+) eig0=(\S+) rms=(\S+) "
                  r"max=(\S+)$")


def _lines(text, name):
    return [ln for ln in text.splitlines() if ln.startswith(f"{name} it=")]


def test_inflight_progress_format(capsys):
    eig = torch.tensor([1.25, 3.0], dtype=torch.float64)
    rms = torch.tensor([2e-3, float("inf")], dtype=torch.float64)
    rmx = torch.tensor([float("nan"), 4e-2], dtype=torch.float64)
    reporting.inflight_progress("davidson", 3, 15, eig, rms, rmx)
    out = capsys.readouterr().out.strip()
    # the reference's format string, with maxima over the finite entries
    assert out == ("davidson it={it} n_act={na} eig0={e:.12e} rms={r:.3e} "
                   "max={m:.3e}").format(it=3, na=15, e=1.25, r=2e-3,
                                         m=4e-2)


def test_davidson_verbose_line_is_the_reference_line(capfd):
    a = j_symm_matrix(100)
    opts = dict(n_targ=2, n_max=4, max_iter=50, tol=1e-8, verbose=True)
    guess = np.random.default_rng(3).uniform(-0.5, 0.5, (4, 100))
    ref = j_davidson(j_dense_matvec(a), j_diag_precnd(jnp.diagonal(a)),
                     jnp.asarray(guess), JOptions(**opts),
                     key=jax.random.PRNGKey(1))
    jax.effects_barrier()
    j_lines = _lines(capfd.readouterr().out, "davidson")
    ta = symm_matrix(100, device=CPU)
    res = davidson(dense_matvec(ta), diag_precnd(torch.diagonal(ta)),
                   torch.from_numpy(guess), SolverOptions(**opts))
    t_lines = _lines(capfd.readouterr().out, "davidson")
    assert res.ok and len(t_lines) == res.n_iter == int(ref.n_iter)
    assert len(j_lines) == len(t_lines)
    for t, j in zip(t_lines, sorted(j_lines, key=lambda s: int(
            LINE.match(s).group(2)))):
        mt, mj = LINE.match(t), LINE.match(j)
        assert mt and mj
        assert mt.group(2, 3) == mj.group(2, 3)          # it, n_act
        e_t, e_j = float(mt.group(4)), float(mj.group(4))
        assert abs(e_t - e_j) <= 1e-6 * max(1.0, abs(e_j))
        for g in (4, 5, 6):                              # the same formats
            assert len(mt.group(g)) == len(mj.group(g))
    # converged: the last line's eigenvalue as the results' eigenvalues
    assert abs(float(LINE.match(t_lines[-1]).group(4))
               - float(ref.eig[0])) <= 1e-10 * max(1.0, abs(float(ref.eig[0])))


def test_every_solver_prints_through_inflight_progress(capsys):
    n = 60
    a = symm_matrix(n, device=CPU)
    pc = diag_precnd(torch.diagonal(a))
    guess = torch.from_numpy(np.random.default_rng(5).uniform(
        -0.5, 0.5, (4, n)))
    opts = SolverOptions(n_targ=2, n_max=4, max_iter=40, tol=1e-7,
                         verbose=True)
    res = lobpcg(dense_matvec(a), pc, guess, opts)
    assert len(_lines(capsys.readouterr().out, "lobpcg")) == res.n_iter
    ns = nonsym_matrix(n, torch.Generator().manual_seed(1), device=CPU)
    res = nonsym(dense_matvec(ns), dense_matvec(ns.T),
                 diag_precnd(torch.diagonal(ns)), guess, opts, side="r")
    assert len(_lines(capsys.readouterr().out, "nonsym")) == res.n_iter
    blk = casida_blocks(n, tdscf=True, device=CPU)
    ops = {f"{k}mul": dense_matvec(blk[k])
           for k in ("apb", "amb", "spd", "smd")}
    g2 = torch.from_numpy(np.random.default_rng(6).uniform(
        -0.5, 0.5, (4, 2 * n)))
    res = caslr(lrprec=lrprec_std(torch.diagonal(blk["aa"]),
                                  torch.diagonal(blk["sigma"])),
                evec_guess=g2, options=opts, **ops)
    lines = _lines(capsys.readouterr().out, "caslr")
    assert len(lines) == res.n_iter and all(LINE.match(ln) for ln in lines)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_slice_operand_takes_the_reference_positional_call(axis):
    """``slice_operand(x, axis)`` with the axis second, as the reference
    is called: the nine planes and the scales of the reference, on each
    axis."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 256)) * 2.0 ** rng.integers(-20, 20, (6, 1))
    planes, scale = tsl.slice_operand(torch.from_numpy(x), axis)
    jp, js = jsl.slice_operand(jnp.asarray(x), axis)
    assert planes.shape == (9, 6, 256)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    # and with the optional parameters positional too
    planes, scale = tsl.slice_operand(torch.from_numpy(x), axis, 9, 6)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jp))
