"""The comparison that decides ``correct``: the plain reference against
dense solutions, sound runs pass it, and its control and the timed path's
faults fail it (the harness run on the CPU at small sizes, past its look
for a card)."""

import dataclasses
import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.inputs import hilbert_like
from benchmark.reference import plain, sym

from .conftest import BENCH
from .test_benchmark_inputs import dense

SEED = 2 ** 31 + 7
LIMITS = json.loads((BENCH / "configs" / "hilbert_symm_n32768.json")
                    .read_text())["limits"]


def test_bsr_product_is_the_dense_product():
    a = hilbert_like.build(512, 32, device="cpu")
    x = torch.randn((5, 512), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(SEED))
    want = x @ dense(a).T
    # rounding of sums in another order, against the entries' scale
    assert float((plain.bsr_product(a, x) - want).abs().max()) <= \
        1e-13 * float(want.abs().max())
    assert torch.equal(plain.bsr_diagonal(a), dense(a).diagonal())


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
def test_reference_lowest_against_dense(dtype, tol):
    inputs = hilbert_like.make({"n": 1024, "block": 64}, SEED, "cpu")
    want = torch.linalg.eigvalsh(dense(inputs["a"]))[:10]
    eig, vecs = sym.lowest(inputs, 10, dtype, 1)
    assert float(((eig.double() - want) / want).abs().max()) < tol
    numbers = sym.judge(inputs, eig, vecs, want)
    assert float(numbers.pop("resid_rms_each").max()) == \
        numbers["resid_rms"]
    # the reference in float32 (the control) fails every number
    fails = {k: v > LIMITS[k] for k, v in numbers.items()}
    assert all(fails.values()) == (dtype == torch.float32), numbers


def _run(small, name, **kw):
    result, check, _ = harness.run_cell(small, name, SEED, 0.5, False, "cpu",
                                     time.perf_counter(), **kw)
    return result["correct"], check


@pytest.mark.parametrize("name", ["sym-davidson", "sym-davidson-f64"])
def test_sound_runs_pass(small, name):
    result, check, run = harness.run_cell(small, name, SEED, 0.5, False,
                                          "cpu", time.perf_counter())
    assert result["correct"], check
    assert check["answers_judged"]["value"] >= 1
    # the reference's residuals exceed the solver's own only by the
    # rounding of a fresh product, which shows on roots converged far
    # below the tolerance
    assert run.rms_gap < 0.05


@pytest.mark.parametrize("name", ["sym-davidson", "sym-davidson-f64"])
def test_the_float32_stage_alone_fails(small, name):
    correct, check = _run(small, name, control=True)
    assert not correct
    assert check["resid_rms"]["value"] > check["resid_rms"]["limit"]


def _unchanged(solve):
    """A step that returns its state unchanged: the random start comes
    back as the answer (with the true eigenvalues)."""
    def run(gen):
        res = solve(gen)
        start = torch.randn(res.evec.shape, dtype=torch.float64)
        q, _ = torch.linalg.qr(start.T)
        return dataclasses.replace(res, evec=q.T.contiguous())
    return run


def _half(solve):
    """Half of the roots left out: the first half returned twice."""
    def run(gen):
        res = solve(gen)
        h = res.eig.shape[0] // 2
        k = 4
        eig, evec = res.eig.clone(), res.evec.clone()
        eig[k // 2:k] = eig[:k // 2]
        evec[k // 2:k] = evec[:k // 2]
        assert h >= k // 2
        return dataclasses.replace(res, eig=eig, evec=evec)
    return run


def _eig_altered(solve):
    """An answer altered where it is produced: one eigenvalue moved by a
    part in a million."""
    def run(gen):
        res = solve(gen)
        eig = res.eig.clone()
        eig[1] *= 1 + 1e-6
        return dataclasses.replace(res, eig=eig)
    return run


def _vec_altered(solve):
    """An answer altered where it is produced: one entry of one returned
    vector changed in sign."""
    def run(gen):
        res = solve(gen)
        evec = res.evec.clone()
        j = int(evec[2].abs().argmax())
        evec[2, j] = -evec[2, j]
        return dataclasses.replace(res, evec=evec)
    return run


@pytest.mark.parametrize("fault", [_unchanged, _half, _eig_altered,
                                   _vec_altered])
@pytest.mark.parametrize("name", ["sym-davidson", "sym-davidson-f64"])
def test_faults_of_the_timed_path_fail(small, name, fault):
    correct, check = _run(small, name, wrap_solve=fault)
    assert not correct, check


def test_an_unconverged_solve_fails(small):
    def never(solve):
        def run(gen):
            return dataclasses.replace(solve(gen), ok=False)
        return run

    correct, check = _run(small, "sym-davidson", wrap_solve=never)
    assert not correct and check["unconverged"]["value"] >= 1


@pytest.mark.cuda
def test_control_fails_on_the_card(small, card):
    result, check, _ = harness.run_cell(small, "sym-davidson", SEED, 0.5,
                                     False, card, time.perf_counter(),
                                     control=True)
    assert not result["correct"], check
