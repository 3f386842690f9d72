"""The port's demo CLI (``python -m diaglib_tpu_torch.demo``) on the CPU,
against the JAX package's demo.

Every subcommand runs at n = 120, as tests/test_demo.py runs the
reference's, and writes the reference's files.  For ``symm`` both demos
run with the same arguments: the dense oracle's lapack.txt is identical
(the same matrix, the same scipy call), and davidson.txt's eigenvalues
agree within 2e-6 and its printed eigenvector components within 1e-5
(two solves to tol 1e-8 from different random guesses, printed to 6
decimals).  Without a card the demo raises unless ``--device cpu`` is
given.
"""

import os
import re

import numpy as np
import pytest
import torch

from diaglib_tpu import demo as j_demo
from diaglib_tpu_torch import demo

FILES = {"symm": ["davidson.txt", "lapack.txt", "lobpcg.txt"],
         "geneig": ["davidson.txt", "lapack.txt", "lobpcg.txt"],
         "caslr": ["cashp.txt", "caslr.txt", "caslr_eff.txt", "lapack.txt"],
         "scflr": ["caslr.txt", "caslr_eff.txt", "lapack.txt"],
         "nonsym": ["nonsym.txt"]}
ARGS = ["--n=120", "--n-want=4", "--tol=1e-8"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU threads and XLA's contend in one process
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _read(path):
    """(eigenvalues, eigenvectors) of a result file."""
    eig, vecs, cur = [], [], None
    for ln in open(path).read().splitlines():
        m = re.match(r"\s+eigenvalue #\s+\d+:\s+(\S+)", ln)
        if m:
            eig.append(float(m.group(1)))
            cur = []
            vecs.append(cur)
        elif ln.strip() and "eigenvector" not in ln:
            cur += [float(v) for v in ln.split()]
    return np.array(eig), np.array(vecs)


@pytest.mark.parametrize("cmd", ["symm", "geneig", "caslr", "scflr",
                                 "nonsym"])
def test_demo_subcommand_on_the_cpu(tmp_path, cmd, capsys):
    extra = ["nonsym", "--side", "c", "--variant", "4"] if cmd == "nonsym" \
        else [cmd]
    demo.main(ARGS + ["--device", "cpu", "--out-dir", str(tmp_path)] + extra)
    out = capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == FILES[cmd]
    for f in FILES[cmd]:
        eig, vecs = _read(tmp_path / f)
        assert eig.shape == (4,) and vecs.shape[0] == 4
        assert np.all(vecs[:, 0] >= 0)          # the phase of component 1
    assert "operator applications" in out
    if cmd == "nonsym":
        err = float(re.search(r"max \|eig - dense\| over \d+ roots: (\S+)",
                              out).group(1))
    else:
        assert "converged: True" in out
        err = float(re.search(r"max \|eig - dense\| = (\S+)", out).group(1))
        assert "iter  root" in out
    assert err < 1e-6


def test_symm_against_the_reference_demo(tmp_path):
    ours, ref = tmp_path / "port", tmp_path / "jax"
    demo.main(ARGS + ["--device", "cpu", "--out-dir", str(ours), "symm"])
    j_demo.main(ARGS + ["--out-dir", str(ref), "symm"])
    lapack = (ours / "lapack.txt").read_text()
    assert lapack == (ref / "lapack.txt").read_text()
    e_t, v_t = _read(ours / "davidson.txt")
    e_j, v_j = _read(ref / "davidson.txt")
    np.testing.assert_allclose(e_t, e_j, rtol=0, atol=2e-6)
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=1e-5)


def test_demo_needs_a_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(ARGS + ["--out-dir", str(tmp_path), "symm"])
    assert not os.listdir(tmp_path)
