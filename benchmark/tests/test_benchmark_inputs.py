"""The generator gives the upstream test matrix, as the port builds it,
bit for bit."""

import pytest
import torch

from benchmark.inputs import hilbert_like
from diaglib_tpu_torch.problems import symm_matrix


def dense(a):
    """The block-sparse arrays assembled into one dense matrix."""
    n, B = a["n"], a["block"]
    d = torch.zeros((n, n), dtype=a["blocks_t"].dtype)
    for e in range(a["rows"].shape[0]):
        r, c = int(a["rows"][e]), int(a["cols"][e])
        d[r * B:(r + 1) * B, c * B:(c + 1) * B] = a["blocks_t"][e].T
    return d


@pytest.mark.parametrize("n, block", [(256, 32), (1024, 64), (192, 64),
                                      (128, 128)])
def test_hilbert_like_is_the_ports_symm_matrix(n, block):
    a = hilbert_like.build(n, block, device="cpu")
    assert a["blocks_t"].dtype == torch.float64
    assert torch.equal(dense(a), symm_matrix(n, device="cpu"))
    nbr = n // block
    assert a["rows"].tolist() == [r for r in range(nbr) for _ in range(nbr)]
    assert a["cols"].tolist() == list(range(nbr)) * nbr
    assert a["row_start"].tolist() == [r * nbr for r in range(nbr)]


def test_shapes_at_the_configurations_size():
    op = hilbert_like.shapes({"n": 32768, "block": 512})["a"]
    assert (op["stored_blocks"], op["distinct_blocks"]) == (4096, 2080)
    assert op["distinct_blocks"] * 512 ** 2 * 8 == 4362076160


def test_every_seed_the_same_inputs():
    p = {"n": 512, "block": 64}
    a = hilbert_like.make(p, 2 ** 33 + 1, "cpu")["a"]["blocks_t"]
    b = hilbert_like.make(p, 2 ** 33 + 2, "cpu")["a"]["blocks_t"]
    assert torch.equal(a, b)


def test_the_sources_guess_strategies():
    from types import SimpleNamespace

    from benchmark.routes import start

    ops = SimpleNamespace(n=64, device=torch.device("cpu"),
                          diagonal=torch.arange(64, 0, -1).double())
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(start({}, ops, 5, torch.float64, gen),
                       torch.zeros((5, 64), dtype=torch.float64))
    noisy = start({"guess": 6}, ops, 5, torch.float32, gen)
    unit = torch.eye(64).flip(0)[:5]
    noise = noisy - unit
    assert noisy.dtype == torch.float32
    assert float(noise.min()) >= 0 and float(noise.max()) < 0.01
    # the noise comes from the generator: the same seed, the same block
    first = start({"guess": 6}, ops, 5, torch.float32,
                  torch.Generator().manual_seed(4))
    again = start({"guess": 6}, ops, 5, torch.float32,
                  torch.Generator().manual_seed(4))
    assert torch.equal(first, again) and not torch.equal(first, noisy)
    with pytest.raises(ValueError):
        start({"guess": 1}, ops, 5, torch.float64, gen)
