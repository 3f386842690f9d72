"""The multi-card path on four NVIDIA GPUs: every fleet job of
``tests/torch_fleet.py`` under NCCL, one rank a card, held against the
same job under gloo on four CPU ranks (``torch_fleet.compare_fleet``; job
``routes`` holds each sharded solve captured against uncaptured on every
rank), the flagship's ladders job at a reduced n
(``torch_fleet.check_ladders``; its sharded ladders captured, their steps'
all-reduces and ring permutes replayed as CUDA graphs, against the
uncaptured route on every rank), and the refusals of NCCL requests the
machine cannot serve.

These tests need four cards and nvcc and skip elsewhere.  They import no
JAX:

    python -m pytest --noconftest tests/test_torch_multicard_cuda.py -q
"""

import os

import pytest
import torch

from diaglib_tpu_torch.parallel import mh_dryrun
from diaglib_tpu_torch.parallel.multihost import initialize
from tests import torch_fleet

pytestmark = pytest.mark.cuda
RANKS = 4


@pytest.fixture(scope="module")
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs NVIDIA GPUs (NCCL ranks run one a card)")
    if torch.cuda.device_count() < RANKS:
        pytest.skip(f"needs {RANKS} NVIDIA GPUs, this machine has "
                    f"{torch.cuda.device_count()}")
    return RANKS


@pytest.mark.parametrize("job", torch_fleet.MC_JOBS)
def test_job_under_nccl_matches_gloo(cards, job, tmp_path):
    runs = []
    for backend, device in (("gloo", "cpu"), ("nccl", None)):
        inp = torch_fleet.job_inputs(job, cards,
                                     workdir=str(tmp_path / backend))
        runs.append(mh_dryrun.run_fleet(torch_fleet.JOBS[job], inp, cards,
                                        backend, device,
                                        timeout=300 if device else None))
    assert torch_fleet.compare_fleet(job, *runs)


@pytest.fixture(scope="module")
def ladders(cards):
    """The flagship's job at n = 32768 (16 block rows a rank, the
    narrowest shard K3's rotations take), each sharded ladder also
    captured against uncaptured."""
    return mh_dryrun.run_fleet(
        torch_fleet.JOBS["ladders"],
        torch_fleet.ladder_inputs(32768, ("davidson", "lobpcg"), True,
                                  False), cards)[1]


def test_ladders_on_the_cards(ladders):
    """The sharded ladders' checks of phase (j2), K2, K3 and K6 launched
    on every rank and K5 in rank 0's unsharded ladders."""
    outs = ladders
    launches, k5 = torch_fleet.check_ladders("n=32768", outs, "test", True)
    for name in ("peel_rows", "sliced_wide_mm", "group_spmm"):
        assert launches[name] > 0, (name, launches)
    assert k5["sliced_spmm"] > 0 and launches["sliced_spmm"] == 0
    assert launches["sym_spmm"] == launches["bsr_spmm"] == 0


@pytest.mark.parametrize("name", ["davidson", "lobpcg"])
def test_sharded_ladders_captured_equal_uncaptured(ladders, name):
    """Each rank's sharded ladder on the captured route by default (its
    steps, their all-reduces and ring permutes replayed as CUDA graphs)
    against the uncaptured route: every returned tensor bit for bit and
    the same counts on every rank, the same K2 / K6 launches, every rank
    reading the same flags (one digest)."""
    outs = ladders
    assert all(o[f"{name}_routes"] == ["graphs"] for o in outs)
    digests = {o[f"{name}_compare"]["digest"] for o in outs}
    assert len(digests) == 1
    assert {o[f"{name}_digest"] for o in outs} == digests
    for o in outs:
        cmp = o[f"{name}_compare"]
        assert cmp["same"]
        assert cmp["counts"]["graphs"] == cmp["counts"]["eager"]
        assert cmp["counts"]["graphs"] == outs[0][f"{name}_compare"][
            "counts"]["graphs"]
        assert {s["route"] for s in cmp["solves"]["graphs"]} == {"graphs"}
        lc, lu = cmp["launches"]["graphs"], cmp["launches"]["eager"]
        for k in ("peel_rows", "group_spmm"):
            assert lc[k] > 0 and (cmp["reruns"] or lc[k] == lu[k])


def test_one_seed_builds_one_matrix_on_every_card(cards):
    """random_bsr_spd at the n = 32768 shape of the ladders test, built
    twice on each card: every build bit-equal (each rank of a fleet builds
    its own copy)."""
    from diaglib_tpu_torch.ops.bsr import random_bsr_spd

    want = None
    for card in range(cards):
        for _ in range(2):
            m = random_bsr_spd(32768, 512, 8, seed=0, dtype=torch.float32,
                               device=f"cuda:{card}")
            got = m.blocks_t.cpu()
            if want is None:
                want = got
            assert torch.equal(got, want), card
            del m, got


def test_more_ranks_than_cards_raises(cards):
    with pytest.raises(RuntimeError, match="need as many cards"):
        mh_dryrun.run_fleet("dryrun", {}, torch.cuda.device_count() + 1)


def test_local_rank_without_its_card_raises(cards, monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    with pytest.raises(RuntimeError, match="card"):
        initialize(world_size=1, rank=0)
    assert not torch.distributed.is_initialized()
    assert os.environ["LOCAL_RANK"] == str(torch.cuda.device_count())
