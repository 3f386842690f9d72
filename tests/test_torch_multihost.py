"""The process-spanning names of ``parallel.multihost`` that the solvers
do not call: ``global_mesh``, ``global_sharding`` and ``make_replicated``
(with ``make_global`` beside them), on 4 gloo ranks on the CPU (job
``mesh`` of ``tests/torch_fleet.py``, run by
``parallel.mh_dryrun.run_fleet``).  The world group, a
``VectorSharding`` of the length, and the caller's array are what each
must give, exactly."""

import numpy as np
import pytest

from diaglib_tpu_torch.parallel import mh_dryrun
from tests import torch_fleet

RANKS = 4


@pytest.fixture(scope="module")
def fleet():
    inp = torch_fleet.job_inputs("mesh", RANKS)
    _, outs = mh_dryrun.run_fleet(torch_fleet.JOBS["mesh"], inp,
                                  num_processes=RANKS, backend="gloo",
                                  device="cpu", timeout=120)
    return inp["x"], outs


def test_global_mesh_is_the_world_group(fleet):
    _, outs = fleet
    for out in outs:
        assert out["mesh_is_world"] and out["other_axis_refused"]


def test_global_sharding_is_a_vector_sharding_of_the_length(fleet):
    x, outs = fleet
    n = x.shape[1]
    for r, out in enumerate(outs):
        assert out["sharding_is_vector_sharding"]
        assert out["sharding"] == {"n": n, "size": RANKS, "rank": r,
                                   "n_local": n // RANKS,
                                   "lo": r * n // RANKS}


def test_make_replicated_is_a_full_copy_on_every_rank(fleet):
    x, outs = fleet
    for r, out in enumerate(outs):
        assert out["replicated_device"] == "cpu" and out["copies_equal"]
        np.testing.assert_array_equal(out["replicated"], x)
        k = x.shape[1] // RANKS
        np.testing.assert_array_equal(out["shard"], x[:, r * k:(r + 1) * k])
