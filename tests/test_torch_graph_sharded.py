"""The sharded solves on the captured route's logic, over four gloo ranks
on the CPU.

On the card a ``sharding=`` solve over an NCCL group takes the captured
route: each step captured once a solve and replayed as a CUDA graph on
every rank, its all-reduces, all-gathers and ring permutes inside the
graphs.  The CPU has no capture, so the ranks here run the same steps
through the private ``utils.graphs._recording("unrolled")`` switch: the
captured route's fixed ortho passes and rare-branch reruns, called
directly.  One fleet of ``parallel.mh_dryrun.run_fleet`` (job
``routes`` of ``tests/torch_fleet.py``, on the inputs of job
``sharded_solvers``: n = 256 dense operators, n = 512 distributed BSR)
runs davidson, gen_david, lobpcg, caslr (algorithm 0),
caslr_eff, nonsym (side "c", host driver), davidson over
``dist_bsr_matvec`` and davidson_ladder (its float32 stage ended by the
stall bit) on the "unrolled" and the "eager" routes, and three of them
again with one-pass budgets, which force reruns.  Meanwhile this
process runs the JAX package's sharded solves on the conftest's 8-device
CPU mesh from the same inputs (the workers import no JAX).

Held: every returned tensor bit for bit between the routes on every rank;
``(ok, n_iter, n_matvec)`` equal to the eager sharded loop's before the
captured route took the sharded solves (pinned below, one torch thread a
rank); every rank's flag history the same, the ladder's stall bit with it;
forced reruns counted and
bit-equal; eigenvalues within 1e-10 of the JAX package's.  Also the route
rule (``utils.graphs._route``) with the group's backend stubbed, and the
collective inventory's counting of a capture and its replays on a
one-rank gloo group.
"""

import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from diaglib_tpu import SolverOptions as JOptions
from diaglib_tpu.ops import dist_bsr as jdb
from diaglib_tpu.ops.bsr import BSRMatrix as JBSRMatrix
from diaglib_tpu.parallel import VectorSharding as JVectorSharding
from diaglib_tpu.parallel import make_mesh
from diaglib_tpu.problems import dense_matvec as j_dense_matvec
from diaglib_tpu.problems import diag_precnd as j_diag_precnd
from diaglib_tpu.problems import lrprec_eff as j_lrprec_eff
from diaglib_tpu.problems import lrprec_std as j_lrprec_std
from diaglib_tpu.solvers import caslr as j_caslr
from diaglib_tpu.solvers import caslr_eff as j_caslr_eff
from diaglib_tpu.solvers import davidson as j_davidson
from diaglib_tpu.solvers import davidson_ladder as j_davidson_ladder
from diaglib_tpu.solvers import gen_david as j_gen_david
from diaglib_tpu.solvers import lobpcg as j_lobpcg
from diaglib_tpu.solvers import nonsym as j_nonsym
from diaglib_tpu_torch import profiling
from diaglib_tpu_torch.ops.bsr import bsr_diagonal, bsr_from_arrays
from diaglib_tpu_torch.parallel import VectorSharding, initialize, mh_dryrun
from diaglib_tpu_torch.utils import graphs
from tests import torch_fleet

# the job's solves but caslr algorithm 1, which adds ~10 s of gloo
# collectives to the fleet and nothing the other Casida solves do not run
SOLVES = tuple(s for s in torch_fleet.ROUTE_SOLVES if s != "caslr1")
SHORT = ("davidson", "bsr_davidson", "nonsym")
# (ok, n_iter, n_matvec) of each solve on the eager sharded loop of the
# tree before the sharded solves took the captured route (4 gloo ranks,
# one torch thread each)
PINNED = {"davidson": (True, 15, 112), "gen_david": (True, 9, 67),
          "lobpcg": (True, 13, 109), "caslr0": (True, 22, 652),
          "caslr_eff": (True, 22, 342),
          "nonsym": (True, 18, 69), "bsr_davidson": (True, 28, 224),
          # both stages, the float32 one ended by its stall bit (16 + 4),
          # as the unsharded ladder on one rank
          "davidson_ladder": (True, 20, 154)}


def _jax_solves(inp):
    """The JAX package's sharded solve of each of SOLVES on ``inp``: their
    eigenvalues."""
    sh = JVectorSharding(make_mesh())
    opts = JOptions(**inp["options"])
    a = jnp.asarray(inp["a"])
    mv, pc = j_dense_matvec(a), j_diag_precnd(jnp.diagonal(a))
    guess = jnp.asarray(inp["guess"])
    c = {k: jnp.asarray(v) for k, v in inp["casida"].items()}
    ops = [j_dense_matvec(c[k]) for k in ("apb", "amb", "spd", "smd")]
    cguess = jnp.asarray(inp["casida_guess"])
    ns = jnp.asarray(inp["nonsym"])
    b = inp["bsr"]
    jm = JBSRMatrix(*(jnp.asarray(b[k]) for k in ("blocks_t", "rows", "cols",
                                                  "row_start")),
                    n=int(b["n"]), block=int(b["block"]))
    bdiag = bsr_diagonal(bsr_from_arrays(b, device="cpu")).numpy()
    runs = {
        "davidson": lambda: j_davidson(mv, pc, guess, opts, sharding=sh),
        "gen_david": lambda: j_gen_david(
            mv, pc, j_dense_matvec(jnp.asarray(inp["s"])), guess, opts,
            sharding=sh),
        "lobpcg": lambda: j_lobpcg(mv, pc, guess, opts, sharding=sh),
        "caslr0": lambda: j_caslr(*ops, j_lrprec_std(c["aa"], c["sigma"]),
                                  cguess, opts, algorithm=0, sharding=sh),
        "caslr_eff": lambda: j_caslr_eff(
            *ops, j_lrprec_eff(c["aa"], c["sigma"]), cguess, opts,
            sharding=sh),
        "nonsym": lambda: j_nonsym(
            j_dense_matvec(ns), j_dense_matvec(ns.T),
            j_diag_precnd(jnp.diagonal(ns)),
            jnp.asarray(inp["nonsym_guess"]),
            JOptions(**inp["nonsym_options"]), side="c", sharding=sh,
            driver="host"),
        "bsr_davidson": lambda: j_davidson(
            jdb.dist_bsr_matvec(jdb.distribute_bsr(jm, 8), sh),
            j_diag_precnd(jnp.asarray(bdiag)), jnp.asarray(inp["bsr_guess"]),
            opts, sharding=sh),
        # unsharded: the JAX ladder takes its sharding from a jit'd guess
        "davidson_ladder": lambda: j_davidson_ladder(
            j_dense_matvec(a.astype(jnp.float32)),
            j_diag_precnd(jnp.diagonal(a).astype(jnp.float32)), mv, pc, guess,
            opts, lo_tol=torch_fleet.ROUTE_LO_TOL, lo_iter=35),
    }
    out = {}
    for name, run in runs.items():
        res = run()
        assert bool(res.ok), name
        out[name] = np.asarray(res.eig)
    return out


@pytest.fixture(scope="module")
def fleet():
    """The 4-rank gloo fleet of job ``routes`` (in a thread: the ranks are
    processes) beside the JAX package's solves in this process."""
    inp = dict(torch_fleet.job_inputs("routes", 4), solves=SOLVES)
    box = {}

    def run():
        try:
            # about twice the fleet's longest wall seen beside the other
            # test files on 6 workers (135 s; 46-77 s alone)
            box["outs"] = mh_dryrun.run_fleet(
                torch_fleet.JOBS["routes"], inp, num_processes=4,
                backend="gloo", device="cpu", timeout=270)[1]
        except BaseException as exc:       # re-raised in the test's thread
            box["error"] = exc

    worker = threading.Thread(target=run)
    worker.start()
    try:
        ref = _jax_solves(inp)
    finally:
        worker.join()
    if "error" in box:
        raise box["error"]
    return inp, box["outs"], ref


def _same(a, b, tag):
    assert a.keys() == b.keys()
    for k, v in a.items():
        if k in ("solves", "launches"):
            continue
        if isinstance(v, np.ndarray):
            assert np.array_equal(v, b[k]), (tag, k)
        else:
            assert v == b[k], (tag, k)


def test_the_routes_of_a_gloo_fleet(fleet):
    _, outs, _ = fleet
    assert all(o["routes"] == ("unrolled", "eager") for o in outs)
    for o in outs:
        for name in SOLVES:
            for route in ("unrolled", "eager"):
                assert {s["route"] for s in o[f"{route}:{name}"]["solves"]} \
                    == {route}


@pytest.mark.parametrize("name", SOLVES)
def test_unrolled_bit_equal_to_eager_on_every_rank(fleet, name):
    _, outs, _ = fleet
    for r, o in enumerate(outs):
        _same(o[f"unrolled:{name}"], o[f"eager:{name}"], (r, name))


@pytest.mark.parametrize("name", SOLVES)
def test_counts_pinned_to_the_eager_sharded_loop(fleet, name):
    _, outs, _ = fleet
    for o in outs:
        for route in ("unrolled", "eager"):
            got = o[f"{route}:{name}"]
            assert (got["ok"], got["n_iter"], got["n_matvec"]) == \
                PINNED[name], (route, name)
            assert got["ortho_ok"]
            # the all-reduced results: the same bits on every rank
            hist = got["eig_ranks"]
            assert all(np.array_equal(h, hist[0]) for h in hist[1:])


@pytest.mark.parametrize("name", SOLVES)
def test_flag_history_identical_on_every_rank(fleet, name):
    """Every rank reads the same flags in the same order, so every rank
    takes the same branches (and on the card replays the same graphs):
    one read an iteration and one a rerun, a branch step's close read
    besides."""
    _, outs, _ = fleet
    for route in ("unrolled", "eager"):
        hist = [[s["flag_history"] for s in o[f"{route}:{name}"]["solves"]]
                for o in outs]
        assert all(h == hist[0] for h in hist[1:]), (route, name)
        for s in outs[0][f"{route}:{name}"]["solves"]:
            assert len(s["flag_history"]) == s["flag_reads"]
            assert s["iterations"] + sum(s["reruns"].values()) <= \
                s["flag_reads"] <= s["iterations"] + \
                sum(s["reruns"].values()) + 1


def test_ladder_stall_read_alike_on_every_rank(fleet):
    """The sharded ladder's float32 stage ends by its stall bit, computed
    from all-reduced residuals: every rank reads it at the same iteration
    and ends the stage there, on both routes."""
    _, outs, _ = fleet
    for route in ("unrolled", "eager"):
        stages = [o[f"{route}:davidson_ladder"]["solves"] for o in outs]
        for lo, hi in stages:
            assert (lo["dtype"], lo["end"]) == ("float32", "stall")
            assert lo["iterations"] < 35
            assert lo["flag_history"][-1][4] == 1
            assert (hi["dtype"], hi["end"]) == ("float64", "tol")
        seen = [[(st["iterations"], st["end"], st["flag_history"])
                 for st in s] for s in stages]
        assert all(h == seen[0] for h in seen[1:]), route


@pytest.mark.parametrize("name", SHORT)
def test_forced_rerun_counted_and_bit_equal(fleet, name):
    """One-pass ortho budgets: the branch steps' loops fall short, each
    such step is run again uncaptured with the eager loops (on every rank
    at once), and the solve is the eager one bit for bit."""
    _, outs, _ = fleet
    for r, o in enumerate(outs):
        got = o[f"short:{name}"]
        _same(got, o[f"eager:{name}"], (r, name))
        reruns = sum(sum(s["reruns"].values()) for s in got["solves"])
        assert reruns > 0
        for s in got["solves"]:
            assert s["route"] == "unrolled"
            assert s["flag_reads"] >= s["iterations"] + \
                sum(s["reruns"].values())
    hist = [[s["flag_history"] for s in o[f"short:{name}"]["solves"]]
            for o in outs]
    assert all(h == hist[0] for h in hist[1:])


@pytest.mark.parametrize("name", SOLVES)
def test_eigenvalues_against_the_reference_sharded(fleet, name):
    inp, outs, ref = fleet
    k = (inp["nonsym_options"] if name == "nonsym" else
         inp["options"])["n_targ"]
    for o in outs:
        np.testing.assert_allclose(o[f"unrolled:{name}"]["eig"][:k],
                                   ref[name][:k], rtol=0, atol=1e-10)


def _stub(backend):
    return types.SimpleNamespace(backend=backend)


def test_route_rule_by_backend():
    """"graphs" on CUDA tensors with an NCCL sharding (or none), "eager"
    on a gloo group or CPU tensors; "graphs" asked for where nothing can
    be captured raises; "unrolled" runs anywhere.  The group's backend is
    stubbed: no card or group is needed."""
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert graphs._route(cuda, _stub("nccl")) == "graphs"
    assert graphs._route(cuda, None) == "graphs"
    assert graphs._route(cuda, _stub("gloo")) == "eager"
    assert graphs._route(cpu, _stub("nccl")) == "eager"
    assert graphs._route(cpu, None) == "eager"
    with graphs._recording("eager"):
        assert graphs._route(cuda, _stub("nccl")) == "eager"
    for dev, sh in ((cuda, _stub("gloo")), (cpu, _stub("nccl")),
                    (cpu, None)):
        with graphs._recording("graphs"):
            with pytest.raises(ValueError, match="captured route"):
                graphs._route(dev, sh)
        with graphs._recording("unrolled"):
            assert graphs._route(dev, sh) == "unrolled"


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, torn down after the test."""
    initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, backend="gloo")
    try:
        yield VectorSharding(8)
    finally:
        dist.destroy_process_group()


def test_inventory_counts_replays_not_captures(one_rank):
    """What a capture posts is recorded apart (a capture runs nothing)
    and counted again at each replay into every live inventory; a
    recording nested in another counts into both."""
    sh = one_rank
    t = torch.ones(3, dtype=torch.float64)
    real = (dist.all_reduce, dist.all_gather, dist.batch_isend_irecv)
    outer, inner, posted = {}, {}, {}
    with profiling._recording(outer):
        sh.sum(t)                       # a warm-up call: it runs
        with profiling._captured(posted):
            sh.sum(t)
            sh.max(t)
            sh.all_gather(t)
        with profiling._recording(inner):
            profiling._replayed(posted)
        profiling._replayed(posted)
    assert posted == {"all-reduce": {"count": 2, "bytes": 48},
                      "all-gather": {"count": 1, "bytes": 24}}
    assert inner == posted
    assert outer == {"all-reduce": {"count": 5, "bytes": 120},
                     "all-gather": {"count": 2, "bytes": 48}}
    # outside every recording nothing is patched or counted
    profiling._replayed(posted)
    assert (dist.all_reduce, dist.all_gather, dist.batch_isend_irecv) == real
    assert not profiling._LIVE and not profiling._patched.on


def test_keep_alive_holds_the_permuted_shards(fleet):
    """A ring permute under ``keep_alive`` keeps what it sends and
    receives (a captured step's graph reads them at every replay): on
    every rank, one permute an offset 1-3 keeps its sent and received
    shards, and offset 0 (4) moves and keeps nothing."""
    _, outs, _ = fleet
    for o in outs:
        assert o["kept"] == [((8, 64), "torch.float64")] * 6
        assert o["kept_after"] is None
