"""Runs one cell of the benchmark once: finds its configuration, traffic,
routes and metric readers by name, builds the inputs and the program's
operator, warms up, solves back to back for a window, optionally traces
a few solves, then judges a sample of the window's answers against the
plain reference.

Everything that belongs to one configuration, traffic mix, route or
metric lives in a file of its own under this folder, found by the name
``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the generator and its ``params``, the
  ``problem`` (the reference module), the solve settings and the limits of
  the comparison;
- ``traffic/<traffic>.json``: the ladder ``route``, the ``operator``
  route, roots, block and ladder settings;
- ``inputs/<generator>.py``, ``operators/<operator>.py``,
  ``routes/<route>.py``, ``reference/<problem>.py``;
- ``metrics/<metric>.py``: ``read(run)`` returns the metric or None.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import random
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import tracing

BENCH = Path(__file__).resolve().parent
TRACE_SOLVES = 3        # solves profiled in a --trace 1 run
KEEP = 8                # answers of the window judged, drawn from the seed
WINDOW_SPAN = "benchmark-window"
# the key of each kind of file under the benchmark's folder
KINDS = ("inputs", "operators", "routes", "reference", "metrics")


def derive(seed: int, *path: int) -> int:
    """A seed for one use of the run's seed (``path`` names the use)."""
    state = np.random.SeedSequence([seed % 2 ** 64, *path]).generate_state(
        1, np.uint64)
    return int(state[0]) % 2 ** 63


class Catalog:
    """The benchmark's files, by name: ``BENCHMARK.json`` (beside the
    folder unless ``spec_file`` names another) and the folder's
    configuration, traffic and module files."""

    def __init__(self, bench_dir=BENCH, spec_file=None):
        self.dir = Path(bench_dir)
        spec_file = spec_file or self.dir.parent / "BENCHMARK.json"
        self.spec = json.loads(Path(spec_file).read_text())
        self._modules = {}

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.dir / kind / f"{name}.json").read_text())

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def module(self, kind: str, name: str):
        if kind not in KINDS:
            raise ValueError(f"no kind of module {kind!r}")
        key = (kind, name)
        if key not in self._modules:
            path = self.dir / kind / f"{name}.py"
            if not path.is_file():
                raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
            mod_name = f"_bench_{kind}_" + "".join(
                c if c.isalnum() else "_" for c in name)
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def metrics(self, workload: str, trace: bool) -> list:
        """The metric entries a run of the cell reports: with ``trace`` the
        per-layer ones, else the end-to-end ones; an entry with a
        ``workloads`` key only in the cells it lists."""
        entries = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in entries
                if workload in m.get("workloads", [workload])]


@dataclasses.dataclass
class Solve:
    wall_s: float
    n_iter: int
    ok: bool


@dataclasses.dataclass
class Run:
    """What a metric reader reads: the cell's files, the set-up time, the
    window's solves and length, the peak device memory the window held
    (None off the card), the operators' shapes, the operator route's
    module and, in a traced run, the trace's summary (``trace``: busy_s,
    window_s, scopes {name: [count, host ms, device ms]}, by_kernel
    {short name: (count, ms)}, solves, kernels, idle)."""

    workload: dict
    config: dict
    traffic: dict
    shapes: dict
    setup_s: float
    window_s: float
    solves: list
    peak_bytes: int | None
    operator: object = None
    trace: dict | None = None
    rms_gap: float | None = None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_name_and_limit():
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def _read_trace(events, t_window, solves):
    t0, t1 = t_window
    _, _, host, _, top = tracing.scope_breakdown(events, tracing.SCOPES)
    by_kernel = {n: (c, t) for n, c, t in top}
    busy_s = tracing.busy_s(events, t0, t1)
    return {"busy_s": busy_s, "window_s": (t1 - t0) / 1e6, "scopes": host,
            "solves": solves, "by_kernel": by_kernel,
            "kernels": [[n, t / 1e3] for n, _, t in top[:10]],
            "idle": [[k, v] for k, v in tracing.idle_by_scope(
                events, tracing.SCOPES, t0, t1)[:10]]}


def own_rms(res, k: int):
    """The solver's own rms of each of the k roots when it stopped (the
    last finite row of its float64 stage's history), or None."""
    hist = getattr(res, "rms_history", None)
    if hist is None:
        return None
    hist = hist[:, :k]
    rows = torch.arange(hist.shape[0], device=hist.device)[:, None]
    last = torch.where(torch.isfinite(hist), rows, -1).amax(dim=0)
    cols = torch.arange(hist.shape[1], device=hist.device)
    return torch.where(last >= 0, hist[last.clamp(min=0), cols], math.nan)


def run_cell(catalog: Catalog, name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, wrap_solve=None,
             control: bool = False):
    """One run of cell ``name``: ``(result, check, run)``, the result's
    line as a dict (``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, and with ``trace`` ``breakdown``), the comparison's
    numbers with their limits, and the :class:`Run` the metrics read.
    ``t_start`` is the process's start on the host clock (set-up counts
    from it).  ``control`` puts the route's float32 path in the program's
    place (the control of the comparison).  ``wrap_solve``
    (tests only) wraps the timed path's solve."""
    device = torch.device(device)
    work = catalog.workload(name)
    cfg = catalog.config(work["config"])
    traffic = catalog.traffic(work["traffic"])
    gen_mod = catalog.module("inputs", cfg["generator"])
    inputs = gen_mod.make(cfg["params"], seed, device)
    op_mod = catalog.module("operators", traffic["operator"])
    ops = op_mod.build(inputs, traffic)
    # what the program keeps of the inputs is its own; the reference makes
    # them again once the program's state is freed
    del inputs
    route = catalog.module("routes", traffic["route"])
    solve = (route.build_float32 if control else route.build)(ops, traffic,
                                                              cfg)
    if wrap_solve is not None:
        solve = wrap_solve(solve)
    k = traffic["n_targ"]

    def one(index):
        g = torch.Generator(device=device).manual_seed(derive(seed, 1, index))
        t0 = time.perf_counter()
        res = solve(g)
        _sync(device)
        return res, Solve(time.perf_counter() - t0, int(res.n_iter),
                          bool(res.ok))

    # set-up: imports, kernels, inputs, the program's stores, one warm-up
    # solve (every kernel built, every step of a solve run once)
    warm = torch.Generator(device=device).manual_seed(derive(seed, 0))
    solve(warm)
    _sync(device)
    # what set-up made stays: the collector's full passes in the window
    # then scan only what the solves make
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    # the window's peak apart from set-up's (slicing's temporaries)
    setup_peak = None
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    pick = random.Random(derive(seed, 3))
    kept = []       # (index, eig, vecs, own rms), a reservoir of KEEP
    solves = []
    traced = None

    def keep(index, res):
        slot = index if index < KEEP else pick.randrange(index + 1)
        if slot < KEEP:
            item = (index, res.eig[:k].clone(), res.evec[:k].clone(),
                    own_rms(res, k))
            if len(kept) < KEEP:
                kept.append(item)
            else:
                kept[slot] = item

    t0 = time.perf_counter()
    if trace:
        from diaglib_tpu_torch import profiling

        with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
            with profiling.trace(tmp):
                with torch.profiler.record_function(WINDOW_SPAN):
                    for i in range(TRACE_SOLVES):
                        res, rec = one(i)
                        solves.append(rec)
                        keep(i, res)
            files = list(Path(tmp).glob("*.pt.trace.json"))
            if len(files) != 1:
                raise RuntimeError(f"the profiler wrote {files}")
            events = json.loads(files[0].read_text())["traceEvents"]
        traced = (events, list(solves))
    while time.perf_counter() - t0 < seconds:
        i = len(solves)
        res, rec = one(i)
        solves.append(rec)
        keep(i, res)
    window_s = time.perf_counter() - t0
    res = None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)

    run = Run(work, cfg, traffic, gen_mod.shapes(cfg["params"]), setup_s,
              window_s, solves, peak, op_mod)
    if traced is not None:
        events, tsolves = traced
        run.trace = _read_trace(events,
                                tracing.window_us(events, WINDOW_SPAN),
                                tsolves)
        del events, traced

    # the program's state goes before the reference runs
    del solve, ops
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    inputs = gen_mod.make(cfg["params"], seed, device)
    check, run.rms_gap = judge(catalog, cfg, inputs, kept, solves, k, seed)
    correct = passes(check)

    metrics = {}
    for m in catalog.metrics(name, trace):
        value = catalog.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(work["chips"]),
           "memory_peak_bytes": (None if peak is None
                                 else max(peak, setup_peak))}
    if device.type == "cuda":
        dev["card"] = card_name_and_limit()
    result = {"correct": correct, "attempted": len(solves),
              "failed": sum(not s.ok for s in solves), "metrics": metrics,
              "device": dev}
    if run.trace is not None and device.type == "cuda":
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["kernels"],
                               "idle_gaps": run.trace["idle"]}
    return result, check, run


def judge(catalog, cfg, inputs, kept, solves, k, seed) -> tuple:
    """The comparison that decides ``correct``: the plain reference's k
    lowest eigenvalues (float64, from the benchmark's own inputs),
    and each kept answer's numbers (``reference/<problem>.py::judge``),
    the largest of each over the answers, beside the configuration's
    limit; and the window's unconverged solves (limit 0).  Returns the
    check and a reading with no limit: the largest relative gap between
    the reference's rms of a returned pair and the solver's own, above
    it (a root locked early keeps improving after its own rms was
    taken, so below it)."""
    ref = catalog.module("reference", cfg["problem"])
    ref_eig, _ = ref.lowest(inputs, k, torch.float64, derive(seed, 2))
    worst = {}
    gaps = []
    for _, eig, vecs, own in kept:
        numbers = ref.judge(inputs, eig, vecs, ref_eig)
        each = numbers.pop("resid_rms_each")
        if own is not None:
            gaps.append(float(((each.to(own.device) - own) / own).max()))
        for key, v in numbers.items():
            v = v if v == v else float("inf")           # NaN fails
            worst[key] = max(worst.get(key, 0.0), v)
    check = {}
    for key, limit in cfg["limits"].items():
        check[key] = {"value": worst.get(key, float("inf")), "limit": limit}
    check["unconverged"] = {"value": sum(not s.ok for s in solves),
                            "limit": 0}
    check["answers_judged"] = {"value": len(kept), "limit": 1,
                               "at_least": True}
    return check, max(gaps) if gaps else None


def passes(check: dict) -> bool:
    """Every number within its limit (at most it, or at least it where
    the entry says ``at_least``)."""
    return all(c["value"] >= c["limit"] if c.get("at_least")
               else c["value"] <= c["limit"] for c in check.values())
