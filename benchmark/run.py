#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the CUDA card:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the comparison's numbers with their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``check``.  Exits non-zero without a
result where there is no CUDA card (or fewer than the cell asks for), or
where ``jax``, ``jaxlib``, ``flax`` or ``diaglib_tpu`` was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that no run may load (compared whole:
# diaglib_tpu_torch is the program, diaglib_tpu the JAX package)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "diaglib_tpu"})


def forbidden_modules(modules) -> list:
    """The forbidden top-level names among module names."""
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)


def _number(v):
    return v if isinstance(v, int) or math.isfinite(v) else str(v)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    # one process, few threads: the host's thread pools stay at one thread
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"

    import torch

    torch.set_num_threads(1)

    from benchmark import harness

    catalog = harness.Catalog()
    chips = int(catalog.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: workload {args.workload} needs {chips} CUDA "
              f"card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the program: a checkout without it fails here
    import diaglib_tpu_torch  # noqa: F401

    result, check, run = harness.run_cell(catalog, args.workload, args.seed,
                                     args.seconds, bool(args.trace),
                                     "cuda:0", T_START)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 3
    result["check"] = {k: {"value": _number(c["value"]),
                           "limit": _number(c["limit"])}
                       for k, c in check.items()}
    print(f"setup {run.setup_s!r} s; window {run.window_s!r} s, "
          f"{len(run.solves)} solves; walls "
          f"{[round(s.wall_s, 4) for s in run.solves]}; iterations "
          f"{[s.n_iter for s in run.solves]}; the reference's rms against "
          f"the solver's own, largest relative excess {run.rms_gap!r}",
          file=sys.stderr)
    for k, c in check.items():
        rel = "at least" if c.get("at_least") else "at most"
        print(f"check {k} {c['value']!r} limit {rel} {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
