#!/usr/bin/env python3
"""The control of the comparison that decides ``correct``, on the card at
a cell's own size, one line a seed:

    python3 benchmark/control.py --workload <name> --seeds 11 12 13

For each seed: the cell run as ``run.py`` runs it, with the route's
float32 path in the program's place (the program's own lower-precision
path: a ladder's float32 stage alone, a solver over the float32 tier),
over a short window, and its numbers beside the
limits; then the plain reference itself computed in float32, judged the
same way.  Each comparison has to come out not correct: a line with
``"correct": true`` makes the script exit 1.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    catalog = harness.Catalog()
    work = catalog.workload(args.workload)
    cfg = catalog.config(work["config"])
    k = catalog.traffic(work["traffic"])["n_targ"]
    ref = catalog.module("reference", cfg["problem"])
    bad = 0
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, check, _ = harness.run_cell(catalog, args.workload, seed,
                                         args.seconds, False, "cuda:0", t0,
                                         control=True)
        line = {"seed": seed, "control": "float32 path",
                "correct": result["correct"],
                "attempted": result["attempted"],
                "check": {n: c["value"] for n, c in check.items()}}
        print(json.dumps(line), flush=True)
        bad += result["correct"]
        inputs = catalog.module("inputs", cfg["generator"]).make(
            cfg["params"], seed, "cuda:0")
        ref_eig, _ = ref.lowest(inputs, k, torch.float64,
                                harness.derive(seed, 2))
        eig, vecs = ref.lowest(inputs, k, torch.float32,
                               harness.derive(seed, 4))
        numbers = ref.judge(inputs, eig, vecs, ref_eig)
        numbers.pop("resid_rms_each")
        correct = harness.passes({n: {"value": v, "limit": cfg["limits"][n]}
                                  for n, v in numbers.items()})
        print(json.dumps({"seed": seed, "control": "float32 reference",
                          "correct": correct, "check": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
        bad += correct
        del inputs
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
