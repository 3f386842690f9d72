#!/usr/bin/env python3
"""Runs of one cell in turn, each a process of its own as the check makes
them, and the spread of each metric over them:

    python3 benchmark/sets.py --workload <name> --seconds 10 \
        --seeds 1 2 3 4 5 6 [--trace 0|1] [--out FILE]

Prints each run's result line (``--out`` keeps the lines, with each run's
standard error's last lines), then for each metric its values, median and
spread: the distance between the first and third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median.  Exits
1 if a run fails or is not correct.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from benchmark import stats  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    values, bad = {}, 0
    out = args.out.open("a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, str(ROOT / "benchmark" / "run.py"),
             "--workload", args.workload, "--seed", str(seed),
             "--seconds", str(args.seconds), "--trace", str(args.trace)],
            cwd=ROOT, capture_output=True, text=True)
        wall = time.perf_counter() - t0
        lines = p.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            result = None
        if p.returncode or result is None or not result["correct"]:
            bad += 1
            print(f"seed {seed}: exit {p.returncode}, "
                  f"{wall:.1f} s\n{p.stderr[-3000:]}", flush=True)
        summary = [ln for ln in p.stderr.splitlines()
                   if ln.startswith("setup ")]
        if summary:
            print(f"seed {seed}: {summary[-1]}", flush=True)
        if result is not None:
            for name, m in result["metrics"].items():
                values.setdefault(name, []).append(m["value"])
            print(json.dumps({"seed": seed, "process_s": round(wall, 1),
                              **result}), flush=True)
        if out:
            out.write(json.dumps({"workload": args.workload, "seed": seed,
                                  "trace": args.trace, "rc": p.returncode,
                                  "process_s": wall, "result": result,
                                  "stderr_tail": p.stderr[-2000:]}) + "\n")
            out.flush()
    for name, vs in values.items():
        line = {"metric": name, "n": len(vs),
                "median": statistics.median(vs), "values": vs}
        if len(vs) >= 2:
            line["spread"] = stats.spread(vs)
        print(json.dumps(line), flush=True)
    if out:
        out.close()
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
