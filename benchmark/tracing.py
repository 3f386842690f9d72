"""Reading a torch.profiler Chrome trace of the solves: device busy time,
the host and device time under each solver scope, kernels by name and the
device's idle gaps by what the host was doing.

``scope_breakdown`` and ``short_names`` are frozen copies of
``chip_smoke.py``'s, so that a change to the program cannot change how its
trace is read.  A kernel belongs to the scope whose host interval holds
its launch (the runtime call with the same correlation id); a kernel of a
replayed CUDA graph carries its graph launch's correlation id.
"""

from __future__ import annotations

import bisect
import math
import re

SCOPES = ("matvec", "rayleigh-ritz", "expand-ortho")


def short_names(names):
    """Device kernel names without namespaces, template and function
    arguments."""
    out = []
    for n in names:
        head = re.split(r"[<(]", n.replace("(anonymous namespace)", ""), 1)[0]
        words = head.split("::")[-1].split()
        out.append(words[-1] if words else n)
    return out


def scope_breakdown(trace_events, scopes):
    """From a Chrome trace of torch.profiler: the device's busy ms (the
    union of its kernels, copies and fills); the number of kernels; for
    each scope name, (count, host ms under it, device ms of the kernels
    launched under it); the device ms of kernels launched outside every
    scope; and the kernels' (short name, count, ms), largest first."""
    launch = {}
    spans = []
    kernels = []
    work = []
    for e in trace_events:
        cat = e.get("cat", "")
        if (cat in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})):
            launch[e["args"]["correlation"]] = e["ts"]
        elif cat == "user_annotation" and e.get("name") in scopes:
            spans.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        if cat == "kernel":
            kernels.append(e)
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            work.append((e["ts"], e["ts"] + e["dur"]))
    busy, end = 0.0, -math.inf
    for lo, hi in sorted(work):                # the union of the intervals
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    spans.sort()
    starts = [sp[0] for sp in spans]
    host = {k: [0, 0.0, 0.0] for k in scopes}
    for lo, hi, name in spans:
        host[name][0] += 1
        host[name][1] += (hi - lo) / 1e3
    outside = 0.0
    by_name = {}
    for k in kernels:
        ms = k["dur"] / 1e3
        nm = short_names([k["name"]])[0]
        cnt, tot = by_name.get(nm, (0, 0.0))
        by_name[nm] = (cnt + 1, tot + ms)
        t = launch.get(k.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= spans[i][1]:
            host[spans[i][2]][2] += ms
        else:
            outside += ms
    top = sorted(((n, c, t) for n, (c, t) in by_name.items()),
                 key=lambda r: -r[2])
    return busy / 1e3, len(kernels), host, outside, top


def idle_by_scope(trace_events, scopes, t0_us: float, t1_us: float):
    """The device's idle time between t0_us and t1_us (trace clock), split
    by the host scope that was open while it lasted ("outside" where
    none was): ``[(scope, seconds)]``, largest first."""
    work = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace_events
                  if e.get("cat", "") in ("kernel", "gpu_memcpy",
                                           "gpu_memset"))
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                   for e in trace_events
                   if e.get("cat", "") == "user_annotation"
                   and e.get("name") in scopes)
    ends = [s[1] for s in spans]
    out = {}

    def add(name, us):
        out[name] = out.get(name, 0.0) + us / 1e6

    end = t0_us
    for lo, hi in work + [(t1_us, t1_us)]:
        lo, hi = max(lo, t0_us), min(hi, t1_us)
        if lo > end:                        # the gap [end, lo)
            covered = 0.0
            i = bisect.bisect_right(ends, end)
            while i < len(spans) and spans[i][0] < lo:
                part = min(lo, spans[i][1]) - max(end, spans[i][0])
                if part > 0:
                    add(spans[i][2], part)
                    covered += part
                i += 1
            if lo - end > covered:
                add("outside", lo - end - covered)
        end = max(end, hi)
    return sorted(out.items(), key=lambda kv: -kv[1])


def window_us(trace_events, marker: str):
    """(start, end) on the trace clock of the host span named marker."""
    for e in trace_events:
        if e.get("cat", "") == "user_annotation" and e.get("name") == marker:
            return e["ts"], e["ts"] + e["dur"]
    raise ValueError(f"the trace holds no span {marker!r}")


def busy_s(trace_events, t0_us: float, t1_us: float) -> float:
    """Seconds between t0_us and t1_us in which the device ran a kernel,
    a copy or a fill (the union of their intervals)."""
    busy, end = 0.0, t0_us
    for lo, hi in sorted((e["ts"], e["ts"] + e["dur"]) for e in trace_events
                         if e.get("cat", "") in ("kernel", "gpu_memcpy",
                                                  "gpu_memset")):
        lo, hi = max(lo, end), min(hi, t1_us)
        if hi > lo:
            busy += hi - lo
            end = hi
    return busy / 1e6
