"""What a profiled stretch of the task loop says: the device's busy time,
the kernels by name, and the device's idle gaps by what the task loop's
thread was doing in them. Reads the Chrome trace that
``torch.profiler`` exports (``cat``: ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` run on the device; ``user_annotation`` are the loop's
``bench:`` ranges; ``cuda_runtime`` the runtime calls)."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Entries kept in each list of the breakdown.
TOP = 10


def _timeline(ranges: List[Tuple[float, float, str]]) -> Tuple[List[float], List[str]]:
    """The innermost of possibly nested ranges at each instant, as sorted
    change points and the label from each on ("" where none is open)."""
    points = sorted([(a, 1, -b, name) for a, b, name in ranges]
                    + [(b, 0, 0.0, name) for a, b, name in ranges])
    stack: List[str] = []
    times, labels = [], []
    for t, opening, _, name in points:
        if opening:
            stack.append(name)
        elif name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()
        times.append(t)
        labels.append(stack[-1] if stack else "")
    return times, labels


def _at(timeline: Tuple[List[float], List[str]], t: float) -> str:
    times, labels = timeline
    i = bisect.bisect_right(times, t) - 1
    return labels[i] if i >= 0 else ""


def summarize(path: str) -> Dict:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, loop, runtime = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, a = e.get("cat"), float(e["ts"])
        span = (a, a + float(e["dur"]), e.get("name", ""))
        if cat in DEVICE_CATS:
            device.append(span)
        elif cat == "user_annotation" and span[2].startswith("bench:"):
            loop.append(span)
        elif cat == "cuda_runtime":
            runtime.append(span)
    device.sort()
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    merged: List[List[float]] = []
    for a, b, name in device:
        by_name[name][0] += 1
        by_name[name][1] += (b - a) / 1e6
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_s = sum(b - a for a, b in merged) / 1e6
    loop_at, runtime_at = _timeline(loop), _timeline(runtime)
    idle: Dict[str, float] = defaultdict(float)
    for (_, end), (start, _) in zip(merged[:-1], merged[1:]):
        mid = 0.5 * (end + start)
        where = _at(loop_at, mid)[len("bench:"):] or "outside the loop's ranges"
        call = _at(runtime_at, mid) or "no runtime call"
        idle[f"{where} / {call}"] += (start - end) / 1e6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "busy_s": busy_s,
        "kernels": {name: (int(n), s) for name, (n, s) in by_name.items()},
        "device_ops": [[name[:120], s] for name, (_, s) in top_ops],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:TOP],
    }
