"""Reading a torch.profiler Chrome trace: device operations, the host spans
that launched them, the union of device busy time, and the idle gaps.

Times in the trace are microseconds on one clock for host and device.
"""

from __future__ import annotations

import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def load(path) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def device_ops(events) -> list[tuple[str, float, float, object]]:
    """(name, start, end, correlation) of every device operation."""
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("args", {}).get("correlation"))
            for e in events if e.get("cat") in DEVICE_CATS]


def spans(events, name: str) -> list[tuple[float, float]]:
    """(start, end) of each host span (``record_function``) called ``name``."""
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation" and e["name"] == name]


def merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy(ops, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which some device operation ran."""
    return sum(e - s for s, e in merge(clip([(s, e) for _, s, e, _ in ops], lo, hi)))


def gaps(ops, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of [lo, hi], longest first."""
    out, t = [], lo
    for s, e in merge(clip([(s, e) for _, s, e, _ in ops], lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return sorted(out, key=lambda g: g[0] - g[1])


def launched_in(events, ops, windows) -> list[tuple[str, float, float, object]]:
    """The device operations launched inside any of the host ``windows``:
    by the launch call that shares an operation's correlation id, or, where
    the trace has none, by the operation's start."""
    launch = {e.get("args", {}).get("correlation"): float(e["ts"])
              for e in events if e.get("cat") in LAUNCH_CATS}
    launch.pop(None, None)

    def inside(t):
        return any(s <= t <= e for s, e in windows)

    return [op for op in ops if inside(launch.get(op[3], op[1]))]


def by_name(ops, lo: float, hi: float) -> list[tuple[str, float]]:
    """Device seconds by operation name inside [lo, hi], most first."""
    total: dict[str, float] = defaultdict(float)
    for name, s, e, _ in ops:
        for a, b in clip([(s, e)], lo, hi):
            total[name] += (b - a) * 1e-6
    return sorted(total.items(), key=lambda kv: -kv[1])


def host_at(events, t: float) -> str:
    """What the host was doing at ``t``: the innermost benchmark span and the
    innermost operation or call around it, as ``span/op``."""
    around = [e for e in events if e.get("cat") in HOST_CATS
              and float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]
    span = [e for e in around if e.get("cat") == "user_annotation"]
    op = [e for e in around if e.get("cat") != "user_annotation"]
    inner = lambda es: min(es, key=lambda e: float(e["dur"]))["name"] if es else ""
    return "/".join(x for x in (inner(span), inner(op)) if x) or "host idle"
