# PhaseTimer copied from qldpc_tpu/utils/profiling.py; trace rewritten over torch.profiler.
"""Tracing / profiling helpers.

The reference's only instrumentation is ad-hoc ``time.time()`` prints
(paperResults_GPU.py:59,77,153-154). Here phase timers, throughput counters,
and ``torch.profiler`` traces are library features (SURVEY.md §5.1).

The engines mark their own work with ``span`` (``record_function``s named
``qldpc.<name>``, on the profiler's clock, which the device's operations
share, so that every idle stretch of a trace lies inside the span the host
was in) and count it with ``count`` inside each batch's ``batch`` scope.
Tracing is on exactly while a ``torch.profiler`` session collects (the
CLI's ``--trace DIR``); the counters are always on. ``counts()`` gives the
process's running totals over the batches of ``run_rate``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from pathlib import Path

import torch

__all__ = ["PhaseTimer", "batch", "count", "counts", "span", "trace"]


@dataclasses.dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase; supports nested use."""

    totals: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    counts: dict = dataclasses.field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "calls": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }

    def report(self) -> str:
        rows = [
            f"  {k:30s} {v['total_s']:9.3f}s  x{v['calls']:<6d} {v['mean_s']*1e3:9.2f} ms/call"
            for k, v in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"])
        ]
        return "phase timings:\n" + "\n".join(rows)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace context: the host and, where a card is
    present, the device, written as a Chrome trace (``trace.json``, open in
    chrome://tracing or Perfetto) into ``log_dir``. Exposed on the CLI as
    ``run <preset> --trace DIR``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))



_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` named ``qldpc.<name>`` while a profiler
    collects; otherwise a no-op context, at the cost of one check."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function("qldpc." + name)


class _Counts:
    """The process's counters: kept only while a batch scope is open."""

    def __init__(self):
        self.totals: dict = defaultdict(int)
        self.open = 0
        self.batches = 0


_COUNTS = _Counts()


def count(name: str, n: int = 1) -> None:
    """Add ``n``, a number the host already holds, to counter ``name`` if a
    batch is running; counts made outside a batch are dropped."""
    if _COUNTS.open:
        _COUNTS.totals[name] += n


def counts() -> dict:
    """The running totals of every counter over this process's batches, and
    ``batches``, the number of batch scopes closed."""
    return {**_COUNTS.totals, "batches": _COUNTS.batches}


@contextlib.contextmanager
def batch():
    """One batch of the Monte-Carlo loop: the ``qldpc.batch`` span and the
    scope in which ``count`` keeps its counts."""
    _COUNTS.open += 1
    try:
        with span("batch"):
            yield
    finally:
        _COUNTS.open -= 1
        if not _COUNTS.open:
            _COUNTS.batches += 1
