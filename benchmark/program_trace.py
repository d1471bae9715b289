"""The program's own spans and counters in a run: device-idle time a batch
inside the spans ``qldpc_tpu_torch.utils.profiling.span`` opens (named
``qldpc.<name>``), over the profiled whole batches of ``run_rate``, and the
program's counters a batch (``profiling.counts()``).

Each reader returns ``None`` where the program has no such span or counter.
"""

from __future__ import annotations

from benchmark import trace

BATCH = "qldpc.batch"
STAGES = ("qldpc.sample", "qldpc.bp", "qldpc.osd", "qldpc.classify")


def _traced(run):
    """(events, device operations, lo, hi, batch spans) of the profiled
    whole batches, or None off the card or without the program's spans."""
    idle = run.get("idle")
    if not idle or run["device"] != "cuda":
        return None
    events, lo, hi = idle["events"], idle["lo"], idle["hi"]
    batches = _within(trace.spans(events, BATCH), lo, hi)
    if not batches:
        return None
    return events, trace.device_ops(events), lo, hi, batches


def _within(spans, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(s, e) for s, e in spans if s >= lo and e <= hi]


def _idle_us(events, ops, lo: float, hi: float, names) -> float:
    """Microseconds inside the spans ``names`` in [lo, hi] in which no device
    operation ran."""
    return sum((e - s) - trace.busy(ops, s, e)
               for name in names for s, e in _within(trace.spans(events, name), lo, hi))


def idle_ms_per_batch(run, name: str) -> float | None:
    """Device-idle ms a batch inside the program's spans called ``name``."""
    got = _traced(run)
    if got is None:
        return None
    events, ops, lo, hi, batches = got
    return 1e-3 * _idle_us(events, ops, lo, hi, [name]) / len(batches)


def loop_idle_ms_per_batch(run) -> float | None:
    """Device-idle ms a batch inside ``qldpc.batch`` and outside the four
    stage spans: the batch key and the counters."""
    got = _traced(run)
    if got is None:
        return None
    events, ops, lo, hi, batches = got
    idle = _idle_us(events, ops, lo, hi, [BATCH]) - _idle_us(events, ops, lo, hi, STAGES)
    return 1e-3 * idle / len(batches)


def counter_per_batch(name: str) -> float | None:
    """The program's counter ``name`` over its batches (``run_rate``'s
    batches of this process: warm-up, window and traced pass)."""
    try:
        from qldpc_tpu_torch.utils.profiling import counts
    except ImportError:
        return None
    totals = counts()
    if not totals.get("batches"):
        return None
    return totals.get(name, 0) / totals["batches"]
