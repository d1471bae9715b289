"""The readers of the program's own spans and counters on a synthetic trace
of two batches and a stubbed ``profiling.counts``; and their silence where
the program has neither."""

import pytest

from benchmark import harness

IDLE = ("sample_idle_ms", "bp_idle_ms", "osd_idle_ms", "classify_idle_ms", "loop_idle_ms")
COUNTERS = ("host_syncs_per_batch", "k4g_lanes_per_batch")
MS = 1000.0  # trace times are microseconds


def _span(name, lo, hi):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": lo * MS,
            "dur": (hi - lo) * MS}


def _kernel(lo, hi):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": lo * MS, "dur": (hi - lo) * MS,
            "args": {}}


def _batch(t0, extra_kernels=()):
    """One batch of 100 ms at t0: key 10, sample 30, bp 20, osd 20, classify
    10, counters 10; device-idle ms key 10, sample 7, bp 0, osd 10, classify
    10 (less what ``extra_kernels`` fill), counters 5."""
    spans = [("qldpc.batch", 0, 100), ("qldpc.key", 0, 10), ("qldpc.sample", 10, 40),
             ("qldpc.sample.priors", 10, 30), ("bench.sample", 10, 40), ("qldpc.bp", 40, 60),
             ("qldpc.osd", 60, 80), ("qldpc.osd.factored", 60, 78),
             ("qldpc.classify", 80, 90), ("qldpc.counters", 90, 100)]
    kernels = [(12, 35), (40, 55), (55, 65), (70, 75), (95, 100), *extra_kernels]
    return ([_span(n, t0 + a, t0 + b) for n, a, b in spans]
            + [_kernel(t0 + a, t0 + b) for a, b in kernels])


def _run():
    events = ([_span("bench.window", 0, 200)] + _batch(0) + _batch(100, [(85, 88)])
              + [_span("qldpc.sample", 300, 310)])  # outside the window: not read
    return {"device": "cuda", "idle": {"events": events, "lo": 0.0, "hi": 200.0 * MS}}


def _read(name, run):
    return harness.reader(name)(run)


def test_idle_readers_give_each_span_s_idle_ms_a_batch():
    run = _run()
    got = {name: _read(name, run) for name in IDLE}
    assert got == pytest.approx({"sample_idle_ms": 7.0, "bp_idle_ms": 0.0,
                                 "osd_idle_ms": 10.0, "classify_idle_ms": 8.5,
                                 "loop_idle_ms": 15.0})
    # batches that tile the window: the five add up to the window's idle
    window_idle_ms = _read("device_idle_pct", run) / 100 * 200.0
    assert sum(got.values()) * 2 == pytest.approx(window_idle_ms)


def test_counter_readers_divide_by_the_batches(monkeypatch):
    from qldpc_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counts",
                        lambda: {"host_syncs": 44, "osd.k4g_lanes": 3, "batches": 2})
    assert [_read(n, {}) for n in COUNTERS] == [22.0, 1.5]
    monkeypatch.setattr(profiling, "counts", lambda: {"host_syncs": 22, "batches": 1})
    assert [_read(n, {}) for n in COUNTERS] == [22.0, 0.0]
    monkeypatch.setattr(profiling, "counts", lambda: {"batches": 0})
    assert [_read(n, {}) for n in COUNTERS] == [None, None]


def test_every_reader_is_silent_without_the_program_s_spans_and_counters(monkeypatch):
    from qldpc_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counts")
    run = _run()
    run["idle"]["events"] = [e for e in run["idle"]["events"]
                             if not e["name"].startswith("qldpc.")]
    assert [_read(n, run) for n in IDLE + COUNTERS] == [None] * 7
    assert all(_read(n, {"device": "cpu", "idle": _run()["idle"]}) is None for n in IDLE)
