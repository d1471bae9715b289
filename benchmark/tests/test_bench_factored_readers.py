"""The readers of the factored elimination's loop: its two counters a batch
from a stubbed ``profiling.counts``, the device-idle ms inside its span on
the synthetic trace of ``test_bench_program_spans``, and their silence
where the program has neither (a program without the counters, as before
they were added, reports nothing rather than 0)."""

import pytest

from benchmark import harness
from benchmark.tests.test_bench_program_spans import _run

COUNTERS = ("factored_blocks_per_batch", "factored_lanes_per_batch")


def _read(name, run):
    return harness.reader(name)(run)


def test_counter_readers_divide_by_the_batches(monkeypatch):
    from qldpc_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counts", lambda: {
        "osd.factored_blocks": 36, "osd.factored_lanes": 9000, "batches": 2})
    assert [_read(n, {}) for n in COUNTERS] == [18.0, 4500.0]
    monkeypatch.setattr(profiling, "counts", lambda: {"host_syncs": 22, "batches": 1})
    assert [_read(n, {}) for n in COUNTERS] == [None, None]


def test_idle_reader_reads_the_factored_span():
    # [60, 78] a batch, the device busy 60-65 and 70-75 in it
    assert _read("factored_idle_ms", _run()) == pytest.approx(8.0)
    run = _run()
    run["idle"]["events"] = [e for e in run["idle"]["events"]
                             if e["name"] != "qldpc.osd.factored"]
    assert _read("factored_idle_ms", run) is None
    assert _read("factored_idle_ms", {"device": "cpu", "idle": _run()["idle"]}) is None
    assert _read("factored_idle_ms", {"device": "cuda"}) is None
