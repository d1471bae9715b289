"""The space-time cell ``st144_t12_p004`` as committed: its configuration
runs the real [[144,12,12]] T = 12 problem against the reference on the
CPU, it reports the accepted per-layer metrics of the layers it runs, and
its three own metrics read the engine's ``osd_invocations`` over the
window and the ``qldpc.sample.detectors`` and ``qldpc.classify.fold``
spans, or nothing where those are absent."""

from collections import namedtuple

import pytest
import torch

from benchmark import check, harness, roofline
from benchmark.tests import test_bench_metrics
from benchmark.tests.tiny import SEED

CELL = "st144_t12_p004"
SPANS = {"detectors_idle_ms": "qldpc.sample.detectors", "fold_idle_ms": "qldpc.classify.fold"}
NEW = ("osd_lanes_per_batch", *SPANS)
MS = 1000.0  # trace times are microseconds


def _read(name, run):
    return harness.reader(name)(run)


def test_the_committed_cell_is_correct_on_the_cpu():
    cell = harness.load_cell(CELL)
    assert cell.config["code"]["n"] == 144 and cell.config["spec"]["n_rounds"] == 12
    names = [m["name"] for m in cell.per_layer]
    assert names[-len(NEW):] == list(NEW)
    assert {"bp_ms", "bp_roofline_pct", "osd_idle_ms", "host_syncs_per_batch"} <= set(names)
    assert "k4g_lanes_per_batch" not in names  # the DEM's route past the factored budget
    cell.config["spec"]["batch_size"] = 32
    cell.traffic = dict(cell.traffic, check={"drawn": 1, "within_first": 2})
    res = harness.run(cell, SEED, 0.3, False, device="cpu", log=lambda msg: None)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and set(res["metrics"]) == {"trials_per_s", "setup_s"}


def _event(cat, name, lo, hi):
    return {"ph": "X", "cat": cat, "name": name, "ts": lo * MS, "dur": (hi - lo) * MS,
            "args": {}}


def _traced(with_spans=True):
    """Two batches of 100 ms; in each the detectors span 20-30 with the
    device busy 20-24, the fold span 80-90 with the device busy 80-89."""
    events = [_event("user_annotation", "bench.window", 0, 200)]
    for t0 in (0, 100):
        spans = [("qldpc.batch", 0, 100), ("qldpc.sample", 10, 40), ("qldpc.classify", 80, 90)]
        if with_spans:
            spans += [("qldpc.sample.detectors", 20, 30), ("qldpc.classify.fold", 80, 90)]
        events += [_event("user_annotation", n, t0 + a, t0 + b) for n, a, b in spans]
        events += [_event("kernel", "k", t0 + a, t0 + b) for a, b in ((20, 24), (80, 89))]
    return {"device": "cuda", "idle": {"events": events, "lo": 0.0, "hi": 200.0 * MS}}


def test_span_readers_read_a_planted_trace():
    run = _traced()
    assert _read("detectors_idle_ms", run) == pytest.approx(6.0)
    assert _read("fold_idle_ms", run) == pytest.approx(1.0)


@pytest.mark.parametrize("name", list(SPANS))
def test_span_readers_are_silent_without_their_span_or_the_card(name):
    assert _read(name, _traced(with_spans=False)) is None
    assert _read(name, dict(_traced(), device="cpu")) is None
    assert _read(name, {"device": "cuda", "idle": None}) is None


Totals = namedtuple("Totals", "trials osd_invocations")


def _window(lanes):
    """Three batches of 64; the running totals kept after batch 1 and the
    closing batch 2, as ``harness.window`` keeps them."""
    totals = {1: Totals(torch.tensor(128), torch.tensor(lanes - 5)),
              2: Totals(torch.tensor(192), torch.tensor(lanes))}
    return {"t0": 0.0, "stamps": [1.0, 2.0, 3.0], "totals": totals, "batch": 64}


def test_osd_lanes_reader_reads_the_closing_total():
    assert _read("osd_lanes_per_batch", {"device": "cuda", "window": _window(606)}) == 202.0
    assert _read("osd_lanes_per_batch", {"device": "cpu", "window": _window(606)}) is None
    empty = {"t0": 0.0, "stamps": [], "totals": {}, "batch": 64}
    assert _read("osd_lanes_per_batch", {"device": "cuda", "window": empty}) is None


def test_bp_roofline_reads_the_cells_h_st_graph():
    """K6's work on the committed cell's H_st (864 x 2,592, 6,840 edges)
    over the device time inside ``bench.bp`` (70 us on the planted trace)."""
    cell = harness.load_cell(CELL)
    ref = check.Reference(cell.config, float(cell.traffic["p"]))
    graph = {"m": ref.m, "n": ref.n, "edges": ref.edges}
    assert graph == {"m": 864, "n": 2592, "edges": 6840}
    work = [{"batch": 16384, "iterations_run": 16384 * 3, "syndrome_bytes": 16384 * 864,
             "prior_bytes": 2592 * 4}]
    run = {"device": "cuda", "graph": graph,
           "stages": {"events": test_bench_metrics._events(), "bp_work": work}}
    moved, ops = roofline.bp_work(16384, 864, 2592, 6840, 16384 * 3, 16384 * 864, 2592 * 4)
    want = 100 * roofline.bound_s(moved, ops)[0] / 70e-6
    assert _read("bp_roofline_pct", run) == pytest.approx(want)
