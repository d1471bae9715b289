"""The metric arithmetic on synthetic input."""

import json

import pytest

from benchmark import harness, roofline, trace


def _read(name, run):
    return harness.reader(name)(run)


def test_trials_per_s_counts_every_batch_over_the_whole_window():
    run = {"window": {"t0": 10.0, "stamps": [10.5, 11.0, 12.0, 12.5], "batch": 1000}}
    assert _read("trials_per_s", run) == pytest.approx(4000 / 2.5)


def test_batch_ms_p90_reads_the_gaps_between_batch_ends():
    stamps = [0.01 * (i + 1) for i in range(19)] + [0.19 + 0.1]
    run = {"window": {"t0": 0.0, "stamps": stamps, "batch": 1}}
    # 19 gaps of 10 ms and one of 100 ms: the 90th percentile is 10 ms
    assert _read("batch_ms_p90", run) == pytest.approx(10.0)
    assert _read("batch_ms_p90", {"window": {"t0": 0.0, "stamps": [1.0], "batch": 1}}) is None


def test_stage_medians_and_their_absence():
    run = {"stages": {"ms": {"sample": [3.0, 1.0, 2.0], "bp": [5.0], "osd": [1.0, 9.0],
                             "classify": [4.0, 4.0, 1.0]}}}
    assert [_read(f"{s}_ms", run) for s in ("sample", "bp", "osd", "classify")] == \
        [2.0, 5.0, 5.0, 4.0]
    assert _read("bp_ms", {"stages": None}) is None


def _events():
    """Two spans of a host thread; kernels launched inside and outside them."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.bp", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.osd", "ts": 100, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 10, "dur": 2,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 20, "dur": 2,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110, "dur": 2,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "k3", "ts": 15, "dur": 40,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k3", "ts": 50, "dur": 30,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "osd", "ts": 105, "dur": 10,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 150, "dur": 10,
         "args": {}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 120, "dur": 25},
    ]
    return ev


def test_union_busy_time_and_idle_gaps():
    ops = trace.device_ops(_events())
    # kernels 15-55 and 50-80 overlap: union 15-80, then 105-115, 150-160
    assert trace.busy(ops, 0, 200) == pytest.approx(65 + 10 + 10)
    assert trace.busy(ops, 20, 110) == pytest.approx(60 + 5)
    gaps = trace.gaps(ops, 0, 200)
    assert gaps[0] == (160, 200) and (115, 150) in gaps and (0, 15) in gaps
    assert trace.host_at(_events(), 130) == "bench.osd/aten::nonzero"


def test_device_idle_pct_is_one_less_the_union():
    run = {"device": "cuda", "idle": {"events": _events(), "lo": 0.0, "hi": 200.0}}
    assert _read("device_idle_pct", run) == pytest.approx(100 * (1 - 85 / 200))


def test_operations_are_attributed_to_the_span_that_launched_them():
    ev = _events()
    inside = trace.launched_in(ev, trace.device_ops(ev), trace.spans(ev, "bench.bp"))
    assert sorted(op[3] for op in inside) == [1, 2]
    assert trace.by_name(trace.device_ops(ev), 0, 200)[0] == ("k3", pytest.approx(70e-6))


def test_trace_reads_a_chrome_trace_file(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events() + [{"ph": "i", "name": "x"}]}))
    assert len(trace.load(path)) == len(_events())


def test_bp_bound_matches_the_dem_batch():
    # the [[144]] DEM: 1,728 x 66,981, 447,948 edges, 1,024 samples of 50 iterations
    moved, ops = roofline.bp_work(1024, 1728, 66981, 447948, 1024 * 50, 1024 * 1728,
                                  66981 * 4)
    t, by = roofline.bound_s(moved, ops)
    assert by == "operations" and t * 1e3 == pytest.approx(3.4235, abs=1e-3)
    # code capacity at p = 0.01 is bound by bytes
    moved, ops = roofline.bp_work(65536, 72, 144, 432, 65536, 65536 * 72, 144 * 4)
    assert roofline.bound_s(moved, ops)[1] == "bytes"


def test_bp_roofline_pct_over_the_bp_spans_device_time():
    ev = _events()
    work = [{"batch": 1, "iterations_run": 67, "syndrome_bytes": 0, "prior_bytes": 0}]
    run = {"device": "cuda", "graph": {"m": 1, "n": 1, "edges": 1},
           "stages": {"events": ev, "bp_work": work}}
    moved, ops = roofline.bp_work(1, 1, 1, 1, 67, 0, 0)
    least = roofline.bound_s(moved, ops)[0]
    assert _read("bp_roofline_pct", run) == pytest.approx(100 * least / 70e-6)
    assert _read("bp_roofline_pct", dict(run, device="cpu")) is None


def test_peak_mem_gib():
    assert _read("peak_mem_gib", {"peak_window_bytes": 3 * 2**30}) == 3.0
    assert _read("peak_mem_gib", {"peak_window_bytes": None}) is None


def test_checked_batches_are_drawn_from_the_seed():
    traffic = {"check": {"drawn": 3, "within_first": 48}}
    a = harness.draw_checked(2**33 + 1, traffic)
    assert a == harness.draw_checked(2**33 + 1, traffic) and len(set(a)) == 3
    assert all(0 <= b < 48 for b in a)
