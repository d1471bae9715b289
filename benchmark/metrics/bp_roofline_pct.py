"""BP's least time on the H100's published peaks (``roofline.bp_work``:
every sample's own iterations over every edge, inputs and outputs moved
once) over the device time of every operation launched inside the
benchmark's ``bench.bp`` spans of the stage pass, in percent."""

from benchmark import roofline, trace


def read(run):
    stages = run.get("stages")
    if not stages or run["device"] != "cuda":
        return None
    events = stages["events"]
    ops = trace.launched_in(events, trace.device_ops(events), trace.spans(events, "bench.bp"))
    device_s = sum(e - s for _, s, e, _ in ops) * 1e-6
    if device_s <= 0:
        return None
    g = run["graph"]
    least = 0.0
    for w in stages["bp_work"]:
        moved, ops_n = roofline.bp_work(w["batch"], g["m"], g["n"], g["edges"],
                                        w["iterations_run"], w["syndrome_bytes"],
                                        w["prior_bytes"])
        least += roofline.bound_s(moved, ops_n)[0]
    return 100.0 * least / device_s
