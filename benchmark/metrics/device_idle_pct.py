"""Share of the profiled window of whole ``run_rate`` batches in which no
device operation runs (one less the union of their intervals), in percent."""

from benchmark import trace


def read(run):
    idle = run.get("idle")
    if not idle or run["device"] != "cuda":
        return None
    ops = trace.device_ops(idle["events"])
    span = idle["hi"] - idle["lo"]
    return 100.0 * (1.0 - trace.busy(ops, idle["lo"], idle["hi"]) / span)
