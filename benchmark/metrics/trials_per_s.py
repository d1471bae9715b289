"""Trials of every batch completed in the window over the window's seconds
(from its start to the end of its last batch, counters on the host)."""


def read(run):
    w = run["window"]
    if not w["stamps"]:
        return None
    return w["batch"] * len(w["stamps"]) / (w["stamps"][-1] - w["t0"])
