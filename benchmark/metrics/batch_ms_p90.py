"""90th percentile of the ms between consecutive batch ends in the window
(the first from the window's start)."""

import numpy as np


def read(run):
    w = run["window"]
    ends = np.array([w["t0"]] + w["stamps"])
    if len(ends) < 11:
        return None
    return float(np.percentile(np.diff(ends) * 1e3, 90))
