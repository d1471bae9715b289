"""Median host ms of the sample stage of a batch, ending in a synchronize,
over the traced stage pass."""

import statistics


def read(run):
    stages = run.get("stages")
    if not stages or not stages["ms"]["sample"]:
        return None
    return statistics.median(stages["ms"]["sample"])
