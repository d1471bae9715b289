"""Median host ms of the classify stage of a batch, ending in a synchronize,
over the traced stage pass."""

import statistics


def read(run):
    stages = run.get("stages")
    if not stages or not stages["ms"]["classify"]:
        return None
    return statistics.median(stages["ms"]["classify"])
