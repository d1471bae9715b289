"""The program's ``osd.k4g_lanes`` counter over its batches: the samples a
batch that OSD sends through the transform elimination (K4g) past the
factored column budget."""

from benchmark import program_trace


def read(run):
    return program_trace.counter_per_batch("osd.k4g_lanes")
