"""The program's ``host_syncs`` counter over its batches: the operations a
batch that make the host wait for the device."""

from benchmark import program_trace


def read(run):
    return program_trace.counter_per_batch("host_syncs")
