"""Device-idle ms a batch while the host was inside the program's
``qldpc.bp`` span, over the profiled whole batches of ``run_rate``."""

from benchmark import program_trace


def read(run):
    return program_trace.idle_ms_per_batch(run, "qldpc.bp")
