"""Device-idle ms a batch while the host was inside the program's
``qldpc.batch`` span and outside its four stage spans (the batch key and
the counters), over the profiled whole batches of ``run_rate``."""

from benchmark import program_trace


def read(run):
    return program_trace.loop_idle_ms_per_batch(run)
