"""Device-idle ms a batch while the host was inside the program's
``qldpc.osd.factored`` span (the factored elimination's block loop: K5a-d
and the loop's host syncs), over the profiled whole batches of
``run_rate``; nothing where the program opens no such span."""

from benchmark import program_trace, trace

SPAN = "qldpc.osd.factored"


def read(run):
    idle = run.get("idle")
    if not idle or not trace.spans(idle["events"], SPAN):
        return None
    return program_trace.idle_ms_per_batch(run, SPAN)
