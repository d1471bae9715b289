"""Device-idle ms a batch while the host was inside the program's
``qldpc.classify.fold`` span (the XOR of the data rounds, for the residual
and for the errors' weight), over the profiled whole batches of
``run_rate``; nothing where the program opens no such span."""

from benchmark import program_trace, trace

SPAN = "qldpc.classify.fold"


def read(run):
    idle = run.get("idle")
    if not idle or not trace.spans(idle["events"], SPAN):
        return None
    return program_trace.idle_ms_per_batch(run, SPAN)
