"""Device-idle ms a batch while the host was inside the program's
``qldpc.sample.detectors`` span (the space-time sampler's per-round
syndromes and their round-to-round difference), over the profiled whole
batches of ``run_rate``; nothing where the program opens no such span."""

from benchmark import program_trace, trace

SPAN = "qldpc.sample.detectors"


def read(run):
    idle = run.get("idle")
    if not idle or not trace.spans(idle["events"], SPAN):
        return None
    return program_trace.idle_ms_per_batch(run, SPAN)
