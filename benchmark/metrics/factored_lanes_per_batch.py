"""The program's ``osd.factored_lanes`` counter over its batches: the
samples a batch that the factored elimination's K5a-d launches took,
summed over the blocks (each block's samples still running); nothing
where the program does not count them."""

from benchmark import program_trace

COUNTER = "osd.factored_lanes"


def read(run):
    from qldpc_tpu_torch.utils.profiling import counts
    return program_trace.counter_per_batch(COUNTER) if COUNTER in counts() else None
