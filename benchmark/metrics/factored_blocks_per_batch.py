"""The program's ``osd.factored_blocks`` counter over its batches: the
column blocks a batch in which the factored elimination's loop found
samples still running and launched K5a-d on them; nothing where the
program does not count them."""

from benchmark import program_trace

COUNTER = "osd.factored_blocks"


def read(run):
    from qldpc_tpu_torch.utils.profiling import counts
    return program_trace.counter_per_batch(COUNTER) if COUNTER in counts() else None
