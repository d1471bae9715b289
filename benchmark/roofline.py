"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the
700 W power limit) and the least time of a BP call on them.

A BP call reads its syndromes, priors and graph once and writes its
posteriors, hard decisions, convergence flags and iterations once; it
runs each sample's own iterations over every edge of H, at
``BP_OPS_PER_EDGE`` float32 operations an edge and iteration (the
check's tanh, log and leave-one-out, the atanh, the variable's sum and
subtraction). Its least time is the larger of bytes over the memory rate
and operations over the float32 rate outside the tensor cores.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
BP_OPS_PER_EDGE = 10
INDEX_BYTES = 4


def bound_s(moved: float, ops: float) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations", whichever bounds it)."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bp_work(batch: int, m: int, n: int, edges: int, iterations_run: int,
            syndrome_bytes: int, prior_bytes: int) -> tuple[float, float]:
    """(bytes moved, operations) of a BP call on ``batch`` samples that ran
    ``iterations_run`` iterations in all: the graph as one index an edge
    each way and one offset a check and a variable; outputs as float32
    posteriors, int8 hard decisions, a byte of convergence and an int32
    iteration count a sample."""
    graph = (2 * edges + m + n) * INDEX_BYTES
    outputs = batch * n * 4 + batch * n + batch + batch * 4
    return float(syndrome_bytes + prior_bytes + graph + outputs), \
        float(iterations_run) * edges * BP_OPS_PER_EDGE
