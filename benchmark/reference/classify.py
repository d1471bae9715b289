"""The outcome counters of one batch, from the errors drawn, the syndrome,
BP's convergence and iterations and the final correction.

With residual r = e + final: a logical error is L fold(r) != 0 (BP + OSD
counts the final correction; the residual logical is the same test), a
degeneracy a final correction that differs from e without a logical
error, valid when it reproduces the syndrome; low weight is
2 |fold(e)| < d; OSD ran on every sample BP did not converge on. The
histograms count the weight of fold(r), clipped into the last of ``bins``
bins, of degeneracies and logical errors after BP alone and after OSD.
``fold`` is the channel's map to the code's qubits (the identity where
the variables are the qubits); the mismatch and the syndrome test read
the whole vectors.
"""

from __future__ import annotations

import torch

from benchmark.reference.channels import identity

FIELDS = ("trials", "logical_errors", "residual_logicals", "bp_converged", "bp_faults",
          "osd_invocations", "miscorrected", "incorrectable", "degeneracies",
          "valid_degenerate", "osd_and_logical", "osd_overflow", "sum_iterations",
          "hist_bp", "hist_osd", "hist_bp_error", "hist_osd_error")


def counters(errors, final, syndromes, converged, iterations, L, parity, distance: int,
             bins: int, fold=identity) -> dict:
    """{field: int or (bins,) int64 tensor on the CPU}; ``parity`` maps
    (B, n) bits to (B, m) syndromes, ``fold`` (B, n) bits to the (B, n')
    bits that ``L`` and the weights read."""
    e, f = errors.to(torch.int64), final.to(torch.int64)
    r = (e + f) % 2
    net = fold(r)
    logical = ((net.to(torch.float32) @ L.T) % 2 != 0).any(-1)
    conv = converged.to(torch.bool)
    mismatch = (e != f).any(-1)
    reproduced = parity(f)
    valid = (reproduced == syndromes.to(reproduced.dtype)).all(-1)
    low = 2 * fold(e).sum(-1) < distance
    degenerate = ~logical & mismatch
    weight = net.sum(-1).clamp(max=bins - 1)

    def hist(mask):
        return torch.bincount(weight[mask], minlength=bins).cpu()

    def count(mask):
        return int(mask.sum())

    return {
        "trials": int(e.shape[0]),
        "logical_errors": count(logical),
        "residual_logicals": count(logical),
        "bp_converged": count(conv),
        "bp_faults": count(~conv),
        "osd_invocations": count(~conv),
        "miscorrected": count(logical & low),
        "incorrectable": count(logical & ~low),
        "degeneracies": count(degenerate),
        "valid_degenerate": count(degenerate & valid),
        "osd_and_logical": count(logical & ~conv),
        "osd_overflow": 0,
        "sum_iterations": int(iterations.to(torch.int64).sum()),
        "hist_bp": hist(degenerate & conv),
        "hist_osd": hist(degenerate & ~conv),
        "hist_bp_error": hist(logical & conv),
        "hist_osd_error": hist(logical & ~conv),
    }
