"""Outcome counters for Monte-Carlo decoding runs.

Port of qldpc_tpu/mc/metrics.py: the same fields and the same
``counters_to_dict`` keys, held as int64 tensors (the JAX engine keeps int32
on the device and sums int64 on the host; the port is int64 throughout).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Counters", "zeros_counters", "counters_to_dict", "HIST_BINS"]

# residual weights above the last bin are clipped into it
HIST_BINS = 128


class Counters(NamedTuple):
    """Outcome counters for one (code, error-rate) cell; see the JAX
    package's ``Counters`` for the meaning of each field."""

    trials: torch.Tensor
    logical_errors: torch.Tensor
    residual_logicals: torch.Tensor
    bp_converged: torch.Tensor
    bp_faults: torch.Tensor
    osd_invocations: torch.Tensor
    miscorrected: torch.Tensor
    incorrectable: torch.Tensor
    degeneracies: torch.Tensor
    valid_degenerate: torch.Tensor
    osd_and_logical: torch.Tensor
    osd_overflow: torch.Tensor
    sum_iterations: torch.Tensor
    hist_bp: torch.Tensor  # (HIST_BINS,)
    hist_osd: torch.Tensor
    hist_bp_error: torch.Tensor
    hist_osd_error: torch.Tensor

    def __add__(self, other: "Counters") -> "Counters":
        return Counters(*(a + b for a, b in zip(self, other)))

    def to(self, device) -> "Counters":
        return Counters(*(x.to(device) for x in self))


def zeros_counters(device=None) -> Counters:
    z = lambda: torch.zeros((), dtype=torch.int64, device=device)
    h = lambda: torch.zeros((HIST_BINS,), dtype=torch.int64, device=device)
    return Counters(*(z() for _ in range(13)), h(), h(), h(), h())


def counters_to_dict(c: Counters) -> dict:
    """Host-side dict with derived rates (same keys as the JAX package)."""
    c = c.to("cpu")
    t = max(int(c.trials), 1)
    return {
        "trials": int(c.trials),
        "logical": int(c.logical_errors) / t,
        "osd": int(c.osd_invocations) / t,
        "degeneracies": int(c.valid_degenerate) / t,
        "OSD_invocation_AND_logicalError": int(c.osd_and_logical) / t,
        "average_iterations": int(c.sum_iterations) / t,
        "ler": int(c.logical_errors) / t,
        "residual_logicals": int(c.residual_logicals),
        "ler_notebook": (int(c.bp_faults) + int(c.residual_logicals)) / t,
        "BPs_fault": int(c.bp_faults),
        "BPs_miscorrected": int(c.miscorrected),
        "incorrectable": int(c.incorrectable),
        "degeneracy_count": int(c.degeneracies),
        "bp_converged": int(c.bp_converged),
        "osd_overflow": int(c.osd_overflow),
        "weights_found_BP": c.hist_bp.numpy(),
        "weights_found_OSD": c.hist_osd.numpy(),
        "weights_found_BP_error": c.hist_bp_error.numpy(),
        "weights_found_OSD_error": c.hist_osd_error.numpy(),
    }
