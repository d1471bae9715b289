"""Structured space-time BP: decode T rounds of detectors without building
kron(I_T, H).

Port of qldpc_tpu/decoders/spacetime_bp.py. The decoder is an ``nn.Module``
whose buffers are the BASE code's gather tables, so their size does not
grow with T. ``forward`` runs ``ops.spacetime_bp_cuda.st_bp``: the plain
torch version on CPU tensors, the kernel K6 on CUDA tensors. Its semantics
are flooding BP on the materialized ``H_st`` (noise/spacetime.py): the same
check rule, clipping, damping, freeze and iteration accounting; the output
is in ``space_time_matrix``'s column order (all data rounds, then all
measurement rounds).

Like the JAX decoder it refuses the layered schedule and base codes that are
not check-regular. It decodes in float32, as the JAX decoder does whatever
its dtype, and refuses a float64 config rather than ignore it. The bf16
message modes (``stream_dtype``, ``mm_dtype``) belong to the DEM and the
flooding kernels: the JAX decoder's structured kernel has neither and runs
float32 messages under them, and so does this one.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from qldpc_tpu_torch.decoders.bp import BPConfig, BPResult
from qldpc_tpu_torch.ops.bp_cuda import BPTables
from qldpc_tpu_torch.ops.spacetime_bp_cuda import st_bp
from qldpc_tpu_torch.ops.tanner import TannerGraph

__all__ = ["SpaceTimeBPDecoder"]


class SpaceTimeBPDecoder(nn.Module):
    """Batched BP over T measurement rounds of a base check matrix.

    Usage::

        dec = SpaceTimeBPDecoder(H, T, BPConfig(max_iter=100)).to(device)
        res = dec(detectors, priors)   # detectors (B, T*m), priors (T*n + T*m,)
    """

    def __init__(self, H_base: np.ndarray, n_rounds: int, config: BPConfig = BPConfig()):
        super().__init__()
        if config.schedule != "flooding":
            raise NotImplementedError(
                "the structured space-time decoder supports the flooding schedule only"
            )
        if config.dtype != "float32":
            raise ValueError("the structured space-time decoder runs float32 only")
        if n_rounds < 1:
            raise ValueError("n_rounds must be at least 1")
        g = TannerGraph.from_H(H_base)
        if not g.check_regular:
            raise NotImplementedError("base code must be check-regular")
        self.config = config
        self.T = n_rounds
        self.m, self.n, self.dc = g.m, g.n, g.dc_max
        self.n_vars = self.T * (self.n + self.m)
        self.register_buffer(
            "check_var", torch.from_numpy(g.var_of_edge.reshape(g.m, g.dc_max).astype(np.int32))
        )
        self.register_buffer("var_edge", torch.from_numpy(g.var_edge.astype(np.int32)))

    def tables(self) -> BPTables:
        return BPTables(check_var=self.check_var, var_edge=self.var_edge)

    def forward(self, detectors: torch.Tensor, priors: torch.Tensor,
                alpha: float | None = None) -> BPResult:
        """Decode a batch. ``alpha`` overrides ``config.alpha`` for this call."""
        dev = self.check_var.device
        detectors = torch.as_tensor(detectors, device=dev)
        priors = torch.as_tensor(priors, device=dev).to(torch.float32)
        values, conv, iters, hard = st_bp(
            detectors, priors, self.tables(), self.T, self.config, alpha
        )
        return BPResult(hard=hard, converged=conv, llrs=values, iterations=iters)
