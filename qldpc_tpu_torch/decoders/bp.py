"""Batched belief-propagation decoding in torch (flooding schedule).

Port of qldpc_tpu/decoders/bp.py for check-regular Tanner graphs (the BB
codes and Steane). The decoder is an ``nn.Module`` whose gather tables are
registered buffers built from the shared ``TannerGraph``, so ``.to(device)``
moves them with it. Decoding runs ``ops.bp_cuda.bp_flooding``: the plain
torch version on CPU tensors, the fused kernel K1 on CUDA tensors.

Not in this slice (see ROADMAP.md): the layered schedule and irregular graphs
(DEM and materialized space-time matrices).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from qldpc_tpu.ops.tanner import TannerGraph
from qldpc_tpu_torch.ops.bp_cuda import BPTables, bp_flooding

__all__ = ["BPConfig", "BPResult", "BPDecoder"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class BPResult(NamedTuple):
    """Per-sample decoding outputs (all batched on the leading axis)."""

    hard: torch.Tensor  # (B, n) int8 hard decision
    converged: torch.Tensor  # (B,) bool: syndrome reproduced within max_iter
    llrs: torch.Tensor  # (B, n) posterior LLRs at the exit iteration
    iterations: torch.Tensor  # (B,) int32 iteration index at convergence


@dataclasses.dataclass(frozen=True)
class BPConfig:
    """Decoder hyper-parameters (qldpc_tpu.decoders.BPConfig without its
    TPU selectors: the tensor's device picks the path)."""

    max_iter: int = 50
    method: str = "sum-product"  # "sum-product" | "min-sum"
    alpha: float = 1.0  # normalization of check messages
    offset: float = 0.0  # offset min-sum: |R| -> max(|R| - offset, 0)
    damping: float = 1.0  # 1.0 = no damping; Q = d*Q_new + (1-d)*Q_old
    clip_llr: float | None = None  # symmetric clip of Q messages, None = off
    schedule: str = "flooding"
    dtype: str = "float32"  # "float64" runs on the plain (CPU) path only

    def __post_init__(self):
        if self.max_iter < 1:
            raise ValueError("max_iter must be at least 1")
        if self.method not in ("sum-product", "min-sum"):
            raise ValueError(f"unknown BP method {self.method!r}")
        if self.offset and self.method != "min-sum":
            raise ValueError("offset applies to the min-sum method only")
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.schedule == "layered":
            raise NotImplementedError(
                "the layered BP schedule is not ported yet (ROADMAP.md, "
                "queue 2, K7)"
            )
        if self.schedule != "flooding":
            raise ValueError(f"unknown schedule {self.schedule!r}")


class BPDecoder(nn.Module):
    """Batched flooding BP decoder for a fixed parity-check matrix.

    Usage::

        dec = BPDecoder(H, BPConfig(max_iter=50)).to(device)
        res = dec(syndromes, priors)     # syndromes (B, m), priors (n,) or (B, n)
    """

    def __init__(self, H: np.ndarray, config: BPConfig = BPConfig()):
        super().__init__()
        self.config = config
        self.graph = g = TannerGraph.from_H(H)
        if not g.check_regular:
            raise NotImplementedError(
                "irregular Tanner graphs (DEM, space-time) are not ported yet "
                "(ROADMAP.md, queue 1 item 9)"
            )
        self.dtype = _DTYPES[config.dtype]
        self.register_buffer(
            "check_var",
            torch.from_numpy(g.var_of_edge.reshape(g.m, g.dc_max).astype(np.int32)),
        )
        self.register_buffer(
            "var_edge", torch.from_numpy(g.var_edge.astype(np.int32))
        )

    def tables(self) -> BPTables:
        return BPTables(check_var=self.check_var, var_edge=self.var_edge)

    def forward(self, syndromes: torch.Tensor, priors: torch.Tensor,
                alpha: float | None = None) -> BPResult:
        """Decode a batch. ``alpha`` overrides ``config.alpha`` for this call."""
        dev = self.check_var.device
        syndromes = torch.as_tensor(syndromes, device=dev)
        priors = torch.as_tensor(priors, device=dev).to(self.dtype)
        values, conv, iters, hard = bp_flooding(
            syndromes, priors, self.tables(), self.config, alpha
        )
        return BPResult(hard=hard, converged=conv, llrs=values, iterations=iters)
