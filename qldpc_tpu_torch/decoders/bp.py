"""Batched belief-propagation decoding in torch.

Port of qldpc_tpu/decoders/bp.py. The decoder is an ``nn.Module`` whose
gather tables are registered buffers built from the shared ``TannerGraph``,
so ``.to(device)`` moves them with it. Check-regular graphs (the BB codes
and Steane) run ``ops.bp_cuda.bp_flooding``: the plain torch version on CPU
tensors, the fused kernel K1 on CUDA tensors; with ``schedule="layered"``
they run ``ops.bp_layered_cuda.bp_layered``: plain torch on CPU tensors, K7
on CUDA tensors. Irregular graphs (detector error models) take the padded
check-slot layout of the XLA path and run ``ops.dem_bp_cuda.dem_bp``: plain
torch on CPU tensors, K3 on CUDA tensors. The layered schedule needs a
check-regular graph, as in the JAX package. ``check_messages`` gives the
check-to-variable messages after a few iterations, which the Alvarado fit
reads (``decoders.alvarado``).

The JAX package's two bf16 message modes carry over (``BPConfig.stream_dtype``
and ``mm_dtype``, qldpc_tpu/decoders/bp.py:63-73): the messages round to
bfloat16 where its Pallas kernels round them, and all arithmetic stays
float32. ``stream_dtype="bfloat16"`` belongs to the DEM kernel (K3) and
``mm_dtype="bfloat16"`` to the fused flooding kernel (K1); each raises
where the JAX package raises (``BPDecoder``). As in the JAX package, a mode
in effect computes in float32 whatever ``dtype`` says, and ``mm_dtype`` on
a damped irregular graph warns and runs the float32 path, its messages
unrounded.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from qldpc_tpu_torch.ops.tanner import TannerGraph
from qldpc_tpu_torch.ops import bp_cuda, dem_bp_cuda
from qldpc_tpu_torch.ops.bp_cuda import BPTables, bp_flooding
from qldpc_tpu_torch.ops.bp_layered_cuda import (
    LayeredTables,
    bp_layered,
    layer_count,
    layer_tables,
)
from qldpc_tpu_torch.ops.dem_bp_cuda import DEMTables, dem_bp, dem_tables

__all__ = ["BPConfig", "BPResult", "BPDecoder"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64}
_MESSAGE_DTYPES = ("float32", "bfloat16")


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
    schedule: str = "flooding"  # "flooding" | "layered" (check-serial)
    n_layers: int = 0  # layered: check groups per iteration; 0 = auto
    dtype: str = "float32"  # "float64" runs on the plain (CPU) path only;
    # a bf16 mode in effect computes in float32 whatever it says, as the JAX
    # kernels do
    stream_dtype: str = "float32"  # DEM kernel (irregular graphs): "bfloat16"
    # rounds the slot-space messages as the streams of
    # qldpc_tpu/ops/dem_bp_pallas.py hold them
    mm_dtype: str = "float32"  # fused flooding kernel (check-regular graphs):
    # "bfloat16" rounds the messages as the bf16 MXU operands of
    # qldpc_tpu/ops/bp_pallas.py::_bp_kernel do

    def __post_init__(self):
        if self.max_iter < 1:
            raise ValueError("max_iter must be at least 1")
        if self.method not in ("sum-product", "min-sum"):
            raise ValueError(f"unknown BP method {self.method!r}")
        if self.offset and self.method != "min-sum":
            raise ValueError("offset applies to the min-sum method only")
        if self.dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.schedule not in ("flooding", "layered"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.schedule == "layered" and self.damping != 1.0:
            raise ValueError("damping is not supported with the layered "
                             "schedule (messages are recomputed per layer)")
        if self.n_layers < 0:
            raise ValueError("n_layers must be >= 0")
        if self.stream_dtype not in _MESSAGE_DTYPES:
            raise ValueError(f"unknown stream_dtype {self.stream_dtype!r}")
        if self.mm_dtype not in _MESSAGE_DTYPES:
            raise ValueError(f"unknown mm_dtype {self.mm_dtype!r}")
        if self.mm_dtype != "float32" and self.schedule != "flooding":
            raise ValueError(
                "mm_dtype applies only to the fused flooding kernel (regular graphs)"
            )


def _check_message_modes(cfg: BPConfig, slot_layout: bool) -> bool:
    """The JAX decoder's refusals of the bf16 modes on this graph
    (qldpc_tpu/decoders/bp.py:545-580), and its warning where it ignores
    ``mm_dtype`` (a damped irregular graph, which its XLA path decodes in
    float32). Returns whether a bf16 mode is in effect."""
    if cfg.stream_dtype != "float32":
        if not slot_layout:
            raise ValueError(
                "stream_dtype applies to the streamed DEM kernel only; the fused "
                "kernel of a check-regular graph has no device-memory message streams"
            )
        if cfg.schedule != "flooding" or cfg.damping != 1.0:
            raise ValueError(
                "stream_dtype=bfloat16 requires the streamed DEM kernel (irregular "
                "graph, flooding schedule, no damping)"
            )
    if cfg.mm_dtype != "float32" and slot_layout:
        if cfg.damping == 1.0:
            raise ValueError(
                "mm_dtype applies to the fused flooding kernel only; irregular graphs use "
                "the streamed DEM kernel (stream_dtype is its bf16 knob)"
            )
        warnings.warn(
            "mm_dtype applies to the fused flooding kernel only; a damped irregular graph "
            "runs the float32 path without it, as the JAX package's XLA fallback does",
            stacklevel=3,
        )
        return False
    return cfg.stream_dtype != "float32" or cfg.mm_dtype != "float32"


class BPDecoder(nn.Module):
    """Batched BP decoder (flooding or layered) for a fixed parity-check matrix.

    Usage::

        dec = BPDecoder(H, BPConfig(max_iter=50)).to(device)
        res = dec(syndromes, priors)     # syndromes (B, m), priors (n,) or (B, n)
    """

    def __init__(self, H: np.ndarray, config: BPConfig = BPConfig()):
        super().__init__()
        self.config = config
        self.graph = g = TannerGraph.from_H(H)
        self.dtype = _DTYPES[config.dtype]
        # irregular graphs use the padded check-slot layout
        self.slot_layout = not g.check_regular
        if config.schedule == "layered":
            if self.slot_layout:
                raise ValueError(
                    "the layered schedule requires a check-regular graph "
                    "(every check with the same degree)"
                )
            L = layer_count(g.m, config.n_layers)  # raises when it does not divide m
        if _check_message_modes(config, self.slot_layout):
            self.dtype = torch.float32  # the JAX kernels' arithmetic, whatever dtype says
        if self.slot_layout:
            self._table_names = tuple(f.name for f in dataclasses.fields(DEMTables))
            for name, arr in dem_tables(g).items():
                self.register_buffer(name, torch.from_numpy(arr))
        else:
            self._table_names = ("check_var", "var_edge")
            self.register_buffer(
                "check_var",
                torch.from_numpy(g.var_of_edge.reshape(g.m, g.dc_max).astype(np.int32)),
            )
            self.register_buffer(
                "var_edge", torch.from_numpy(g.var_edge.astype(np.int32))
            )
            if config.schedule == "layered":
                for name, arr in layer_tables(g.var_edge, g.m, g.dc_max, L).items():
                    self.register_buffer(name, torch.from_numpy(arr))
                self._table_names += ("layer_vars", "layer_edges")

    def tables(self) -> BPTables | LayeredTables | DEMTables:
        if self.slot_layout:
            kind = DEMTables
        else:
            kind = LayeredTables if self.config.schedule == "layered" else BPTables
        return kind(**{name: getattr(self, name) for name in self._table_names})

    def forward(self, syndromes: torch.Tensor, priors: torch.Tensor,
                alpha: float | None = None) -> BPResult:
        """Decode a batch. ``alpha`` overrides ``config.alpha`` for this call."""
        dev = getattr(self, self._table_names[0]).device
        syndromes = torch.as_tensor(syndromes, device=dev)
        priors = torch.as_tensor(priors, device=dev).to(self.dtype)
        if self.slot_layout:
            run = dem_bp
        else:
            run = bp_layered if self.config.schedule == "layered" else bp_flooding
        values, conv, iters, hard = run(
            syndromes, priors, self.tables(), self.config, alpha
        )
        return BPResult(hard=hard, converged=conv, llrs=values, iterations=iters)

    def _raw_check_messages(self, syndromes: torch.Tensor, priors: torch.Tensor,
                            at_iter: int = 0) -> torch.Tensor:
        """R (B, E) after ``at_iter + 1`` flooding iterations, in the
        decoder's edge space (check slots on a DEM graph), ``config.alpha``
        applied as BP applies it: qldpc_tpu/decoders/bp.py::
        _raw_check_messages. The JAX package computes these with XLA, outside
        any Pallas kernel; here they are torch ops on either device, on the
        port's check rules (``ops.bp_cuda._check_messages`` and the DEM slot
        rule) and gathers, with no convergence freeze."""
        dev = getattr(self, self._table_names[0]).device
        syndromes = torch.as_tensor(syndromes, device=dev)
        B = syndromes.shape[0]
        cfg, tables = self.config, self.tables()
        priors = torch.as_tensor(priors, device=dev).to(self.dtype).expand(B, self.graph.n)
        ssign = (1 - 2 * syndromes.to(torch.int32)).to(self.dtype)
        if self.slot_layout:
            var_of_edge = tables.var_of_slot.reshape(-1).long()
            var_edge = tables.var_slots.long()
            rule = dem_bp_cuda._check_messages
        else:
            var_of_edge = tables.check_var.reshape(-1).long()
            var_edge = tables.var_edge.long()
            rule = bp_cuda._check_messages
        pad = torch.zeros((B, 1), dtype=self.dtype, device=dev)
        R = rule(priors[:, var_of_edge], ssign, tables, cfg, cfg.alpha)
        for _ in range(at_iter):
            rv = torch.cat([R, pad], dim=1)[:, var_edge]  # (B, n, dv)
            values = rv[..., 0]
            for k in range(1, rv.shape[-1]):
                values = values + rv[..., k]
            values = values + priors
            R = rule(values[:, var_of_edge] - R, ssign, tables, cfg, cfg.alpha)
        return R

    def check_messages(self, syndromes, priors, at_iter: int = 0) -> torch.Tensor:
        """The check-to-variable messages (B, E) in edge order after
        ``at_iter + 1`` iterations, divided by ``config.alpha``
        (qldpc_tpu/decoders/bp.py::check_messages)."""
        R = self._raw_check_messages(syndromes, priors, at_iter)
        if self.slot_layout:  # slot space -> edge order
            R = R[:, torch.from_numpy(self.graph.check_slot_of_edge).to(R.device).long()]
        alpha = self.config.alpha
        return R / alpha if alpha != 1.0 else R
