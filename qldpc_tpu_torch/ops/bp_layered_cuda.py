"""Layered (check-serial) BP: the CUDA kernel K7 and its plain torch version.

K7 (``csrc/bp_layered.cu``) replaces
qldpc_tpu/ops/bp_pallas.py::_bp_layered_kernel; its header says what bounds
it on the card and how the design answers. ``bp_layered_plain`` is
qldpc_tpu/decoders/bp.py::BPDecoder._build_layered in torch: each iteration
walks the checks in L contiguous layers; in each layer ``Q = values[v(e)] -
R_e`` (clipped), the check rule runs on the layer's checks, and the
posteriors absorb ``R_new - R_old`` at once. The JAX path adds the deltas by
scatter (``v.at[:, var_l].add``), so a variable with two edges in one layer
gets both in ascending edge order; the plain version and K7 fold them in
that order explicitly. No damping: the config refuses it.

``bp_layered`` is the entry point: the plain version for CPU tensors, K7 for
CUDA tensors, never a fallback.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import torch

from qldpc_tpu_torch._build import KernelLibrary
from qldpc_tpu_torch.ops.bp_cuda import BPTables, check_rule

if TYPE_CHECKING:
    from qldpc_tpu_torch.decoders.bp import BPConfig

__all__ = ["layer_count", "bp_layered", "bp_layered_plain", "bp_layered_cuda"]

_THREADS = 256
_SMEM_BUDGET = 48 * 1024
_MAX_SAMPLES_PER_BLOCK = 64
_MAX_DC = 32

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = KernelLibrary(
    "bp_layered.cu",
    {
        "bp_layered_launch": [
            _vp, _vp, _i, _vp, _vp, _vp, _vp, _vp,
            _i, _i, _i, _i, _i, _i, _i,
            _f, _i, _f, _i, _f, _i, _i,
            _i, _i, _vp,
        ]
    },
)


def layer_count(m: int, n_layers: int = 0) -> int:
    """Layers per iteration: ``n_layers``, or by default the largest of 4, 3
    and 2 that divides m (1 when none does). Raises when it does not divide m."""
    L = n_layers or next((k for k in (4, 3, 2) if m % k == 0), 1)
    if m % L:
        raise ValueError(f"n_layers={L} must divide m={m}")
    return L


def bp_layered_plain(syndromes: torch.Tensor, priors: torch.Tensor, tables: BPTables,
                     cfg: BPConfig, alpha: float | None = None):
    """Layered BP in plain torch. ``priors`` (n,) or (B, n) sets the dtype;
    ``cfg`` supplies max_iter, method, alpha, offset, clip_llr and n_layers,
    and ``alpha`` overrides ``cfg.alpha``. Every iteration runs on every
    sample; converged samples are frozen.

    Returns ``(values (B, n), converged (B,) bool, iterations (B,) int32,
    hard (B, n) int8)``.
    """
    alpha = cfg.alpha if alpha is None else alpha
    B = syndromes.shape[0]
    n, m, dc = tables.n, tables.m, tables.dc
    E = m * dc
    L = layer_count(m, cfg.n_layers)
    ml = m // L
    El = ml * dc
    dtype, dev = priors.dtype, syndromes.device
    var_of_edge = tables.check_var.reshape(-1).long()
    var_edge = tables.var_edge.long()

    syn = syndromes.to(torch.int32)
    ssign = (1 - 2 * syn).to(dtype)
    values = priors.expand(B, n).clone()
    R = torch.zeros((B, E), dtype=dtype, device=dev)
    hard = torch.zeros((B, n), dtype=torch.int8, device=dev)
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), cfg.max_iter - 1, dtype=torch.int32, device=dev)
    # each variable's edges in layer l, in ascending edge order (var_edge
    # is sorted), as layer-local slots with a mask for the others
    in_layer = [(var_edge < E) & (var_edge // El == l) for l in range(L)]
    local = (var_edge % El).clamp(max=El - 1)

    for it in range(cfg.max_iter):
        v = values
        parts = []
        for l in range(L):
            R_l = R[:, l * El:(l + 1) * El]
            Q_l = v[:, var_of_edge[l * El:(l + 1) * El]] - R_l
            if cfg.clip_llr is not None:
                Q_l = torch.clamp(Q_l, -cfg.clip_llr, cfg.clip_llr)
            R_new = check_rule(Q_l.view(B, ml, dc), ssign[:, l * ml:(l + 1) * ml],
                               cfg, alpha).reshape(B, El)
            delta = R_new - R_l
            for k in range(var_edge.shape[1]):
                v = torch.where(in_layer[l][:, k], v + delta[:, local[:, k]], v)
            parts.append(R_new)
        h = (v < 0).to(torch.int8)
        s_hat = h[:, var_of_edge].view(B, m, dc).sum(dim=-1, dtype=torch.int32) % 2
        ok = (s_hat == syn).all(dim=-1)
        keep = conv[:, None]
        R = torch.where(keep, R, torch.cat(parts, dim=1))
        values = torch.where(keep, values, v)
        hard = torch.where(keep, hard, h)
        iters = torch.where(conv, iters, torch.full_like(iters, it))
        conv = conv | ok
    return values, conv, iters, hard


def _samples_per_block(tables: BPTables, L: int) -> int:
    m, n, dc = tables.m, tables.n, tables.dc
    per_sample = 4 * (m * dc + (m // L) * dc + n) + m
    return max(1, min(_MAX_SAMPLES_PER_BLOCK, _SMEM_BUDGET // per_sample))


def bp_layered_cuda(syndromes: torch.Tensor, priors: torch.Tensor, tables: BPTables,
                    cfg: BPConfig, alpha: float | None = None):
    """Launch K7. Same contract as ``bp_layered_plain``; float32 only."""
    dev = syndromes.device
    if dev.type != "cuda":
        raise ValueError("bp_layered_cuda needs CUDA tensors")
    alpha = cfg.alpha if alpha is None else alpha
    if priors.dtype != torch.float32:
        raise TypeError(f"the CUDA layered BP kernel runs float32 only, got priors of {priors.dtype}")
    if tables.dc > _MAX_DC:
        raise ValueError(f"check degree {tables.dc} exceeds the kernel's {_MAX_DC}")
    B = syndromes.shape[0]
    n, m = tables.n, tables.m
    L = layer_count(m, cfg.n_layers)
    if syndromes.shape != (B, m):
        raise ValueError(f"syndromes must be (B, {m}), got {tuple(syndromes.shape)}")
    if priors.shape == (n,):
        prior_stride = 0
    elif priors.shape == (B, n):
        prior_stride = n
    else:
        raise ValueError(f"priors must be ({n},) or ({B}, {n})")
    for t in (priors, tables.check_var, tables.var_edge):
        if t.device != dev:
            raise ValueError("all BP operands must be on one device")
    if tables.check_var.dtype != torch.int32 or tables.var_edge.dtype != torch.int32:
        raise TypeError("BP tables must be int32")
    # contiguous operands bound to names: each must outlive the launch
    syn = syndromes.to(torch.uint8).contiguous()
    priors = priors.contiguous()
    check_var = tables.check_var.contiguous()
    var_edge = tables.var_edge.contiguous()
    values = torch.empty((B, n), dtype=torch.float32, device=dev)
    conv = torch.empty(B, dtype=torch.uint8, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    alpha32 = float(alpha)
    _LIB.call(
        "bp_layered_launch",
        syn.data_ptr(), priors.data_ptr(), prior_stride,
        check_var.data_ptr(), var_edge.data_ptr(),
        values.data_ptr(), conv.data_ptr(), iters.data_ptr(),
        B, m, n, tables.dc, tables.dv, L,
        0 if cfg.method == "sum-product" else 1,
        alpha32, int(alpha32 != 1.0),
        float(cfg.offset), int(bool(cfg.offset)),
        float(cfg.clip_llr or 0.0), int(cfg.clip_llr is not None),
        cfg.max_iter, _samples_per_block(tables, L), _THREADS,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    bp_layered_cuda.launches += 1
    return values, conv.bool(), iters, (values < 0).to(torch.int8)


bp_layered_cuda.launches = 0


def bp_layered(syndromes, priors, tables: BPTables, cfg: BPConfig, alpha=None):
    """Layered BP: plain torch for CPU tensors, K7 for CUDA tensors."""
    if syndromes.device.type == "cuda":
        return bp_layered_cuda(syndromes, priors, tables, cfg, alpha)
    if syndromes.device.type != "cpu":
        raise ValueError(f"unsupported device {syndromes.device}")
    return bp_layered_plain(syndromes, priors, tables, cfg, alpha)
