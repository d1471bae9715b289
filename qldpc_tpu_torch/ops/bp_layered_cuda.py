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

K7 walks only the variables a layer touches, from ``layer_tables`` built
once on the host; ``BPDecoder`` with ``schedule="layered"`` keeps them as
buffers and hands them over in ``LayeredTables``.

``bp_layered`` is the entry point: the plain version for CPU tensors, K7 for
CUDA tensors, never a fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from qldpc_tpu_torch._build import KernelLibrary
from qldpc_tpu_torch.ops.bp_cuda import BPTables, check_rule

if TYPE_CHECKING:
    from qldpc_tpu_torch.decoders.bp import BPConfig

__all__ = [
    "LayeredTables",
    "layer_count",
    "layer_tables",
    "bp_layered",
    "bp_layered_plain",
    "bp_layered_cuda",
]

_WARPS_PER_BLOCK = 8
_SMEM_PER_BLOCK = 227 * 1024  # what one block may have on the H100
_MAX_DC = 32

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = KernelLibrary(
    "bp_layered.cu",
    {
        "bp_layered_launch": [
            _vp, _vp, _i, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
            _i, _i, _i, _i, _i, _i, _i, _i,
            _f, _i, _f, _i, _f, _i, _i,
            _i, _vp,
        ]
    },
)


@dataclasses.dataclass(frozen=True)
class LayeredTables(BPTables):
    """``BPTables`` with K7's per-layer tables (``layer_tables``).

    layer_vars (L, T) int32: the variables each layer touches, ascending,
      padded with n.
    layer_edges (L, T, K) int32: each one's layer-local edges (e - l*El),
      ascending, padded with -1.
    """

    layer_vars: torch.Tensor
    layer_edges: torch.Tensor


def layer_count(m: int, n_layers: int = 0) -> int:
    """Layers per iteration: ``n_layers``, or by default the largest of 4, 3
    and 2 that divides m (1 when none does). Raises when it does not divide m."""
    L = n_layers or next((k for k in (4, 3, 2) if m % k == 0), 1)
    if m % L:
        raise ValueError(f"n_layers={L} must divide m={m}")
    return L


def layer_tables(var_edge: np.ndarray, m: int, dc: int, L: int) -> dict[str, np.ndarray]:
    """The ``LayeredTables`` arrays from a check-regular graph's ``var_edge``
    (n, dv), sorted per row and padded with E = m*dc: per layer, the
    variables its checks touch and, for each, its edges in the layer in
    ascending order, the order in which the posterior adds their deltas."""
    n, E, El = var_edge.shape[0], m * dc, (m // L) * dc
    layer = np.where(var_edge < E, var_edge // El, -1)
    per = []
    for l in range(L):
        touched = np.flatnonzero((layer == l).any(axis=1))
        local = np.sort(np.where(layer[touched] == l, var_edge[touched] - l * El, El), axis=1)
        per.append((touched, local))
    T = max(1, max(len(t) for t, _ in per))
    K = max(1, max(int((loc < El).sum(axis=1).max(initial=0)) for _, loc in per))
    layer_vars = np.full((L, T), n, np.int32)
    layer_edges = np.full((L, T, K), -1, np.int32)
    for l, (touched, local) in enumerate(per):
        layer_vars[l, : len(touched)] = touched
        layer_edges[l, : len(touched)] = np.where(local[:, :K] < El, local[:, :K], -1)
    return dict(layer_vars=layer_vars, layer_edges=layer_edges)


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


def bp_layered_cuda(syndromes: torch.Tensor, priors: torch.Tensor, tables: LayeredTables,
                    cfg: BPConfig, alpha: float | None = None):
    """Launch K7. Same contract as ``bp_layered_plain``; float32 only; the
    tables must be ``LayeredTables`` built for ``cfg``'s layer count."""
    dev = syndromes.device
    if dev.type != "cuda":
        raise ValueError("bp_layered_cuda needs CUDA tensors")
    alpha = cfg.alpha if alpha is None else alpha
    if priors.dtype != torch.float32:
        raise TypeError(f"the CUDA layered BP kernel runs float32 only, got priors of {priors.dtype}")
    if tables.dc > _MAX_DC:
        raise ValueError(f"check degree {tables.dc} exceeds the kernel's {_MAX_DC}")
    B = syndromes.shape[0]
    n, m, dc = tables.n, tables.m, tables.dc
    L = layer_count(m, cfg.n_layers)
    if not isinstance(tables, LayeredTables) or tables.layer_vars.shape[0] != L:
        raise ValueError(f"K7 needs LayeredTables for {L} layers: "
                         "BPDecoder(H, BPConfig(schedule='layered', ...)).tables()")
    if syndromes.shape != (B, m):
        raise ValueError(f"syndromes must be (B, {m}), got {tuple(syndromes.shape)}")
    if priors.shape == (n,):
        prior_stride = 0
    elif priors.shape == (B, n):
        prior_stride = n
    else:
        raise ValueError(f"priors must be ({n},) or ({B}, {n})")
    # contiguous operands bound to names: each must outlive the launch
    index_tables = tuple(t.contiguous() for t in (
        tables.check_var, tables.layer_vars, tables.layer_edges))
    for t in (priors, *index_tables):
        if t.device != dev:
            raise ValueError("all BP operands must be on one device")
    if any(t.dtype != torch.int32 for t in index_tables):
        raise TypeError("BP tables must be int32")
    check_var, layer_vars, layer_edges = index_tables
    T, K = layer_edges.shape[1], layer_edges.shape[2]
    # a warp's slice of shared memory: R, one layer's deltas, the
    # posteriors, the syndrome bytes
    per_warp = 4 * (m * dc + (m // L) * dc + n) + m + 32
    warps = min(_WARPS_PER_BLOCK, _SMEM_PER_BLOCK // per_warp)
    if warps < 1:
        raise ValueError(f"one sample's state ({per_warp} bytes) exceeds a block's shared memory")
    syn = syndromes.to(torch.uint8).contiguous()
    priors = priors.contiguous()
    values = torch.empty((B, n), dtype=torch.float32, device=dev)
    conv = torch.empty(B, dtype=torch.uint8, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    alpha32 = float(alpha)
    _LIB.call(
        "bp_layered_launch",
        syn.data_ptr(), priors.data_ptr(), prior_stride,
        check_var.data_ptr(), layer_vars.data_ptr(), layer_edges.data_ptr(),
        values.data_ptr(), conv.data_ptr(), iters.data_ptr(), counter.data_ptr(),
        B, m, n, dc, L, T, K,
        0 if cfg.method == "sum-product" else 1,
        alpha32, int(alpha32 != 1.0),
        float(cfg.offset), int(bool(cfg.offset)),
        float(cfg.clip_llr or 0.0), int(cfg.clip_llr is not None),
        cfg.max_iter, warps,
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
