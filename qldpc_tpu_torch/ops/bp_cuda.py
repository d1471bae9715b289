"""Fused flooding BP: the CUDA kernel K1 and its plain torch version.

K1 (``csrc/bp_flooding.cu``) replaces qldpc_tpu/ops/bp_pallas.py::_bp_kernel;
its header says what bounds it on the card and how the design answers.
``bp_flooding_plain`` is the flooding path of qldpc_tpu/decoders/bp.py
(``_check_messages`` and ``_step``) written in torch with the same
floating-point order: the leave-one-out tanh product is an exclusive prefix
times an exclusive suffix product, each folded sequentially; posteriors are a
left fold over each variable's edges plus the prior.

``bp_flooding`` is the entry point: it takes the plain version for CPU
tensors and launches K1 for CUDA tensors, and never falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import TYPE_CHECKING

import torch

from qldpc_tpu_torch._build import KernelLibrary

if TYPE_CHECKING:
    from qldpc_tpu_torch.decoders.bp import BPConfig

__all__ = [
    "BPTables",
    "bp_flooding",
    "bp_flooding_plain",
    "bp_flooding_cuda",
]

TANH_CLIP = 0.9999999
_THREADS = 256
_SMEM_BUDGET = 48 * 1024
_MAX_SAMPLES_PER_BLOCK = 64
_MAX_DC = 32

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = KernelLibrary(
    "bp_flooding.cu",
    {
        "bp_flooding_launch": [
            _vp, _vp, _i, _vp, _vp, _vp, _vp, _vp,
            _i, _i, _i, _i, _i, _i,
            _f, _i, _f, _i, _f, _f, _i, _f, _i, _i,
            _i, _i, _vp,
        ]
    },
)


@dataclasses.dataclass(frozen=True)
class BPTables:
    """Gather tables of a check-regular Tanner graph (edge e = c*dc + slot).

    check_var (m, dc) int32: variable of each edge, i.e. var_of_edge.
    var_edge (n, dv) int32: each variable's edges in order, padded with E.
    """

    check_var: torch.Tensor
    var_edge: torch.Tensor

    @property
    def m(self) -> int:
        return self.check_var.shape[0]

    @property
    def dc(self) -> int:
        return self.check_var.shape[1]

    @property
    def n(self) -> int:
        return self.var_edge.shape[0]

    @property
    def dv(self) -> int:
        return self.var_edge.shape[1]


def _leave_one_out_product(t: list[torch.Tensor]) -> list[torch.Tensor]:
    """others[j] = prod_{i<j} t[i] * prod_{i>j} t[i], both sides folded
    sequentially (decoders/bp.py::_others_product's cumprods)."""
    dc = len(t)
    suf = [None] * dc
    suf[dc - 1] = t[dc - 1]
    for j in range(dc - 2, -1, -1):
        suf[j] = suf[j + 1] * t[j]
    out = []
    left = None
    for j in range(dc):
        right = suf[j + 1] if j + 1 < dc else None
        if left is None:
            out.append(right if right is not None else torch.ones_like(t[j]))
        else:
            out.append(left if right is None else left * right)
        left = t[j] if left is None else left * t[j]
    return out


def _check_messages(Q, ssign, tables: BPTables, cfg: BPConfig, alpha: float):
    """Check-to-variable messages R (B, E), alpha applied last."""
    B = Q.shape[0]
    m, dc = tables.m, tables.dc
    Qc = Q.view(B, m, dc)
    slots = range(dc)
    if cfg.method == "sum-product":
        t = [torch.tanh(Qc[:, :, j] * 0.5) for j in slots]
        others = _leave_one_out_product(t)
        R = [
            2.0 * torch.atanh(torch.clamp(o * ssign, -TANH_CLIP, TANH_CLIP))
            for o in others
        ]
    else:
        sgn = torch.where(Qc >= 0, 1.0, -1.0).to(Q.dtype)
        r_signs = _leave_one_out_product([sgn[:, :, j] for j in slots])
        aq = Qc.abs()
        min1 = aq.min(dim=-1, keepdim=True).values
        first = torch.nn.functional.one_hot(aq.argmin(dim=-1), dc).bool()
        min2 = torch.where(first, torch.inf, aq).min(dim=-1, keepdim=True).values
        mags = torch.where(aq == min1, min2, min1)
        if cfg.offset:
            mags = torch.clamp(mags - cfg.offset, min=0.0)
        R = [ssign * r_signs[j] * mags[:, :, j] for j in slots]
    R = torch.stack(R, dim=-1)
    if alpha != 1.0:
        R = R * alpha
    return R.reshape(B, m * dc)


def bp_flooding_plain(
    syndromes: torch.Tensor,
    priors: torch.Tensor,
    tables: BPTables,
    cfg: BPConfig,
    alpha: float | None = None,
):
    """Flooding BP in plain torch. ``priors`` (n,) or (B, n) sets the dtype;
    ``cfg`` supplies max_iter, method, alpha, offset, damping and clip_llr,
    and ``alpha`` overrides ``cfg.alpha``. Every iteration runs on every
    sample; converged samples are frozen.

    Returns ``(values (B, n), converged (B,) bool, iterations (B,) int32,
    hard (B, n) int8)``.
    """
    alpha = cfg.alpha if alpha is None else alpha
    B = syndromes.shape[0]
    n, m, dc = tables.n, tables.m, tables.dc
    dtype = priors.dtype
    dev = syndromes.device
    var_of_edge = tables.check_var.reshape(-1).long()
    var_edge = tables.var_edge.long()

    syn = syndromes.to(torch.int32)
    priors = priors.expand(B, n)
    ssign = (1 - 2 * syn).to(dtype)
    Q = priors[:, var_of_edge]
    values = priors.clone()
    hard = torch.zeros((B, n), dtype=torch.int8, device=dev)
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), cfg.max_iter - 1, dtype=torch.int32, device=dev)
    pad = torch.zeros((B, 1), dtype=dtype, device=dev)

    for it in range(cfg.max_iter):
        R = _check_messages(Q, ssign, tables, cfg, alpha)
        rv = torch.cat([R, pad], dim=1)[:, var_edge]  # (B, n, dv)
        vals = rv[..., 0]
        for k in range(1, rv.shape[-1]):
            vals = vals + rv[..., k]
        vals = vals + priors
        Qn = vals[:, var_of_edge] - R
        if cfg.damping != 1.0:
            Qn = cfg.damping * Qn + (1.0 - cfg.damping) * Q
        if cfg.clip_llr is not None:
            Qn = torch.clamp(Qn, -cfg.clip_llr, cfg.clip_llr)
        h = (vals < 0).to(torch.int8)
        s_hat = h[:, var_of_edge].view(B, m, dc).sum(dim=-1, dtype=torch.int32) % 2
        ok = (s_hat == syn).all(dim=-1)
        keep = conv[:, None]
        Q = torch.where(keep, Q, Qn)
        values = torch.where(keep, values, vals)
        hard = torch.where(keep, hard, h)
        iters = torch.where(conv, iters, torch.full_like(iters, it))
        conv = conv | ok
    return values, conv, iters, hard


def _samples_per_block(tables: BPTables) -> int:
    m, n, dc = tables.m, tables.n, tables.dc
    per_sample = 4 * (2 * m * dc + 2 * n) + n + m
    return max(1, min(_MAX_SAMPLES_PER_BLOCK, _SMEM_BUDGET // per_sample))


def bp_flooding_cuda(
    syndromes: torch.Tensor,
    priors: torch.Tensor,
    tables: BPTables,
    cfg: BPConfig,
    alpha: float | None = None,
):
    """Launch K1. Same contract as ``bp_flooding_plain``; float32 only."""
    dev = syndromes.device
    if dev.type != "cuda":
        raise ValueError("bp_flooding_cuda needs CUDA tensors")
    alpha = cfg.alpha if alpha is None else alpha
    if priors.dtype != torch.float32:
        raise TypeError(
            f"the CUDA BP kernel runs float32 only, got priors of {priors.dtype}"
        )
    if tables.dc > _MAX_DC:
        raise ValueError(f"check degree {tables.dc} exceeds the kernel's {_MAX_DC}")
    B = syndromes.shape[0]
    n, m = tables.n, tables.m
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
    syn = syndromes.to(torch.uint8).contiguous()
    priors = priors.contiguous()
    values = torch.empty((B, n), dtype=torch.float32, device=dev)
    conv = torch.empty(B, dtype=torch.uint8, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    alpha32 = float(alpha)
    _LIB.call(
        "bp_flooding_launch",
        syn.data_ptr(), priors.data_ptr(), prior_stride,
        tables.check_var.contiguous().data_ptr(),
        tables.var_edge.contiguous().data_ptr(),
        values.data_ptr(), conv.data_ptr(), iters.data_ptr(),
        B, m, n, tables.dc, tables.dv,
        0 if cfg.method == "sum-product" else 1,
        alpha32, int(alpha32 != 1.0),
        float(cfg.offset), int(bool(cfg.offset)),
        float(cfg.damping), float(1.0 - cfg.damping), int(cfg.damping != 1.0),
        float(cfg.clip_llr or 0.0), int(cfg.clip_llr is not None),
        cfg.max_iter, _samples_per_block(tables), _THREADS,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    bp_flooding_cuda.launches += 1
    hard = (values < 0).to(torch.int8)
    return values, conv.bool(), iters, hard


bp_flooding_cuda.launches = 0


def bp_flooding(syndromes, priors, tables: BPTables, cfg: BPConfig, alpha=None):
    """Flooding BP: plain torch for CPU tensors, K1 for CUDA tensors."""
    if syndromes.device.type == "cuda":
        return bp_flooding_cuda(syndromes, priors, tables, cfg, alpha)
    if syndromes.device.type != "cpu":
        raise ValueError(f"unsupported device {syndromes.device}")
    return bp_flooding_plain(syndromes, priors, tables, cfg, alpha)
