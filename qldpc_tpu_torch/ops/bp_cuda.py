"""Fused flooding BP: the CUDA kernel K1 and its plain torch version.

K1 (``csrc/bp_flooding.cu``) replaces qldpc_tpu/ops/bp_pallas.py::_bp_kernel;
its header says what bounds it on the card and how the design answers (one
warp a sample, samples from a work counter; ``launch_warps`` picks the warps
a block from what the shared memory holds).
``bp_flooding_plain`` is the flooding path of qldpc_tpu/decoders/bp.py
(``_check_messages`` and ``_step``) written in torch with the same
floating-point order: the leave-one-out tanh product is an exclusive prefix
times an exclusive suffix product, each folded sequentially; posteriors are a
left fold over each variable's edges plus the prior.

``cfg.mm_dtype="bfloat16"`` rounds the messages where the TPU kernel's bf16
matmul operands round them (qldpc_tpu/ops/bp_pallas.py:296-364), ``rd(x)``
being round-to-nearest-even to bfloat16 and back to float32: the first Q of
an edge is ``rd(prior)``, the posterior the float32 fold of ``rd(R)`` plus
the prior, the next Q ``rd(posterior) - R`` with R unrounded, then damping
against the old Q and the clip; decisions and convergence read the float32
posterior.

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
    "check_rule",
    "launch_warps",
    "launch_grid",
    "bp_flooding",
    "bp_flooding_plain",
    "bp_flooding_cuda",
]

TANH_CLIP = 0.9999999
_WARPS_PER_BLOCK = 8
_SMEM_PER_BLOCK = 227 * 1024  # what one block may have on the H100
_MAX_DC = 32

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = KernelLibrary(
    "bp_flooding.cu",
    {
        "bp_flooding_launch": [
            _vp, _vp, _i, _vp, _vp, _vp, _vp, _vp, _vp,
            _i, _i, _i, _i, _i, _i,
            _f, _i, _f, _i, _f, _f, _i, _f, _i, _i, _i,
            _i, _vp,
        ],
        "bp_flooding_grid": [_i] * 8,
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


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to nearest even in bfloat16, back in its own dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


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


def check_rule(qc: torch.Tensor, ssign: torch.Tensor, cfg: BPConfig,
               alpha: float) -> torch.Tensor:
    """Check-to-variable messages on check groups ``qc`` (..., k), every
    slot a real edge; ``ssign`` (...) is each check's syndrome sign. The
    leave-one-out tanh product (sum-product) or the sign product and two
    minima (min-sum, optional offset), alpha applied last."""
    k = qc.shape[-1]
    slots = range(k)
    if cfg.method == "sum-product":
        t = [torch.tanh(qc[..., j] * 0.5) for j in slots]
        others = _leave_one_out_product(t)
        R = [
            2.0 * torch.atanh(torch.clamp(o * ssign, -TANH_CLIP, TANH_CLIP))
            for o in others
        ]
    else:
        sgn = torch.where(qc >= 0, 1.0, -1.0).to(qc.dtype)
        r_signs = _leave_one_out_product([sgn[..., j] for j in slots])
        aq = qc.abs()
        min1 = aq.min(dim=-1, keepdim=True).values
        first = torch.nn.functional.one_hot(aq.argmin(dim=-1), k).bool()
        min2 = torch.where(first, torch.inf, aq).min(dim=-1, keepdim=True).values
        mags = torch.where(aq == min1, min2, min1)
        if cfg.offset:
            mags = torch.clamp(mags - cfg.offset, min=0.0)
        R = [ssign * r_signs[j] * mags[..., j] for j in slots]
    R = torch.stack(R, dim=-1)
    if alpha != 1.0:
        R = R * alpha
    return R


def _check_messages(Q, ssign, tables: BPTables, cfg: BPConfig, alpha: float):
    """Check-to-variable messages R (B, E), alpha applied last."""
    B = Q.shape[0]
    return check_rule(Q.view(B, tables.m, tables.dc), ssign, cfg, alpha).reshape(B, -1)


def bp_flooding_plain(
    syndromes: torch.Tensor,
    priors: torch.Tensor,
    tables: BPTables,
    cfg: BPConfig,
    alpha: float | None = None,
):
    """Flooding BP in plain torch. ``priors`` (n,) or (B, n) sets the dtype;
    ``cfg`` supplies max_iter, method, alpha, offset, damping, clip_llr and
    mm_dtype, and ``alpha`` overrides ``cfg.alpha``. Every iteration runs on
    every sample; converged samples are frozen.

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
    if cfg.mm_dtype == "bfloat16":
        rd = round_bf16
    else:
        def rd(x):
            return x
    Q = rd(priors)[:, var_of_edge]
    values = priors.clone()
    hard = torch.zeros((B, n), dtype=torch.int8, device=dev)
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), cfg.max_iter - 1, dtype=torch.int32, device=dev)
    pad = torch.zeros((B, 1), dtype=dtype, device=dev)

    for it in range(cfg.max_iter):
        R = _check_messages(Q, ssign, tables, cfg, alpha)
        rv = torch.cat([rd(R), pad], dim=1)[:, var_edge]  # (B, n, dv)
        vals = rv[..., 0]
        for k in range(1, rv.shape[-1]):
            vals = vals + rv[..., k]
        vals = vals + priors
        Qn = rd(vals)[:, var_of_edge] - R
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


def launch_warps(m: int, n: int, dc: int, shared_priors: bool) -> int:
    """K1's warps a block, one sample each: eight, or what a block's shared
    memory holds of the warps' slices (Q, R, the posteriors, the priors
    unless every sample shares them, the syndrome bytes) beside what shared
    priors add once a block (the priors, and the first iteration's check
    messages for either syndrome bit, 2 m dc floats). Raises when not one
    slice fits."""
    def pad(x):
        return (x + 3) & ~3

    per_warp = 4 * pad(2 * m * dc + n + (0 if shared_priors else n) + (m + 3) // 4)
    room = _SMEM_PER_BLOCK - (4 * (pad(n) + 2 * m * dc) if shared_priors else 0)
    warps = min(_WARPS_PER_BLOCK, room // per_warp)
    if warps < 1:
        raise ValueError(f"one sample's state ({per_warp} bytes) exceeds a block's shared memory")
    return warps


def launch_grid(B: int, tables: BPTables, shared_priors: bool) -> tuple[int, int]:
    """(warps a block, blocks) of K1's persistent grid of float32 operands
    for B samples on the current CUDA device: the blocks the samples need, at
    most what its SMs hold at once."""
    warps = launch_warps(tables.m, tables.n, tables.dc, shared_priors)
    blocks = _LIB.lib.bp_flooding_grid(B, tables.m, tables.n, tables.dc, tables.dv,
                                       int(shared_priors), 0, warps)
    if blocks < 0:
        raise RuntimeError(f"bp_flooding.cu::bp_flooding_grid failed with cudaError {-blocks}")
    return warps, blocks


def bp_flooding_cuda(
    syndromes: torch.Tensor,
    priors: torch.Tensor,
    tables: BPTables,
    cfg: BPConfig,
    alpha: float | None = None,
):
    """Launch K1. Same contract as ``bp_flooding_plain``; float32 priors
    only, and ``cfg.mm_dtype="bfloat16"`` launches its bf16 instances."""
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
    warps = launch_warps(m, n, tables.dc, prior_stride == 0)
    bf16 = cfg.mm_dtype == "bfloat16"
    # contiguous operands bound to names: each must outlive the launch
    syn = syndromes.to(torch.uint8).contiguous()
    priors = priors.contiguous()
    check_var, var_edge = tables.check_var.contiguous(), tables.var_edge.contiguous()
    values = torch.empty((B, n), dtype=torch.float32, device=dev)
    conv = torch.empty(B, dtype=torch.uint8, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    counter = torch.empty(1, dtype=torch.int32, device=dev)
    alpha32 = float(alpha)
    _LIB.call(
        "bp_flooding_launch",
        syn.data_ptr(), priors.data_ptr(), prior_stride,
        check_var.data_ptr(), var_edge.data_ptr(),
        values.data_ptr(), conv.data_ptr(), iters.data_ptr(), counter.data_ptr(),
        B, m, n, tables.dc, tables.dv,
        0 if cfg.method == "sum-product" else 1,
        alpha32, int(alpha32 != 1.0),
        float(cfg.offset), int(bool(cfg.offset)),
        float(cfg.damping), float(1.0 - cfg.damping), int(cfg.damping != 1.0),
        float(cfg.clip_llr or 0.0), int(cfg.clip_llr is not None), int(bf16),
        cfg.max_iter, warps,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    bp_flooding_cuda.launches += 1
    if bf16:
        bp_flooding_cuda.bf16_launches += 1
    hard = (values < 0).to(torch.int8)
    return values, conv.bool(), iters, hard


bp_flooding_cuda.launches = 0
bp_flooding_cuda.bf16_launches = 0  # the launches of the bf16-operand instances


def bp_flooding(syndromes, priors, tables: BPTables, cfg: BPConfig, alpha=None):
    """Flooding BP: plain torch for CPU tensors, K1 for CUDA tensors."""
    if syndromes.device.type == "cuda":
        return bp_flooding_cuda(syndromes, priors, tables, cfg, alpha)
    if syndromes.device.type != "cpu":
        raise ValueError(f"unsupported device {syndromes.device}")
    return bp_flooding_plain(syndromes, priors, tables, cfg, alpha)
