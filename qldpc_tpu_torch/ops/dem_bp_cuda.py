"""Flooding BP on irregular Tanner graphs (detector error models): the CUDA
kernel K3 and its plain torch version.

K3 (``csrc/dem_bp.cu``) replaces qldpc_tpu/ops/dem_bp_pallas.py::_check_kernel
and the variable-side fold around it; its header says what bounds it on the
card and how the design answers. K3 has two paths, chosen from the config
and the tables alone (``summary_path``): under the one-pass check rule
(``dc > 16``) it stores no R, only one word per slot and a summary per
(check, sample); the prefix x suffix rule and sum-product with damping keep
the message path, which stores Q and R. ``dem_bp_plain`` is the XLA slot
path of qldpc_tpu/decoders/bp.py (``_check_messages`` and ``_step`` on the
padded check-slot layout) written in torch:

  * check c owns ``dc = dc_max`` slots, its real edges first, phantoms after;
    a phantom is the neutral element of each rule (tanh 1.0, sign +1,
    |Q| +inf);
  * the check rule is the XLA path's choice: for ``dc > 16`` in float32 the
    one-pass forms (log-domain total-minus-one magnitudes with total-parity
    signs for sum-product, total-parity signs for min-sum), otherwise the
    exclusive prefix x suffix products;
  * the per-check sum of log magnitudes is folded sequentially in slot order
    so that the kernel can reproduce it (the XLA path's ``jnp.sum`` has its
    own order, so sum-product posteriors match the JAX package only within
    a tolerance; min-sum is exact arithmetic and matches bit for bit);
  * each posterior is a left fold over the variable's slots, in edge order,
    plus the prior; a mechanism in no detector keeps its bare prior;
  * a sample freezes at the first iteration whose hard decision reproduces
    its syndrome, with that iteration's index.

``cfg.stream_dtype="bfloat16"`` rounds the messages where the TPU kernel's
bf16 streams round them (qldpc_tpu/ops/dem_bp_pallas.py:95, :140, :323),
``rd(x)`` being round-to-nearest-even to bfloat16 and back to float32:
every iteration's Q is ``clip(rd(values[v]) - R_prev)`` (R starts at 0, so
the first is ``clip(rd(prior))``: the clip applies from the first iteration
on, as in that kernel), and each R is ``rd(rule(Q) * alpha)``; the
posteriors, decisions, convergence and iterations stay float32, the
posterior a left fold of the rounded R's plus the prior. The TPU kernel
pins phantom slots to 1e9, which rounds in bf16, where the port's phantoms
are the rules' neutral elements: on a check of degree 1 the two differ.

``dem_bp`` is the entry point: plain torch for CPU tensors, K3 for CUDA
tensors, never a fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from qldpc_tpu_torch.ops.tanner import TannerGraph
from qldpc_tpu_torch._build import KernelLibrary
from qldpc_tpu_torch.ops.bp_cuda import TANH_CLIP, _leave_one_out_product, round_bf16

if TYPE_CHECKING:
    from qldpc_tpu_torch.decoders.bp import BPConfig

__all__ = [
    "DEMTables",
    "dem_tables",
    "dem_bp",
    "dem_bp_plain",
    "dem_bp_cuda",
    "summary_path",
]

# above this check degree float32 BP takes the one-pass check rule
# (decoders/bp.py:245)
LARGE_DC = 16
_THREADS = 256

# the summary path unrolls a variable's slots in registers up to this degree
MAX_DV = 64

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LAUNCH_ARGS = [
    _vp, _vp, _i, _i, _vp, _vp, _vp,
    _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
    _i, _i, _i, _i, _i, _i,
    _f, _i, _f, _i, _f, _f, _i, _f, _i, _i, _i,
    _i, _vp,
]
_LIB = KernelLibrary(
    "dem_bp.cu",
    {"dem_bp_launch": _LAUNCH_ARGS,
     "dem_bp_words_launch": _LAUNCH_ARGS},
)


@dataclasses.dataclass(frozen=True)
class DEMTables:
    """Check-slot layout of an irregular Tanner graph (decoders/bp.py:142-159).

    var_of_slot (m, dc) int32: variable of each slot, 0 on phantoms (masked).
    slot_mask (m, dc) bool: True on real slots, which come first in a check.
    check_deg (m,) int32: real slots of each check.
    var_slots (n, dv) int32: each variable's flat slots (c*dc + j) in edge
      order, padded at the end with S = m*dc.
    """

    var_of_slot: torch.Tensor
    slot_mask: torch.Tensor
    check_deg: torch.Tensor
    var_slots: torch.Tensor

    @property
    def m(self) -> int:
        return self.var_of_slot.shape[0]

    @property
    def dc(self) -> int:
        return self.var_of_slot.shape[1]

    @property
    def n(self) -> int:
        return self.var_slots.shape[0]

    @property
    def dv(self) -> int:
        return self.var_slots.shape[1]


def dem_tables(g: TannerGraph) -> dict[str, np.ndarray]:
    """The DEMTables arrays of ``g`` as numpy, built without a loop over
    edges (a [[72,12,6]] DEM has 104k of them)."""
    S = g.m * g.dc_max
    ce = g.check_edge.reshape(-1)  # (S,) edge ids, phantom == E
    real = ce < g.num_edges
    var_of_slot = np.zeros(S, np.int32)
    var_of_slot[real] = g.var_of_edge[ce[real]]
    var_slots = np.where(
        g.var_edge < g.num_edges,
        g.check_slot_of_edge[np.minimum(g.var_edge, max(g.num_edges - 1, 0))],
        S,
    ).astype(np.int32)
    return dict(
        var_of_slot=var_of_slot.reshape(g.m, g.dc_max),
        slot_mask=real.reshape(g.m, g.dc_max),
        check_deg=np.bincount(g.check_of_edge, minlength=g.m).astype(np.int32),
        var_slots=var_slots,
    )


def _fold(x: torch.Tensor) -> torch.Tensor:
    """Sequential left fold over the last axis, keeping it as size 1."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc[..., None]


def _check_messages(Q, ssign, tables: DEMTables, cfg: BPConfig, alpha: float):
    """Check-to-variable messages R (B, m*dc) in slot space, alpha last."""
    B, dtype = Q.shape[0], Q.dtype
    m, dc = tables.m, tables.dc
    Qc = Q.view(B, m, dc)
    mask = tables.slot_mask
    ss = ssign[..., None]
    large = dc > LARGE_DC and dtype != torch.float64
    one = torch.ones((), dtype=dtype, device=Q.device)
    if cfg.method == "sum-product":
        tc = torch.where(mask, torch.tanh(Qc * 0.5), one)
        if large:
            s = torch.where(tc >= 0, one, -one)
            neg = (tc < 0).sum(-1, keepdim=True, dtype=torch.int32)
            total_sign = (1 - 2 * (neg % 2)).to(dtype)
            lt = torch.log(torch.clamp(tc.abs(), min=1e-15))
            others = torch.exp(_fold(lt) - lt) * total_sign * s
        else:
            others = torch.stack(
                _leave_one_out_product([tc[..., j] for j in range(dc)]), dim=-1
            )
        R = 2.0 * torch.atanh(torch.clamp(others * ss, -TANH_CLIP, TANH_CLIP))
    else:
        sc = torch.where(mask & (Qc < 0), -one, one)
        if large:
            neg = (sc < 0).sum(-1, keepdim=True, dtype=torch.int32)
            r_signs = (1 - 2 * (neg % 2)).to(dtype) * sc
        else:
            r_signs = torch.stack(
                _leave_one_out_product([sc[..., j] for j in range(dc)]), dim=-1
            )
        aq = torch.where(mask, Qc.abs(), one * torch.inf)
        min1 = aq.min(dim=-1, keepdim=True).values
        slots = torch.arange(dc, device=Q.device)
        first = slots == aq.argmin(dim=-1, keepdim=True)
        min2 = torch.where(first, torch.inf, aq).min(dim=-1, keepdim=True).values
        mags = torch.where(aq == min1, min2, min1)
        if cfg.offset:
            mags = torch.clamp(mags - cfg.offset, min=0.0)
        R = ss * r_signs * mags
    if alpha != 1.0:
        R = R * alpha
    return R.reshape(B, m * dc)


def _stream_bf16(cfg: BPConfig) -> bool:
    """Whether ``cfg`` asks for bf16 streams; refuses them with damping,
    which the TPU kernel does not take."""
    bf16 = cfg.stream_dtype == "bfloat16"
    if bf16 and cfg.damping != 1.0:
        raise ValueError("stream_dtype=bfloat16 takes no damping")
    return bf16


def dem_bp_plain(
    syndromes: torch.Tensor,
    priors: torch.Tensor,
    tables: DEMTables,
    cfg: BPConfig,
    alpha: float | None = None,
):
    """Flooding BP on the slot layout in plain torch. ``priors`` (n,) or
    (B, n) sets the dtype; ``cfg`` supplies max_iter, method, alpha, offset,
    damping and clip_llr, and ``alpha`` overrides ``cfg.alpha``. Each
    iteration runs on the samples that have not converged; a converged
    sample keeps the iteration it converged at. The loop stops once every
    sample has.

    Returns ``(values (B, n), converged (B,) bool, iterations (B,) int32,
    hard (B, n) int8)``.
    """
    alpha = cfg.alpha if alpha is None else alpha
    B = syndromes.shape[0]
    n, m, dc = tables.n, tables.m, tables.dc
    dtype = priors.dtype
    dev = syndromes.device
    vos = tables.var_of_slot.reshape(-1).long()
    var_slots = tables.var_slots.long()

    syn = syndromes.to(torch.int32)
    priors = priors.expand(B, n)
    ssign = (1 - 2 * syn).to(dtype)
    bf16 = _stream_bf16(cfg)
    if bf16:  # the rounded R carry; Q follows from it and the posteriors
        R = torch.zeros((B, m * dc), dtype=dtype, device=dev)
    else:
        Q = priors[:, vos]
    values = priors.clone()
    hard = torch.zeros((B, n), dtype=torch.int8, device=dev)
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), cfg.max_iter - 1, dtype=torch.int32, device=dev)

    for it in range(cfg.max_iter):
        # only the samples still running: each sample's arithmetic is its own
        act = torch.nonzero(~conv).flatten()
        if act.numel() == 0:
            break
        pa = priors[act]
        if bf16:
            Qa = round_bf16(values[act])[:, vos] - R[act]
            if cfg.clip_llr is not None:
                Qa = torch.clamp(Qa, -cfg.clip_llr, cfg.clip_llr)
        else:
            Qa = Q[act]
        Ra = _check_messages(Qa, ssign[act], tables, cfg, alpha)
        if bf16:
            Ra = round_bf16(Ra)
        pad = torch.zeros((act.numel(), 1), dtype=dtype, device=dev)
        rv = torch.cat([Ra, pad], dim=1)[:, var_slots]  # (A, n, dv)
        vals = _fold(rv)[..., 0] + pa
        h = (vals < 0).to(torch.int8)
        hs = torch.where(tables.slot_mask, h[:, vos].view(-1, m, dc), 0)
        ok = (hs.sum(dim=-1, dtype=torch.int32) % 2 == syn[act]).all(dim=-1)
        if bf16:
            R[act] = Ra
        else:
            Qn = vals[:, vos] - Ra
            if cfg.damping != 1.0:
                Qn = cfg.damping * Qn + (1.0 - cfg.damping) * Qa
            if cfg.clip_llr is not None:
                Qn = torch.clamp(Qn, -cfg.clip_llr, cfg.clip_llr)
            Q[act] = Qn
        values[act] = vals
        hard[act] = h
        iters[act] = it
        conv[act] = ok
    return values, conv, iters, hard


def summary_path(tables: DEMTables, cfg: BPConfig) -> bool:
    """Whether K3 runs without storing R: the one-pass check rule (every
    check's messages follow from its summary and the slot's own word),
    except sum-product with damping, whose update needs the old Q that its
    slot word no longer holds."""
    return tables.dc > LARGE_DC and not (cfg.method == "sum-product" and cfg.damping != 1.0)


def dem_bp_cuda(
    syndromes: torch.Tensor,
    priors: torch.Tensor,
    tables: DEMTables,
    cfg: BPConfig,
    alpha: float | None = None,
    *,
    _store_r: bool = False,
):
    """Launch K3. Same contract as ``dem_bp_plain``; float32 priors only,
    and ``cfg.stream_dtype="bfloat16"`` launches its bf16 instances. A NaN
    message (min-sum on a check of degree 1 sends an infinite magnitude, and
    the variable side's ``inf - inf`` gives NaN) propagates as through
    torch's ``min`` and ``clamp``. ``_store_r`` forces the message path
    where ``summary_path`` holds, to compare the two paths."""
    dev = syndromes.device
    if dev.type != "cuda":
        raise ValueError("dem_bp_cuda needs CUDA tensors")
    alpha = cfg.alpha if alpha is None else alpha
    if priors.dtype != torch.float32:
        raise TypeError(
            f"the CUDA DEM BP kernel runs float32 only, got priors of {priors.dtype}"
        )
    B = syndromes.shape[0]
    n, m, dc, dv = tables.n, tables.m, tables.dc, tables.dv
    words = summary_path(tables, cfg) and not _store_r
    if words and dv > MAX_DV:
        raise ValueError(f"variable degree {dv} exceeds the summary path's {MAX_DV}")
    if syndromes.shape != (B, m):
        raise ValueError(f"syndromes must be (B, {m}), got {tuple(syndromes.shape)}")
    if priors.shape == (n,):
        prior_t, ps_v, ps_b = priors.contiguous(), 1, 0
    elif priors.shape == (B, n):
        prior_t, ps_v, ps_b = priors.T.contiguous(), B, 1
    else:
        raise ValueError(f"priors must be ({n},) or ({B}, {n})")
    # contiguous operands bound to names: each must outlive the launch
    var_of_slot, check_deg, var_slots = index_tables = tuple(
        t.contiguous() for t in (tables.var_of_slot, tables.check_deg, tables.var_slots)
    )
    for t in (priors, *index_tables):
        if t.device != dev:
            raise ValueError("all BP operands must be on one device")
    if any(t.dtype != torch.int32 for t in index_tables):
        raise TypeError("DEM BP index tables must be int32")
    bf16 = _stream_bf16(cfg)
    S = m * dc
    syn_t = syndromes.to(torch.uint8).T.contiguous()  # (m, B)
    values = torch.empty((n, B), dtype=torch.float32, device=dev)
    hard = torch.empty((n, B), dtype=torch.uint8, device=dev)
    # the summary path: the slot words and the two summary planes (m, B);
    # the message path: Q and R in slot space, or under bf16 streams the
    # 16-bit R alone
    if words:
        Q = torch.empty((S, B), dtype=torch.float32, device=dev)
        R_or_summary = torch.empty((2 * m, B), dtype=torch.float32, device=dev)
    elif bf16:
        R_or_summary = torch.empty((S, B), dtype=torch.bfloat16, device=dev)
        Q = R_or_summary  # not read
    else:
        Q = torch.empty((S, B), dtype=torch.float32, device=dev)
        R_or_summary = torch.empty((S, B), dtype=torch.float32, device=dev)
    conv = torch.empty(B, dtype=torch.uint8, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    mismatch = torch.empty(B, dtype=torch.uint8, device=dev)
    active = torch.zeros(cfg.max_iter, dtype=torch.int32, device=dev)
    alpha32 = float(alpha)
    _LIB.call(
        "dem_bp_words_launch" if words else "dem_bp_launch",
        syn_t.data_ptr(), prior_t.data_ptr(), ps_v, ps_b,
        var_of_slot.data_ptr(), check_deg.data_ptr(), var_slots.data_ptr(),
        values.data_ptr(), hard.data_ptr(), Q.data_ptr(), R_or_summary.data_ptr(),
        conv.data_ptr(), iters.data_ptr(), mismatch.data_ptr(), active.data_ptr(),
        B, m, n, dc, dv,
        0 if cfg.method == "sum-product" else 1,
        alpha32, int(alpha32 != 1.0),
        float(cfg.offset), int(bool(cfg.offset)),
        float(cfg.damping), float(1.0 - cfg.damping), int(cfg.damping != 1.0),
        float(cfg.clip_llr or 0.0), int(cfg.clip_llr is not None), int(bf16),
        cfg.max_iter, _THREADS,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    dem_bp_cuda.launches += 1
    if bf16:
        dem_bp_cuda.bf16_launches += 1
    values = values.T.contiguous()
    return values, conv.bool(), iters, (values < 0).to(torch.int8)


dem_bp_cuda.launches = 0
dem_bp_cuda.bf16_launches = 0  # the launches of the bf16-stream instances


def dem_bp(syndromes, priors, tables: DEMTables, cfg: BPConfig, alpha=None):
    """DEM flooding BP: plain torch for CPU tensors, K3 for CUDA tensors."""
    if syndromes.device.type == "cuda":
        return dem_bp_cuda(syndromes, priors, tables, cfg, alpha)
    if syndromes.device.type != "cpu":
        raise ValueError(f"unsupported device {syndromes.device}")
    return dem_bp_plain(syndromes, priors, tables, cfg, alpha)
