"""Structured space-time BP: the CUDA kernel K6 and its plain torch version.

K6 (``csrc/spacetime_bp.cu``) replaces
qldpc_tpu/ops/spacetime_bp_pallas.py::_st_bp_kernel; its header says what
bounds it on the card and how the design answers. ``st_bp_plain`` is
qldpc_tpu/decoders/spacetime_bp.py::SpaceTimeBPDecoder._build in torch,
in the same floating-point order. Both run flooding BP on
``H_st = [I_T (x) H | I + S_{-m}]`` without building it:

  * the spatial messages of round t use the base code's tables;
  * each check has two temporal slots after its dc spatial ones, u_t and
    u_{t-1}; the u_{t-1} slot of round 0 is a phantom pinned to 1e9
    (tanh gives 1, min-sum never picks it);
  * the temporal variable update is a shift: u_t meets check t through its
    first temporal slot and check t+1 through its second;
  * the syndrome check is ``H hard_t + hard_u(t) + hard_u(t-1)``.

The output is in ``space_time_matrix``'s column order: the T*n data
variables, then the T*m measurement variables.

``st_bp`` is the entry point: the plain version for CPU tensors, K6 for
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

__all__ = ["BIG", "st_bp", "st_bp_plain", "st_bp_cuda", "smem_per_sample", "launch_shape"]

BIG = 1e9  # the phantom u_{t-1} slot of round 0
# dynamic shared memory one block may opt in to on sm_90 (227 KB), less the
# kernel's static flags
_SMEM_LIMIT = 227 * 1024 - 512
# a sample up to this size keeps one block (C = 1), with as many samples as
# fit _SMEM_BUDGET; a larger one spreads over a cluster of about
# _ROUNDS_PER_BLOCK rounds a block
_SMALL_SAMPLE = 24 * 1024
_SMEM_BUDGET = 72 * 1024
_ROUNDS_PER_BLOCK = 3
_MAX_CLUSTER = 8  # the portable cluster size
_MAX_SAMPLES_PER_BLOCK = 16
_MAX_THREADS = 512
_MAX_DC = 30  # dc + 2 slots per check

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = KernelLibrary(
    "spacetime_bp.cu",
    {
        "st_bp_launch": [
            _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
            _i, _i, _i, _i, _i, _i, _i,
            _f, _i, _f, _i, _f, _f, _i, _f, _i, _i,
            _i, _i, _i, _vp,
        ]
    },
)


def st_bp_plain(detectors: torch.Tensor, priors: torch.Tensor, tables: BPTables,
                n_rounds: int, cfg: BPConfig, alpha: float | None = None):
    """Structured space-time BP in plain torch.

    detectors (B, T*m) 0/1; priors (T*n + T*m,) set the dtype; ``tables``
    are the base code's; ``cfg`` supplies max_iter, method, alpha, offset,
    damping and clip_llr, and ``alpha`` overrides ``cfg.alpha``. Every
    iteration runs on every sample; converged samples are frozen.

    Returns ``(values (B, T*n + T*m), converged (B,) bool, iterations (B,)
    int32, hard (B, T*n + T*m) int8)``.
    """
    alpha = cfg.alpha if alpha is None else alpha
    B, T = detectors.shape[0], n_rounds
    m, n, dc = tables.m, tables.n, tables.dc
    E = m * dc
    dtype, dev = priors.dtype, detectors.device
    var_of_edge = tables.check_var.reshape(-1).long()
    var_edge = tables.var_edge.long()

    syn = detectors.to(torch.int32).reshape(B, T, m)
    ssign = (1 - 2 * syn).to(dtype)
    prior_sp = priors[: T * n].reshape(T, n).expand(B, T, n)
    prior_u = priors[T * n:].reshape(T, m).expand(B, T, m)
    big = torch.full((B, 1, m), BIG, dtype=dtype, device=dev)
    zero_round = torch.zeros((B, 1, m), dtype=dtype, device=dev)
    Qs = prior_sp[:, :, var_of_edge]  # (B, T, E)
    Qa = prior_u.clone()
    Qb = torch.cat([big, prior_u[:, :-1]], dim=1)
    values_sp, values_u = prior_sp.clone(), prior_u.clone()
    conv = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.full((B,), cfg.max_iter - 1, dtype=torch.int32, device=dev)
    pad = torch.zeros((B, T, 1), dtype=dtype, device=dev)
    d = cfg.damping

    for it in range(cfg.max_iter):
        qq = torch.cat([Qs.view(B, T, m, dc), Qa[..., None], Qb[..., None]], dim=-1)
        R = check_rule(qq, ssign, cfg, alpha)  # (B, T, m, dc + 2)
        R_sp = R[..., :dc].reshape(B, T, E)
        R_a, R_b = R[..., dc], R[..., dc + 1]

        # spatial variables: each round gathers through the base tables
        rv = torch.cat([R_sp, pad], dim=-1)[:, :, var_edge]  # (B, T, n, dv)
        vals = rv[..., 0]
        for k in range(1, rv.shape[-1]):
            vals = vals + rv[..., k]
        vals = vals + prior_sp
        Qs_new = vals[:, :, var_of_edge] - R_sp

        # temporal variables: u_t meets check t (R_a[t]) and check t+1
        # (R_b[t+1]), a shift by one round
        r_b_next = torch.cat([R_b[:, 1:], zero_round], dim=1)
        vals_u = R_a + r_b_next + prior_u
        Qa_new = vals_u - R_a
        Qb_tail = vals_u[:, :-1] - R_b[:, 1:]
        if d != 1.0:
            Qs_new = d * Qs_new + (1.0 - d) * Qs
            Qa_new = d * Qa_new + (1.0 - d) * Qa
            Qb_tail = d * Qb_tail + (1.0 - d) * Qb[:, 1:]
        if cfg.clip_llr is not None:
            c = cfg.clip_llr
            Qs_new = torch.clamp(Qs_new, -c, c)
            Qa_new = torch.clamp(Qa_new, -c, c)
            Qb_tail = torch.clamp(Qb_tail, -c, c)
        Qb_new = torch.cat([big, Qb_tail], dim=1)

        # structured syndrome check: H hard_t + hard_u(t) + hard_u(t-1)
        h_sp = (vals < 0).to(torch.int32)
        h_u = (vals_u < 0).to(torch.int32)
        h_prev = torch.cat([torch.zeros_like(h_u[:, :1]), h_u[:, :-1]], dim=1)
        s_hat = (h_sp[:, :, var_of_edge].view(B, T, m, dc).sum(dim=-1) + h_u + h_prev) % 2
        ok = (s_hat == syn).flatten(1).all(dim=1)

        keep = conv[:, None, None]
        Qs = torch.where(keep, Qs, Qs_new)
        Qa = torch.where(keep, Qa, Qa_new)
        Qb = torch.where(keep, Qb, Qb_new)
        values_sp = torch.where(keep, values_sp, vals)
        values_u = torch.where(keep, values_u, vals_u)
        iters = torch.where(conv, iters, torch.full_like(iters, it))
        conv = conv | ok

    values = torch.cat([values_sp.reshape(B, T * n), values_u.reshape(B, T * m)], dim=1)
    return values, conv, iters, (values < 0).to(torch.int8)


def smem_per_sample(tables: BPTables, n_rounds: int) -> int:
    """Shared memory one sample holds in K6: Q and R on the T*m*(dc + 2)
    slots, the T*(n + m) posteriors, the hard decisions and the syndrome."""
    T, m, n, dc = n_rounds, tables.m, tables.n, tables.dc
    return 4 * (2 * T * m * dc + 5 * T * m + T * n) + T * n + 2 * T * m


def _smem_per_block(tables: BPTables, rounds: int, samples: int) -> int:
    """Shared memory of one block holding ``rounds`` rounds of ``samples``
    samples, with the two halos of m floats a sample."""
    return samples * (smem_per_sample(tables, rounds) + 8 * tables.m)


def launch_shape(tables: BPTables, n_rounds: int, cluster: int | None = None,
                 threads: int | None = None) -> tuple[int, int, int]:
    """K6's geometry: ``(samples a cluster, cluster width C, threads a
    block)``. C comes from T and a sample's state: 1 for a sample of at most
    24 KB (several samples a block), else about three rounds a block, at
    most 8 blocks and T; ``cluster`` overrides C (clamped to T) and
    ``threads`` the thread count, which is otherwise a thread per data
    variable of a block's rounds, at most 512."""
    T = n_rounds
    per = smem_per_sample(tables, T)
    if cluster is None:
        cluster = 1 if per <= _SMALL_SAMPLE else -(-T // _ROUNDS_PER_BLOCK)
    C = max(1, min(cluster, T, _MAX_CLUSTER))
    S = 1 if C > 1 else max(1, min(_MAX_SAMPLES_PER_BLOCK, _SMEM_BUDGET // per))
    rounds = -(-T // C)
    if threads is None:
        threads = min(_MAX_THREADS, max(64, 32 * -(-S * rounds * tables.n // 32)))
    smem = _smem_per_block(tables, rounds, S)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"a block's state takes {smem} bytes of shared memory at cluster width {C}, "
            f"over the {_SMEM_LIMIT} one block can hold"
        )
    return S, C, threads


def st_bp_cuda(detectors: torch.Tensor, priors: torch.Tensor, tables: BPTables,
               n_rounds: int, cfg: BPConfig, alpha: float | None = None, *,
               _cluster: int | None = None, _threads: int | None = None):
    """Launch K6. Same contract as ``st_bp_plain``; float32 only.
    ``_cluster`` and ``_threads`` override ``launch_shape``'s choice (for
    the tests and probes)."""
    dev = detectors.device
    if dev.type != "cuda":
        raise ValueError("st_bp_cuda needs CUDA tensors")
    alpha = cfg.alpha if alpha is None else alpha
    if priors.dtype != torch.float32:
        raise TypeError(f"the CUDA space-time BP kernel runs float32 only, got {priors.dtype}")
    T, m, n = n_rounds, tables.m, tables.n
    if tables.dc > _MAX_DC:
        raise ValueError(f"check degree {tables.dc} exceeds the kernel's {_MAX_DC}")
    S, C, threads = launch_shape(tables, T, _cluster, _threads)
    B = detectors.shape[0]
    if detectors.shape != (B, T * m):
        raise ValueError(f"detectors must be (B, {T * m}), got {tuple(detectors.shape)}")
    if priors.shape != (T * (n + m),):
        raise ValueError(f"priors must be ({T * (n + m)},), got {tuple(priors.shape)}")
    for t in (priors, tables.check_var, tables.var_edge):
        if t.device != dev:
            raise ValueError("all BP operands must be on one device")
    if tables.check_var.dtype != torch.int32 or tables.var_edge.dtype != torch.int32:
        raise TypeError("BP tables must be int32")
    # contiguous operands bound to names: each must outlive the launch
    syn = detectors.to(torch.uint8).contiguous()
    priors = priors.contiguous()
    check_var = tables.check_var.contiguous()
    var_edge = tables.var_edge.contiguous()
    values = torch.empty((B, T * (n + m)), dtype=torch.float32, device=dev)
    conv = torch.empty(B, dtype=torch.uint8, device=dev)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    alpha32 = float(alpha)
    _LIB.call(
        "st_bp_launch",
        syn.data_ptr(), priors.data_ptr(), priors[T * n:].data_ptr(),
        check_var.data_ptr(), var_edge.data_ptr(),
        values.data_ptr(), conv.data_ptr(), iters.data_ptr(),
        B, T, m, n, tables.dc, tables.dv,
        0 if cfg.method == "sum-product" else 1,
        alpha32, int(alpha32 != 1.0),
        float(cfg.offset), int(bool(cfg.offset)),
        float(cfg.damping), float(1.0 - cfg.damping), int(cfg.damping != 1.0),
        float(cfg.clip_llr or 0.0), int(cfg.clip_llr is not None),
        cfg.max_iter, S, C, threads,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    st_bp_cuda.launches += 1
    return values, conv.bool(), iters, (values < 0).to(torch.int8)


st_bp_cuda.launches = 0


def st_bp(detectors, priors, tables: BPTables, n_rounds: int, cfg: BPConfig, alpha=None):
    """Space-time BP: plain torch for CPU tensors, K6 for CUDA tensors."""
    if detectors.device.type == "cuda":
        return st_bp_cuda(detectors, priors, tables, n_rounds, cfg, alpha)
    if detectors.device.type != "cpu":
        raise ValueError(f"unsupported device {detectors.device}")
    return st_bp_plain(detectors, priors, tables, n_rounds, cfg, alpha)
