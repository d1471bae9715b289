"""Batched GF(2) elimination: the CUDA kernel K2 and its plain torch version.

K2 (``csrc/gf2_elim.cu``) replaces qldpc_tpu/ops/osd_pallas.py::_elim_kernel;
its header says what bounds it on the card and how the design answers.
``eliminate_rows_plain`` is qldpc_tpu/decoders/osd.py::_eliminate_lanes in
torch, sample-major: same first-hit pivoting, row swap and full elimination.

Words are int32 tensors holding uint32 bit patterns (torch's uint32 support
is thin); column j of a row is bit j % 32 of word j // 32. Bits are read
with ``(x >> bit) & 1``, which is right for bit 31 under the arithmetic
shift of int32 too.

``eliminate`` keeps the JAX lanes layout, A (m, n_words, B) and b (m, B);
``eliminate_rows`` is the sample-major form the OSD decoder calls. Both take
the plain version for CPU tensors and launch K2 for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from qldpc_tpu_torch._build import KernelLibrary

__all__ = [
    "WORD",
    "pack_rows",
    "eliminate",
    "eliminate_rows",
    "eliminate_rows_plain",
    "eliminate_rows_cuda",
]

WORD = 32
_SMEM_BUDGET = 48 * 1024
_MAX_WARPS = 8

_vp, _i = ctypes.c_void_p, ctypes.c_int
_LIB = KernelLibrary(
    "gf2_elim.cu",
    {"gf2_elim_launch": [_vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _vp]},
)


def pack_rows(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) 0/1 -> (..., n_words) int32 words, column j at word j // 32,
    bit j % 32. Words are summed in int64 and wrapped to int32."""
    n = bits.shape[-1]
    nw = -(-n // WORD)
    x = torch.nn.functional.pad(bits.to(torch.int64), (0, nw * WORD - n))
    x = x.reshape(*bits.shape[:-1], nw, WORD)
    shifts = torch.arange(WORD, dtype=torch.int64, device=bits.device)
    words = (x << shifts).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def eliminate_rows_plain(A: torch.Tensor, b: torch.Tensor, n: int,
                         max_rank: int | None = None):
    """Full RREF of packed systems, sample-major, in plain torch.

    A (B, m, n_words) int32 words, b (B, m) int32 0/1. Returns
    ``(A_rref, b_rref, piv_col (B, m) int32)``; piv_col is -1 for rows
    without a pivot. Stops once every sample's rank reaches ``max_rank``
    (default m): for a column permutation of a matrix of that rank, later
    column steps could not change anything.
    """
    B, m, nw = A.shape
    max_rank = m if max_rank is None else max_rank
    dev = A.device
    A = A.clone()
    b = b.clone()
    rows = torch.arange(m, device=dev)[None, :]
    bidx = torch.arange(B, device=dev)
    rank = torch.zeros(B, dtype=torch.long, device=dev)
    piv = torch.full((B, m), -1, dtype=torch.int32, device=dev)
    for col in range(n):
        if col % WORD == 0 and bool((rank >= max_rank).all()):
            break
        w, bit = col // WORD, col % WORD
        cand = (
            (((A[:, :, w] >> bit) & 1) == 1)
            & (rows >= rank[:, None])
            & (rank < max_rank)[:, None]
        )
        has = cand.any(dim=1)
        p = cand.to(torch.int8).argmax(dim=1)  # first eligible row
        r = rank.clamp(max=m - 1)
        row_p, row_r = A[bidx, p], A[bidx, r]
        b_p, b_r = b[bidx, p], b[bidx, r]
        hs = has[:, None]
        # swap rows p and r where a pivot exists (p == r swaps nothing)
        A[bidx, p] = torch.where(hs, row_r, row_p)
        A[bidx, r] = torch.where(hs, row_p, row_r)
        b[bidx, p] = torch.where(has, b_r, b_p)
        b[bidx, r] = torch.where(has, b_p, b_r)
        # XOR the pivot row into every other row holding the bit
        elim = (((A[:, :, w] >> bit) & 1) == 1) & (rows != r[:, None]) & hs
        prow, pb = A[bidx, r], b[bidx, r]
        A = torch.where(elim[:, :, None], A ^ prow[:, None, :], A)
        b = torch.where(elim, b ^ pb[:, None], b)
        piv[bidx, r] = torch.where(has, col, piv[bidx, r])
        rank = rank + has.long()
    return A, b, piv


def _warps_per_block(m: int, nw: int) -> int:
    per_warp = 4 * (m * (nw | 1) + 2 * m)
    return max(1, min(_MAX_WARPS, _SMEM_BUDGET // per_warp))


def eliminate_rows_cuda(A: torch.Tensor, b: torch.Tensor, n: int,
                        max_rank: int | None = None):
    """Launch K2. Same contract as ``eliminate_rows_plain``."""
    dev = A.device
    if dev.type != "cuda" or b.device != dev:
        raise ValueError("eliminate_rows_cuda needs A and b on one CUDA device")
    if A.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("packed words and b must be int32")
    B, m, nw = A.shape
    if b.shape != (B, m):
        raise ValueError(f"b must be ({B}, {m}), got {tuple(b.shape)}")
    if nw * WORD < n:
        raise ValueError(f"{nw} words cannot hold {n} columns")
    max_rank = m if max_rank is None else max_rank
    A = A.contiguous().clone()
    b = b.contiguous().clone()
    piv = torch.empty((B, m), dtype=torch.int32, device=dev)
    _LIB.call(
        "gf2_elim_launch",
        A.data_ptr(), b.data_ptr(), piv.data_ptr(),
        B, m, nw, n, max_rank, _warps_per_block(m, nw),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    eliminate_rows_cuda.launches += 1
    return A, b, piv


eliminate_rows_cuda.launches = 0


def eliminate_rows(A: torch.Tensor, b: torch.Tensor, n: int,
                   max_rank: int | None = None):
    """Sample-major RREF: plain torch for CPU tensors, K2 for CUDA tensors."""
    if A.device.type == "cuda":
        return eliminate_rows_cuda(A, b, n, max_rank)
    if A.device.type != "cpu":
        raise ValueError(f"unsupported device {A.device}")
    return eliminate_rows_plain(A, b, n, max_rank)


def eliminate(A: torch.Tensor, b: torch.Tensor, n: int,
              max_rank: int | None = None):
    """Full GF(2) RREF in the JAX lanes layout.

    A (m, n_words, B) int32 words, b (m, B) int32; n = logical column count.
    Returns ``(A_rref (m, n_words, B), b_rref (m, B), piv_col (m, B) int32)``,
    the contract of qldpc_tpu/ops/osd_pallas.py::eliminate_pallas.
    """
    A2, b2, piv = eliminate_rows(
        A.permute(2, 0, 1).contiguous(), b.T.contiguous(), n, max_rank
    )
    return A2.permute(1, 2, 0).contiguous(), b2.T.contiguous(), piv.T.contiguous()
