"""Batched GF(2) elimination: the CUDA kernel K2 and its plain torch version.

K2 (``csrc/gf2_elim.cu``) replaces qldpc_tpu/ops/osd_pallas.py::_elim_kernel;
its header says what bounds it on the card and how the design answers.
``eliminate_rows_plain`` is qldpc_tpu/decoders/osd.py::_eliminate_lanes in
torch, sample-major: same first-hit pivoting, row swap and full elimination.
K2 has two instances, chosen from the shape alone (``launch_instance``): the
columns a lane owns in registers (``REG_INSTANCES``: up to the [[288,12,18]]
code's 144 x 288), or the rows in shared memory for the larger systems whose
rows fit one warp's share (``shared_instance_bytes``).

Words are int32 tensors holding uint32 bit patterns (torch's uint32 support
is thin); column j of a row is bit j % 32 of word j // 32. Bits are read
with ``(x >> bit) & 1``, which is right for bit 31 under the arithmetic
shift of int32 too.

``eliminate`` keeps the JAX lanes layout, A (m, n_words, B) and b (m, B);
``eliminate_rows`` is the sample-major form on packed rows, whose reduced
rows A the OSD-e search reads (``pack_permuted_rows`` builds them for the
samples it searches); ``eliminate_ordered`` the one the OSD decoder calls
for every sample: H's packed columns (``osd_transform_cuda.pack_columns``)
read in each sample's column order, with (b, piv_col) alone returned, so
that no permuted copy of H is built. Each takes the plain
version for CPU tensors and launches K2 for CUDA tensors. b holds 0/1.
"""

from __future__ import annotations

import ctypes

import torch

from qldpc_tpu_torch._build import KernelLibrary

__all__ = [
    "WORD",
    "pack_rows",
    "pack_permuted_rows",
    "rows_smem_bytes",
    "ROWS_SMEM_LIMIT",
    "eliminate",
    "eliminate_rows",
    "eliminate_rows_plain",
    "eliminate_rows_cuda",
    "eliminate_ordered",
    "eliminate_ordered_plain",
    "eliminate_ordered_cuda",
    "REG_INSTANCES",
    "launch_instance",
    "shared_instance_bytes",
]

WORD = 32
# dynamic shared memory one K2 block may opt in to on sm_90 (227 KB); a
# system whose packed rows exceed it in one warp cannot run on K2
ROWS_SMEM_LIMIT = 227 * 1024
# K2's register instances as (words a column, columns a lane): Steane, the
# [[72]]-[[108]] codes, [[144,12,12]] and [[288,12,18]] at code capacity
REG_INSTANCES = ((1, 1), (2, 4), (3, 5), (5, 9))

_vp, _i = ctypes.c_void_p, ctypes.c_int
_LIB = KernelLibrary(
    "gf2_elim.cu",
    {
        "gf2_elim_rows_launch": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _vp],
        "gf2_elim_ordered_launch": [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _vp],
    },
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


def pack_permuted_rows(order: torch.Tensor, Hc: torch.Tensor, m: int) -> torch.Tensor:
    """The packed rows (B, m, ceil(n / 32)) of H[:, order[s]] for each sample
    s, from H's packed columns Hc (n, mw) (``osd_transform_cuda.pack_columns``)."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=Hc.device)
    cols = (Hc[order.long()][..., None] >> shifts) & 1  # (B, n, mw, 32)
    return pack_rows(cols.reshape(*order.shape, -1)[..., :m].transpose(1, 2))


def eliminate_rows_plain(A: torch.Tensor, b: torch.Tensor, n: int,
                         max_rank: int | None = None):
    """Full RREF of packed systems, sample-major, in plain torch.

    A (B, m, n_words) int32 words, b (B, m) int32 0/1. Returns
    ``(A_rref, b_rref, piv_col (B, m) int32)``; piv_col is -1 for rows
    without a pivot. b outside {0, 1} is outside the contract: this
    version XORs whole b values, K2 reads bit 0 of each and writes 0/1, so
    the two agree only on 0/1. Stops once every sample's rank reaches ``max_rank``
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


def rows_smem_bytes(m: int, nw: int) -> int:
    """A sample's packed rows at an odd word stride, b and piv_col: the
    systems within ROWS_SMEM_LIMIT of it are the OSD decoder's rows path."""
    return 4 * (m * (nw | 1) + 2 * m)


def shared_instance_bytes(m: int, nw: int) -> int:
    """Shared memory of one warp of K2's shared instance: the rows at an odd
    word stride, b and a pivot column (a word a row group each) and two
    uint16 tables of m entries (at most ``rows_smem_bytes`` from m = 2)."""
    return 4 * (m * (nw | 1) + 2 * -(-m // WORD) + m)


def launch_instance(m: int, nw: int) -> int:
    """The K2 instance a system of m rows and nw words a row takes (the
    packed rows' nw, or ceil(n / 32) for the ordered loader), from its shape
    alone: the index of the first register instance holding ceil(m / 32)
    words a column and nw columns a lane, else -1, the shared instance.
    Raises where neither holds the system."""
    mw = -(-m // WORD)
    for i, (words, cols) in enumerate(REG_INSTANCES):
        if mw <= words and nw <= cols:
            return i
    if shared_instance_bytes(m, nw) > ROWS_SMEM_LIMIT or m > 65535:
        raise ValueError(f"K2 cannot hold a system of {m} rows and {nw} words a row")
    return -1


def eliminate_rows_cuda(A: torch.Tensor, b: torch.Tensor, n: int,
                        max_rank: int | None = None):
    """Launch K2 on packed rows. Same contract as ``eliminate_rows_plain``."""
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
    instance = launch_instance(m, nw)
    A = A.contiguous().clone()
    b = b.contiguous()
    b_out = torch.empty((B, m), dtype=torch.int32, device=dev)
    piv = torch.empty((B, m), dtype=torch.int32, device=dev)
    _LIB.call(
        "gf2_elim_rows_launch",
        A.data_ptr(), b.data_ptr(), b_out.data_ptr(), piv.data_ptr(),
        B, m, nw, n, max_rank, instance, torch.cuda.current_stream(dev).cuda_stream,
    )
    eliminate_rows_cuda.launches += 1
    return A, b_out, piv


eliminate_rows_cuda.launches = 0


def eliminate_ordered_plain(order: torch.Tensor, b: torch.Tensor, Hc: torch.Tensor,
                            max_rank: int | None = None):
    """K2's ordered loader in plain torch: ``eliminate_rows_plain`` on the
    packed rows of H[:, order[s]] for each sample s.

    order (B, n) integer column permutations; b (B, m) 0/1; Hc (n, mw) int32
    H's packed columns (``osd_transform_cuda.pack_columns``). Returns
    ``(b_rref (B, m) int32, piv_col (B, m) int32)``, piv_col in the permuted
    column ids (-1 where none).
    """
    A = pack_permuted_rows(order, Hc, b.shape[1])
    _, b_rref, piv = eliminate_rows_plain(A, b, order.shape[1], max_rank)
    return b_rref, piv


def eliminate_ordered_cuda(order: torch.Tensor, b: torch.Tensor, Hc: torch.Tensor,
                           max_rank: int | None = None):
    """Launch K2 through its ordered loader. Same contract as
    ``eliminate_ordered_plain``."""
    dev = Hc.device
    if dev.type != "cuda" or b.device != dev or order.device != dev:
        raise ValueError("eliminate_ordered_cuda needs its operands on one CUDA device")
    if Hc.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("packed columns and b must be int32")
    B, m = b.shape
    n = order.shape[1]
    mwh = Hc.shape[1]
    if order.shape[0] != B or mwh * WORD < m or n > Hc.shape[0]:
        raise ValueError(f"shapes do not fit: order {tuple(order.shape)}, b {tuple(b.shape)}, "
                         f"Hc {tuple(Hc.shape)}")
    max_rank = m if max_rank is None else max_rank
    nw = -(-n // WORD)
    instance = launch_instance(m, nw)
    order = order.to(torch.int32).contiguous()
    b = b.contiguous()
    Hc = Hc.contiguous()
    b_out = torch.empty((B, m), dtype=torch.int32, device=dev)
    piv = torch.empty((B, m), dtype=torch.int32, device=dev)
    _LIB.call(
        "gf2_elim_ordered_launch",
        order.data_ptr(), Hc.data_ptr(), b.data_ptr(), b_out.data_ptr(), piv.data_ptr(),
        B, m, n, mwh, max_rank, instance, torch.cuda.current_stream(dev).cuda_stream,
    )
    eliminate_ordered_cuda.launches += 1
    return b_out, piv


eliminate_ordered_cuda.launches = 0


def eliminate_ordered(order: torch.Tensor, b: torch.Tensor, Hc: torch.Tensor,
                      max_rank: int | None = None):
    """(b, piv_col) of the RREF of H[:, order[s]] | b[s]: plain torch for CPU
    tensors, K2 for CUDA tensors."""
    if b.device.type == "cuda":
        return eliminate_ordered_cuda(order, b, Hc, max_rank)
    if b.device.type != "cpu":
        raise ValueError(f"unsupported device {b.device}")
    return eliminate_ordered_plain(order, b, Hc, max_rank)


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

    A (m, n_words, B) int32 words, b (m, B) int32 0/1; n = logical column count.
    Returns ``(A_rref (m, n_words, B), b_rref (m, B), piv_col (m, B) int32)``,
    the contract of qldpc_tpu/ops/osd_pallas.py::eliminate_pallas.
    """
    A2, b2, piv = eliminate_rows(
        A.permute(2, 0, 1).contiguous(), b.T.contiguous(), n, max_rank
    )
    return A2.permute(1, 2, 0).contiguous(), b2.T.contiguous(), piv.T.contiguous()
