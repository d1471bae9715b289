"""Transform GF(2) elimination for wide systems: the CUDA kernel K4 and its
plain torch version.

K4 (``csrc/gf2_transform_elim.cu``) replaces
qldpc_tpu/ops/osd_transform_pallas.py::_kernel; its header says what bounds
it on the card and how the design answers (panels of 32 columns, each
eliminated by one warp on one word per row, only the rows holding a panel
bit and the 32 from the rank, transposed to a column a lane, then applied to
T once). ``launch_shape`` gives its threads a block, blocks an SM and waves.
``eliminate_transform_plain`` is
qldpc_tpu/decoders/osd.py::_eliminate_lanes_T in torch, sample-major: each
sample carries the packed m x m row transform T instead of its permuted
system, and the RREF bit of (row r, permuted column c) is
parity(T[r] & Hc[order[c]]). Pivot choice, swap and elimination are the
lanes path's. A sample stops at a 32-column boundary once its rank reaches
rank(H) or, with ``b_exit``, once no row at or below its rank carries a
syndrome bit. The lanes path checks the same conditions at the same
boundaries but for its whole batch at once, so its outputs equal this
function's run on each sample alone; without the b-exit, or in the solution
an OSD-0 builds from ``(b, piv_col)``, they equal its batched run too.

Words are int32 tensors holding uint32 bit patterns, as in ``osd_cuda``.

``eliminate_transform`` is the entry point: the plain version for CPU
tensors, K4 for CUDA tensors, never a fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from qldpc_tpu_torch._build import KernelLibrary
from qldpc_tpu_torch.ops.osd_cuda import WORD

__all__ = [
    "pack_columns",
    "smem_bytes",
    "launch_shape",
    "eliminate_transform",
    "eliminate_transform_plain",
    "eliminate_transform_cuda",
]

# dynamic shared memory one block may opt in to on sm_90 (227 KB), less the
# kernel's static scratch
_STATIC_SMEM = 336  # the kernel's static shared memory: two panel tables, two scalars
SMEM_LIMIT = 227 * 1024 - _STATIC_SMEM
_COL_BLOCK = 32
_SM_SMEM = 228 * 1024  # shared memory of one SM, 1 KB of it reserved per block
_SM_THREADS = 2048  # threads one SM holds
_SM_BLOCKS = 32  # blocks one SM holds

_vp, _i = ctypes.c_void_p, ctypes.c_int
_LIB = KernelLibrary(
    "gf2_transform_elim.cu",
    {
        "gf2_transform_elim_launch": [
            _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _vp,
        ]
    },
)


def pack_columns(H: np.ndarray) -> np.ndarray:
    """(m, n) 0/1 -> (n, m_words) int32: column j of H, row i at word
    i // 32, bit i % 32 (decoders/osd.py's ``_Hc``)."""
    m, n = H.shape
    mw = -(-m // WORD)
    # byte k of column j holds rows 8k..8k+7, bit i row 8k+i: eight row
    # slices a byte (a DEM's H has 10^5 columns; no bit-sized temporaries)
    rows = np.zeros((mw * WORD, n), np.uint8)
    rows[:m] = np.asarray(H) & 1
    rows = rows.reshape(mw * 4, 8, n)
    packed = rows[:, 0].copy()
    for i in range(1, 8):
        packed |= rows[:, i] << i
    cols = np.ascontiguousarray(packed.T)
    return cols.view("<i4").astype(np.int32)


def smem_bytes(m: int) -> int:
    """Dynamic shared memory of one K4 block: T at an odd row stride, the
    staged panel columns (the same stride) and their word lists, and per
    row (padded to 32) the panel word, the pivot mask, piv_col, the slot,
    the list's logical row and b."""
    mw = -(-m // WORD)
    m_pad = mw * WORD
    return 4 * (m * (mw | 1) + _COL_BLOCK * (mw | 1) + _COL_BLOCK * mw + 3 * m_pad) \
        + 4 * m_pad + m_pad


def launch_shape(m: int, B: int, sms: int) -> tuple[int, int, int]:
    """K4's (threads a block, blocks an SM, waves) for B samples of m rows
    on ``sms`` SMs. A block per sample; the kernel instance for m's row
    groups fixes the threads: 256 up to 512 rows (its registers bounded for
    six blocks an SM), 512 beyond (two, or one past 1,024 rows), never more
    than a thread a row. Blocks an SM: what the shared memory and the
    threads allow (registers may allow fewer where m is small)."""
    groups = -(-m // WORD)
    threads = min(256 if groups <= 16 else 512, groups * WORD)
    fit = max(1, min(_SM_SMEM // (smem_bytes(m) + _STATIC_SMEM + 1024),
                     _SM_THREADS // threads, _SM_BLOCKS))
    return threads, max(1, min(fit, -(-B // sms))), -(-B // (sms * fit))


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _identity(B: int, m: int, mw: int, device) -> torch.Tensor:
    eye = torch.zeros((m, mw * WORD), dtype=torch.int64, device=device)
    eye[torch.arange(m), torch.arange(m)] = 1
    shifts = torch.arange(WORD, dtype=torch.int64, device=device)
    words = (eye.view(m, mw, WORD) << shifts).sum(-1)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return words.expand(B, m, mw).clone()


def _parity(x: torch.Tensor) -> torch.Tensor:
    """Bit parity of int32 words, as 0/1 int32. The arithmetic shift only
    sign-fills bits above the ones each fold keeps."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def eliminate_transform_plain(order: torch.Tensor, b: torch.Tensor,
                              Hc: torch.Tensor, h_rank: int,
                              b_exit: bool = False):
    """Transform RREF in plain torch, sample-major.

    order (B, n) integer column permutation per sample; b (B, m) int32 0/1
    residual syndromes; Hc (n, m_words) int32 packed columns of H;
    ``h_rank`` = rank(H). Returns ``(T (B, m, m_words) int32, b (B, m)
    int32, rank (B,) int32, piv_col (B, m) int32)``; piv_col is -1 for rows
    without a pivot.
    """
    B, n = order.shape
    m = b.shape[1]
    mw = Hc.shape[1]
    dev = b.device
    T = _identity(B, m, mw, dev)
    b = b.to(torch.int32).clone()
    rows = torch.arange(m, device=dev)[None, :]
    bidx = torch.arange(B, device=dev)
    rank = torch.zeros(B, dtype=torch.long, device=dev)
    piv = torch.full((B, m), -1, dtype=torch.int32, device=dev)
    order = order.long()
    active = torch.ones(B, dtype=torch.bool, device=dev)
    for col in range(n):
        if col % _COL_BLOCK == 0:
            done = rank >= h_rank
            if b_exit:
                done = done | ~((b != 0) & (rows >= rank[:, None])).any(dim=1)
            active = ~done
            if not bool(active.any()):
                break
        hcol = Hc[order[:, col]]  # (B, mw)
        x = T & hcol[:, None, :]
        z = x[..., 0]
        for w in range(1, mw):
            z = z ^ x[..., w]
        bits = _parity(z)  # (B, m)
        cand = (bits == 1) & (rows >= rank[:, None]) & active[:, None]
        has = cand.any(dim=1)
        p = cand.to(torch.int8).argmax(dim=1)  # first eligible row
        r = rank.clamp(max=m - 1)
        hs = has[:, None]
        row_p, row_r = T[bidx, p], T[bidx, r]
        T[bidx, p] = torch.where(hs, row_r, row_p)
        T[bidx, r] = torch.where(hs, row_p, row_r)
        for v in (b, bits):
            v_p, v_r = v[bidx, p], v[bidx, r]
            v[bidx, p] = torch.where(has, v_r, v_p)
            v[bidx, r] = torch.where(has, v_p, v_r)
        elim = (bits == 1) & (rows != r[:, None]) & hs
        prow, pb = T[bidx, r], b[bidx, r]
        T = torch.where(elim[:, :, None], T ^ prow[:, None, :], T)
        b = torch.where(elim, b ^ pb[:, None], b)
        piv[bidx, r] = torch.where(has, col, piv[bidx, r])
        rank = rank + has.long()
    return T, b, rank.to(torch.int32), piv


def eliminate_transform_cuda(order: torch.Tensor, b: torch.Tensor,
                             Hc: torch.Tensor, h_rank: int,
                             b_exit: bool = False):
    """Launch K4. Same contract as ``eliminate_transform_plain``. Raises for
    a system whose transform does not fit one block's shared memory."""
    dev = b.device
    if dev.type != "cuda" or order.device != dev or Hc.device != dev:
        raise ValueError("eliminate_transform_cuda needs its operands on one CUDA device")
    if Hc.dtype != torch.int32:
        raise TypeError("packed columns must be int32")
    B, n = order.shape
    m = b.shape[1]
    mw = Hc.shape[1]
    if b.shape != (B, m) or Hc.shape[0] != n or mw * WORD < m:
        raise ValueError(
            f"shapes do not fit: order {tuple(order.shape)}, b {tuple(b.shape)}, "
            f"Hc {tuple(Hc.shape)}"
        )
    if smem_bytes(m) > SMEM_LIMIT:
        raise ValueError(
            f"the transform of a {m}-row system needs {smem_bytes(m)} bytes of "
            f"shared memory per sample, over the {SMEM_LIMIT} one block can hold"
        )
    # contiguous operands bound to names: each must outlive the launch
    order32 = order.to(torch.int32).contiguous()
    Hc = Hc.contiguous()
    b = b.to(torch.int32).contiguous().clone()
    T = torch.empty((B, m, mw), dtype=torch.int32, device=dev)
    rank = torch.empty(B, dtype=torch.int32, device=dev)
    piv = torch.empty((B, m), dtype=torch.int32, device=dev)
    threads = launch_shape(m, B, _sm_count(dev))[0]
    _LIB.call(
        "gf2_transform_elim_launch",
        order32.data_ptr(), Hc.data_ptr(), T.data_ptr(),
        b.data_ptr(), rank.data_ptr(), piv.data_ptr(),
        B, m, mw, n, h_rank, int(b_exit), threads,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    eliminate_transform_cuda.launches += 1
    return T, b, rank, piv


eliminate_transform_cuda.launches = 0


def eliminate_transform(order, b, Hc, h_rank: int, b_exit: bool = False):
    """Transform RREF: plain torch for CPU tensors, K4 for CUDA tensors."""
    if b.device.type == "cuda":
        return eliminate_transform_cuda(order, b, Hc, h_rank, b_exit)
    if b.device.type != "cpu":
        raise ValueError(f"unsupported device {b.device}")
    return eliminate_transform_plain(order, b, Hc, h_rank, b_exit)
