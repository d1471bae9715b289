"""Transform GF(2) elimination for wide systems: the CUDA kernels K4 and
K4g and their plain torch version.

K4 (``csrc/gf2_transform_elim.cu``) replaces
qldpc_tpu/ops/osd_transform_pallas.py::_kernel; its header says what bounds
it on the card and how the design answers (panels of 32 columns, each
eliminated by one warp on one word per row, only the rows holding a panel
bit and the 32 from the rank, transposed to a column a lane, then applied to
T once). ``launch_shape`` gives its threads a block, blocks an SM and waves.
K4g (``csrc/gf2_transform_elim_global.cu``) is the same algorithm for
systems whose T does not fit a block's shared memory (``smem_bytes(m) >
SMEM_LIMIT``: the [[144,12,12]] and [[288,12,18]] DEMs, [[288,12,18]]
space-time at T = 18), a sample on a cluster of C blocks that split its
rows, in pivot-first panels (its header says how); T lives in the
cluster's shared memory where it fits, else in global memory.
``global_launch_shape`` picks C and where T lives. K4g has no TPU kernel to
replace, since the JAX package runs XLA there (qldpc_tpu/decoders/osd.py::
_eliminate_lanes_T). Its caller bounds T's memory: ``t_bytes(m)`` a sample.
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
tensors, K4 or, past its block, K4g for CUDA tensors, never a fallback.
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
    "global_smem_bytes",
    "global_fits",
    "t_bytes",
    "launch_shape",
    "global_launch_shape",
    "eliminate_transform",
    "eliminate_transform_plain",
    "column_bits",
    "eliminate_transform_cuda",
    "eliminate_transform_global_cuda",
]

# dynamic shared memory one block may opt in to on sm_90 (227 KB), less the
# kernel's static scratch
_STATIC_SMEM = 336  # the kernel's static shared memory: two panel tables, two scalars
SMEM_LIMIT = 227 * 1024 - _STATIC_SMEM
_COL_BLOCK = 32
_SM_SMEM = 228 * 1024  # shared memory of one SM, 1 KB of it reserved per block
_SM_THREADS = 2048  # threads one SM holds
_SM_BLOCKS = 32  # blocks one SM holds
# K4g: a cluster of C blocks of 1,024 threads a sample, a block an SM; its
# static shared memory is the panel's pivot record, a count a warp and
# seven scalars (668 B)
_GLOBAL_THREADS = 1024
_GLOBAL_STATIC_SMEM = 768
GLOBAL_SMEM_LIMIT = 227 * 1024 - _GLOBAL_STATIC_SMEM
_MAX_CLUSTER = 16  # past 8 a non-portable cluster size
_CLUSTER_CAP = 8  # the widest portable cluster
_WIDE_CLUSTERS = 7  # clusters of 16 such blocks an H100 holds at once

_vp, _i = ctypes.c_void_p, ctypes.c_int
_LIB = KernelLibrary(
    "gf2_transform_elim.cu",
    {
        "gf2_transform_elim_launch": [
            _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _vp,
        ]
    },
)
_GLOBAL_LIB = KernelLibrary(
    "gf2_transform_elim_global.cu",
    {
        "gf2_transform_elim_global_launch": [
            _vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _i, _i, _vp,
        ],
        "gf2_transform_elim_global_smem_bytes": [_i, _i, _i, _i],
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


def global_smem_bytes(m: int, cluster: int = 1, t_smem: bool = False) -> int:
    """Dynamic shared memory of one K4g block in a cluster of ``cluster``
    blocks (the kernel's ``k4g_smem_bytes``): the staged panel columns at an
    odd stride, the panel's (word, column) pairs (their words, and their
    places in 16 bits), U; per own slot (R = ceil(m / cluster)) the panel
    word, the mask, the logical row and b, and per own logical row its
    slot; the leader's list (its words, slots and b, logical rows); with
    ``t_smem`` the block's R rows of T. A cluster of 16 takes 9,312 rows (``global_fits``)."""
    mw = -(-m // WORD)
    m_pad = mw * WORD
    R = -(-m // cluster)
    words = _COL_BLOCK * (mw | 1) + 2 * _COL_BLOCK * mw + 2 * R + 2 * m_pad \
        + (R * mw if t_smem else 0)
    return 4 * words + 2 * (_COL_BLOCK * mw + 2 * R + m_pad) + R


def global_fits(m: int) -> bool:
    """Whether K4g takes a system of m rows: its per-row state fits a block
    of the widest cluster."""
    return global_smem_bytes(m, _MAX_CLUSTER) <= GLOBAL_SMEM_LIMIT


def t_bytes(m: int) -> int:
    """Bytes of one sample's packed transform T, (m, m_words) int32."""
    return m * -(-m // WORD) * 4


def launch_shape(m: int, B: int, sms: int) -> tuple[int, int, int]:
    """The transform elimination's (threads a block, blocks an SM, waves)
    for B samples of m rows on ``sms`` SMs, a block per sample. K4, where T
    fits a block: the kernel instance for m's row groups fixes the threads,
    256 up to 512 rows (its registers bounded for six blocks an SM), 512
    beyond (two, or one past 1,024 rows), never more than a thread a row.
    Blocks an SM: what the shared memory and the threads allow (registers
    may allow fewer). K4g, past it: 1,024 threads, a block an SM, the
    waves of ``global_launch_shape``'s clusters."""
    groups = -(-m // WORD)
    if smem_bytes(m) > SMEM_LIMIT:
        return _GLOBAL_THREADS, 1, global_launch_shape(m, B, sms)[2]
    threads = min(256 if groups <= 16 else 512, groups * WORD)
    smem = smem_bytes(m) + _STATIC_SMEM
    fit = max(1, min(_SM_SMEM // (smem + 1024), _SM_THREADS // threads, _SM_BLOCKS))
    return threads, max(1, min(fit, -(-B // sms))), -(-B // (sms * fit))


def global_launch_shape(m: int, B: int, sms: int,
                        cluster: int | None = None) -> tuple[int, bool, int]:
    """K4g's geometry for B samples of m rows on ``sms`` SMs: ``(cluster
    width C, T in the cluster's shared memory, waves)``, a block an SM, the
    grid B * C blocks. C is the widest power of two that keeps the clusters
    to one wave (B * C <= sms), at most 8, or 16 where at most
    ``_WIDE_CLUSTERS`` samples run, and wider where the per-row state would
    not fit a block. T is in shared memory wherever the cluster holds it.
    ``cluster`` overrides C. (scripts/probe_k4g.py measures every width.)"""
    if cluster is None:
        cluster = 1
        cap = _MAX_CLUSTER if B <= _WIDE_CLUSTERS else _CLUSTER_CAP
        while 2 * cluster <= cap and B * 2 * cluster <= sms:
            cluster *= 2
        while cluster < _MAX_CLUSTER and global_smem_bytes(m, cluster) > GLOBAL_SMEM_LIMIT:
            cluster *= 2  # the per-row state alone passes a block
    if not 1 <= cluster <= _MAX_CLUSTER:
        raise ValueError(f"K4g's cluster width must be 1 to {_MAX_CLUSTER}, not {cluster}")
    t_smem = global_smem_bytes(m, cluster, True) <= GLOBAL_SMEM_LIMIT
    return cluster, t_smem, -(-B * cluster // sms)


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


def column_bits(T: torch.Tensor, Hc: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The RREF bits parity(T[s, r] & Hc[cols[s, j]]) of every row r, (k, m,
    J) 0/1 int32, for T (k, m, mw) and columns cols (k, J), folded a word at
    a time into a (k, m, J) accumulator."""
    hc = Hc[cols]  # (k, J, mw)
    z = T[:, :, None, 0] & hc[:, None, :, 0]
    for w in range(1, hc.shape[-1]):
        z ^= T[:, :, None, w] & hc[:, None, :, w]
    return _parity(z)


def eliminate_transform_plain(order: torch.Tensor, b: torch.Tensor,
                              Hc: torch.Tensor, h_rank: int,
                              b_exit: bool = False, cleared: torch.Tensor | None = None):
    """Transform RREF in plain torch, sample-major.

    order (B, n) integer column permutation per sample; b (B, m) int32 0/1
    residual syndromes; Hc (n, m_words) int32 packed columns of H (rows past
    n are never read); ``h_rank`` = rank(H). Returns ``(T (B, m, m_words)
    int32, b (B, m) int32, rank (B,) int32, piv_col (B, m) int32)``; piv_col
    is -1 for rows without a pivot. ``cleared``, a 0-d int64 tensor on b's
    device, if given, has the number of rows the pivots clear added to it
    (the row operations this input needs).

    The loop runs the lanes path's column steps on the samples still
    running: at each 32-column boundary the samples that exit are written
    out and dropped, and the panel's RREF bits of every row are read from T
    once and carried through the panel's row operations beside T and b,
    which leaves every output as the step-by-step loop gives it.
    """
    B, n = order.shape
    m = b.shape[1]
    mw = Hc.shape[1]
    dev = b.device
    T_out = _identity(B, m, mw, dev)
    b_out = b.to(torch.int32).clone()
    rank_out = torch.zeros(B, dtype=torch.int32, device=dev)
    piv_out = torch.full((B, m), -1, dtype=torch.int32, device=dev)
    live = torch.arange(B, device=dev)  # the running samples' rows of the outputs
    T, bb, piv, order = T_out, b_out, piv_out, order.long()
    rank = torch.zeros(B, dtype=torch.long, device=dev)
    rows = torch.arange(m, device=dev)

    def write_out(which):
        T_out[live[which]] = T[which]
        b_out[live[which]] = bb[which]
        rank_out[live[which]] = rank[which].to(torch.int32)
        piv_out[live[which]] = piv[which]

    for col0 in range(0, n, _COL_BLOCK):
        done = rank >= h_rank
        if b_exit:
            done = done | ~((bb != 0) & (rows >= rank[:, None])).any(dim=1)
        if bool(done.any()):
            write_out(done)
            keep = ~done
            live, T, bb, piv, order, rank = (x[keep] for x in (live, T, bb, piv, order, rank))
            if not len(live):
                return T_out, b_out, rank_out, piv_out
        # the panel's steps on the rows of [T | W | b], W (k, m, J) the
        # panel's RREF bits of every row: a row operation acts alike on T's
        # words, the bits and b, so they stay current together
        W = column_bits(T, Hc, order[:, col0:col0 + _COL_BLOCK])
        A = torch.cat([T, W, bb[:, :, None]], dim=2)
        for j in range(W.shape[2]):
            cand = (A[:, :, mw + j] != 0) & (rows >= rank[:, None])
            has = cand.any(dim=1)
            r = rank.clamp(max=m - 1)
            p = torch.where(has, cand.to(torch.int8).argmax(dim=1), r)  # first eligible row
            # the pivot row to the rank row: a swap of p and r, a no-op where
            # p == r; the rank row then holds old row p, the pivot row
            pr = torch.stack([p, r], dim=1)[:, :, None]
            old_rows = A.gather(1, pr.flip(1).expand(-1, -1, A.shape[2]))
            A.scatter_(1, pr.expand(-1, -1, A.shape[2]), old_rows)
            elim = (A[:, :, mw + j] != 0) & (rows != r[:, None]) & has[:, None]
            if cleared is not None:
                cleared += elim.sum()
            if A.is_cuda:  # no host sync a column
                A ^= elim[:, :, None] * old_rows[:, 1, None, :]
            else:  # only the rows it clears
                eb, er = torch.nonzero(elim, as_tuple=True)
                A[eb, er] ^= old_rows[eb, 1]
            piv.scatter_(1, r[:, None],
                         torch.where(has[:, None], col0 + j, piv.gather(1, r[:, None])))
            rank += has
        T, bb = A[:, :, :mw].contiguous(), A[:, :, -1].contiguous()
    write_out(torch.ones(len(live), dtype=torch.bool, device=dev))
    return T_out, b_out, rank_out, piv_out


def _operands(name: str, order, b, Hc, smem: int, limit: int):
    """Both kernels' checks, their contiguous operands and their outputs
    ``(order32, Hc, b, T, rank, piv)``, each of which must outlive the
    launch. Hc may hold rows past n (``factored_columns``' sentinel), which
    no kernel reads."""
    dev = b.device
    if dev.type != "cuda" or order.device != dev or Hc.device != dev:
        raise ValueError(f"{name} needs its operands on one CUDA device")
    if Hc.dtype != torch.int32:
        raise TypeError("packed columns must be int32")
    B, n = order.shape
    m = b.shape[1]
    mw = Hc.shape[1]
    if b.shape != (B, m) or Hc.shape[0] < n or mw != -(-m // WORD):
        raise ValueError(
            f"shapes do not fit: order {tuple(order.shape)}, b {tuple(b.shape)}, "
            f"Hc {tuple(Hc.shape)}"
        )
    if smem > limit:
        raise ValueError(f"{name}: a {m}-row system needs {smem} bytes of shared memory "
                         f"per sample, over the {limit} one block can hold")
    return (order.to(torch.int32).contiguous(), Hc.contiguous(),
            b.to(torch.int32).contiguous().clone(),
            torch.empty((B, m, mw), dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty((B, m), dtype=torch.int32, device=dev))


def eliminate_transform_cuda(order: torch.Tensor, b: torch.Tensor,
                             Hc: torch.Tensor, h_rank: int,
                             b_exit: bool = False):
    """Launch K4. Same contract as ``eliminate_transform_plain``. Raises for
    a system whose transform does not fit one block's shared memory."""
    m = b.shape[1]
    order32, Hc, b, T, rank, piv = _operands("eliminate_transform_cuda", order, b, Hc,
                                             smem_bytes(m), SMEM_LIMIT)
    B, n = order.shape
    _LIB.call(
        "gf2_transform_elim_launch",
        order32.data_ptr(), Hc.data_ptr(), T.data_ptr(),
        b.data_ptr(), rank.data_ptr(), piv.data_ptr(),
        B, m, Hc.shape[1], n, h_rank, int(b_exit), launch_shape(m, B, _sm_count(b.device))[0],
        torch.cuda.current_stream(b.device).cuda_stream,
    )
    eliminate_transform_cuda.launches += 1
    return T, b, rank, piv


eliminate_transform_cuda.launches = 0


def eliminate_transform_global_cuda(order: torch.Tensor, b: torch.Tensor,
                                    Hc: torch.Tensor, h_rank: int,
                                    b_exit: bool = False, *, _cluster: int | None = None,
                                    _t_smem: bool | None = None):
    """Launch K4g. Same contract as ``eliminate_transform_plain``. Allocates
    T, ``t_bytes(m)`` a sample: the caller bounds B. ``_cluster`` and
    ``_t_smem`` override ``global_launch_shape``'s choice (for the tests and
    the probe)."""
    m = b.shape[1]
    B, n = order.shape
    C, t_smem, _ = global_launch_shape(m, B, _sm_count(b.device) if b.is_cuda else 1, _cluster)
    if _t_smem is not None:
        t_smem = _t_smem
    order32, Hc, b, T, rank, piv = _operands("eliminate_transform_global_cuda", order, b, Hc,
                                             global_smem_bytes(m, C, t_smem), GLOBAL_SMEM_LIMIT)
    _GLOBAL_LIB.call(
        "gf2_transform_elim_global_launch",
        order32.data_ptr(), Hc.data_ptr(), T.data_ptr(),
        b.data_ptr(), rank.data_ptr(), piv.data_ptr(),
        B, m, Hc.shape[1], n, h_rank, int(b_exit), C, int(t_smem),
        torch.cuda.current_stream(b.device).cuda_stream,
    )
    eliminate_transform_global_cuda.launches += 1
    return T, b, rank, piv


eliminate_transform_global_cuda.launches = 0


def eliminate_transform(order, b, Hc, h_rank: int, b_exit: bool = False):
    """Transform RREF: plain torch for CPU tensors; for CUDA tensors K4, or
    K4g where T does not fit K4's block."""
    if b.device.type == "cuda":
        if smem_bytes(b.shape[1]) > SMEM_LIMIT:
            return eliminate_transform_global_cuda(order, b, Hc, h_rank, b_exit)
        return eliminate_transform_cuda(order, b, Hc, h_rank, b_exit)
    if b.device.type != "cpu":
        raise ValueError(f"unsupported device {b.device}")
    return eliminate_transform_plain(order, b, Hc, h_rank, b_exit)
