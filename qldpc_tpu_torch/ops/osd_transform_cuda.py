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
cluster's shared memory where it fits, else in global memory. Past the
9,312 rows whose per-block state a cluster of 16 holds in shared memory,
the panel's staging and the leader's list spill to a global workspace
(``global_spills``), and K4g takes any system whose per-slot state fits.
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
    "global_spills",
    "global_workspace_words",
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
# seven scalars (668 B), in the spilled instance the panel's columns (796
# B), with the probe's counter 800 B: 1 KB reserved (the card tests hold
# every instance's static size to it)
_GLOBAL_THREADS = 1024
_GLOBAL_STATIC_SMEM = 1024
GLOBAL_SMEM_LIMIT = 227 * 1024 - _GLOBAL_STATIC_SMEM
_MAX_CLUSTER = 16  # past 8 a non-portable cluster size
_CLUSTER_CAP = 8  # the widest portable cluster

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
            _vp, _vp, _vp, _vp, _vp, _vp, _vp, ctypes.c_longlong,
            _i, _i, _i, _i, _i, _i, _i, _i, _i, _vp,
        ],
        "gf2_transform_elim_global_smem_bytes": [_i] * 5,
        "gf2_transform_elim_global_max_clusters": [_i] * 5,
        "gf2_transform_elim_global_static_smem": [_i] * 2,
    },
)
# the card's count of clusters of 16 K4g blocks at once, by (device, m):
# asked of the kernel once each
_WIDE_CLUSTERS: dict = {}


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


def _shared_layout_bytes(m: int, cluster: int, t_smem: bool) -> int:
    mw = -(-m // WORD)
    m_pad = mw * WORD
    R = -(-m // cluster)
    words = _COL_BLOCK * (mw | 1) + 2 * _COL_BLOCK * mw + 2 * R + 2 * m_pad \
        + (R * mw if t_smem else 0)
    return 4 * words + 2 * (_COL_BLOCK * mw + 2 * R + m_pad) + R


def global_spills(m: int) -> bool:
    """Whether K4g runs a system of m rows in its spilled layout: past the
    9,312 rows whose per-block state (the staged panel, its (word, column)
    pairs, U and the leader's list, which do not shrink with the cluster)
    a cluster of 16 holds in shared memory."""
    return _shared_layout_bytes(m, _MAX_CLUSTER, False) > GLOBAL_SMEM_LIMIT


def global_smem_bytes(m: int, cluster: int = 1, t_smem: bool = False) -> int:
    """Dynamic shared memory of one K4g block in a cluster of ``cluster``
    blocks (the kernel's ``k4g_smem_bytes``). Up to 9,312 rows: the staged
    panel columns at an odd stride, the panel's (word, column) pairs (their
    words, and their places in 16 bits), U; per own slot (R = ceil(m /
    cluster)) the panel word, the mask, the logical row and b, and per own
    logical row its slot; the leader's list (its words, slots and b, logical
    rows); with ``t_smem`` the block's R rows of T. Past them
    (``global_spills``): per own slot the panel word, the mask, its logical
    row and the slot of its logical row in 32 bits, and b (17 bytes)."""
    if global_spills(m):
        R = -(-m // cluster)
        return 17 * R + (4 * R * -(-m // WORD) if t_smem else 0)
    return _shared_layout_bytes(m, cluster, t_smem)


def global_fits(m: int) -> bool:
    """Whether K4g takes a system of m rows: its per-slot state fits a
    block of the widest cluster, up to 217,808 rows in the spilled layout.
    Every system whose one-sample T fits the decoder's 1 GiB group (about
    92,000 rows) fits."""
    return global_smem_bytes(m, _MAX_CLUSTER) <= GLOBAL_SMEM_LIMIT


def global_workspace_words(m: int, B: int, cluster: int) -> int:
    """Words of K4g's global workspace for B samples of m rows in clusters
    of ``cluster`` blocks (the kernel's ``k4g_workspace_words``): none in
    the shared layout; spilled, the pairs' words and places and U of each
    block and the leader's list of each sample, 3 m_pad words each."""
    if not global_spills(m):
        return 0
    return 3 * -(-m // WORD) * WORD * (B * cluster + B)


def t_bytes(m: int) -> int:
    """Bytes of one sample's packed transform T, (m, m_words) int32."""
    return m * -(-m // WORD) * 4


def launch_shape(m: int, B: int, sms: int,
                 wide_clusters: int | None = None) -> tuple[int, int, int]:
    """The transform elimination's (threads a block, blocks an SM, waves)
    for B samples of m rows on ``sms`` SMs, a block per sample. K4, where T
    fits a block: the kernel instance for m's row groups fixes the threads,
    256 up to 512 rows (its registers bounded for six blocks an SM), 512
    beyond (two, or one past 1,024 rows), never more than a thread a row.
    Blocks an SM: what the shared memory and the threads allow (registers
    may allow fewer). K4g, past it: 1,024 threads, a block an SM, the
    waves of ``global_launch_shape``'s clusters, for which ``wide_clusters``
    (the card's count, ``wide_clusters(device, m)``) must be given."""
    groups = -(-m // WORD)
    if smem_bytes(m) > SMEM_LIMIT:
        if wide_clusters is None:
            raise ValueError(f"K4g's shape at {m} rows needs the card's wide_clusters")
        return _GLOBAL_THREADS, 1, global_launch_shape(m, B, sms, wide_clusters)[2]
    threads = min(256 if groups <= 16 else 512, groups * WORD)
    smem = smem_bytes(m) + _STATIC_SMEM
    fit = max(1, min(_SM_SMEM // (smem + 1024), _SM_THREADS // threads, _SM_BLOCKS))
    return threads, max(1, min(fit, -(-B // sms))), -(-B // (sms * fit))


def global_launch_shape(m: int, B: int, sms: int, wide_clusters: int,
                        cluster: int | None = None) -> tuple[int, bool, int]:
    """K4g's geometry for B samples of m rows on ``sms`` SMs: ``(cluster
    width C, T in the cluster's shared memory, waves)``, a block an SM, the
    grid B * C blocks. C is the widest power of two that keeps the clusters
    to one wave (B * C <= sms), at most 8, or 16 where the card runs every
    sample's cluster of 16 at once (B <= ``wide_clusters``, the card's own
    count: 7 on an H100), and wider where the per-row state would not fit a
    block. T is in shared memory wherever the cluster holds it, never in
    the spilled layout. ``cluster`` overrides C. (scripts/probe_k4g.py
    measures every width.)"""
    if cluster is None:
        cluster = 1
        cap = _MAX_CLUSTER if B <= wide_clusters else _CLUSTER_CAP
        while 2 * cluster <= cap and B * 2 * cluster <= sms:
            cluster *= 2
        while cluster < _MAX_CLUSTER and global_smem_bytes(m, cluster) > GLOBAL_SMEM_LIMIT:
            cluster *= 2  # the per-row state alone passes a block
    if not 1 <= cluster <= _MAX_CLUSTER:
        raise ValueError(f"K4g's cluster width must be 1 to {_MAX_CLUSTER}, not {cluster}")
    t_smem = not global_spills(m) and \
        global_smem_bytes(m, cluster, True) <= GLOBAL_SMEM_LIMIT
    return cluster, t_smem, -(-B * cluster // sms)


def wide_clusters(device, m: int) -> int:
    """The clusters of 16 K4g blocks the card runs at once for m rows (the
    kernel's own occupancy query, ``gf2_transform_elim_global_max_clusters``,
    on the layout with T in global memory: a block an SM either way)."""
    dev = torch.device(device)
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), m)
    if key not in _WIDE_CLUSTERS:
        with torch.cuda.device(key[0]):
            got = _GLOBAL_LIB.lib.gf2_transform_elim_global_max_clusters(
                m, -(-m // WORD), _MAX_CLUSTER, 0, int(global_spills(m)))
        if got < 0:
            raise RuntimeError(f"K4g's occupancy query failed with cudaError {-got}")
        _WIDE_CLUSTERS[key] = got
    return _WIDE_CLUSTERS[key]


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


_FOLD_WORDS = 1 << 24  # words of column_bits' AND tensor at once (64 MB)


def column_bits(T: torch.Tensor, Hc: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The RREF bits parity(T[s, r] & Hc[cols[s, j]]) of every row r, (k, m,
    J) 0/1 int32, for T (k, m, mw) and columns cols (k, J), folded a word at
    a time into a (k, m, J) accumulator; on the card, where that takes
    more launches than halving, the AND of a chunk of rows with every
    column, (k, rows, J, mw), its words XORed together by halves."""
    hc = Hc[cols]  # (k, J, mw)
    k, m, mw = T.shape
    step = max(1, _FOLD_WORDS // max(1, k * hc.shape[1] * mw))
    if T.is_cuda and -(-m // step) * (3 * mw.bit_length() + 17) < 2 * mw + 16:
        return _column_bits_folded(T, hc, step)
    z = T[:, :, None, 0] & hc[:, None, :, 0]
    for w in range(1, mw):
        z ^= T[:, :, None, w] & hc[:, None, :, w]
    return _parity(z)


def _column_bits_folded(T: torch.Tensor, hc: torch.Tensor, step: int) -> torch.Tensor:
    """``column_bits`` by halving, ``step`` rows at a time; hc (k, J, mw)
    the columns' words."""
    k, m, mw = T.shape
    out = torch.empty((k, m, hc.shape[1]), dtype=torch.int32, device=T.device)
    for r0 in range(0, m, step):
        z = T[:, r0:r0 + step, None, :] & hc[:, None, :, :]
        w = mw
        while w > 1:
            h = w // 2
            if w % 2:  # the odd word into the first half
                z[..., 0] ^= z[..., w - 1]
            z = z[..., :h] ^ z[..., h:2 * h]
            w = h
        out[:, r0:r0 + step] = _parity(z[..., 0])
    return out


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
        # a panel in which no row at or below a sample's rank holds a bit
        # has no pivot there and changes nothing (K4g's pivot-first test):
        # the bits of the rows from the least rank first, the others' only
        # where some sample pivots
        cols = order[:, col0:col0 + _COL_BLOCK]
        r_lo = int(rank.min())
        low = column_bits(T[:, r_lo:], Hc, cols)
        if not bool(((low != 0).any(dim=2) & (rows[r_lo:] >= rank[:, None])).any()):
            continue
        # the panel's steps on the rows of [T | W | b], W (k, m, J) the
        # panel's RREF bits of every row: a row operation acts alike on T's
        # words, the bits and b, so they stay current together
        W = torch.cat([column_bits(T[:, :r_lo], Hc, cols), low], dim=1) if r_lo else low
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
    T, ``t_bytes(m)`` a sample (the caller bounds B), and in the spilled
    layout its workspace, ``global_workspace_words``. ``_cluster`` and
    ``_t_smem`` override ``global_launch_shape``'s choice (for the tests and
    the probe)."""
    m = b.shape[1]
    B, n = order.shape
    if b.is_cuda:
        C, t_smem, _ = global_launch_shape(m, B, _sm_count(b.device),
                                           wide_clusters(b.device, m), _cluster)
    else:
        C, t_smem = _cluster or 1, False  # refused below
    if _t_smem is not None:
        t_smem = _t_smem
    spill = global_spills(m)
    if spill and t_smem:
        raise ValueError(f"K4g keeps T in global memory past 9,312 rows, not at {m}")
    order32, Hc, b, T, rank, piv = _operands("eliminate_transform_global_cuda", order, b, Hc,
                                             global_smem_bytes(m, C, t_smem), GLOBAL_SMEM_LIMIT)
    ws_words = global_workspace_words(m, B, C)
    ws = torch.empty(max(ws_words, 1), dtype=torch.int32, device=b.device)
    _GLOBAL_LIB.call(
        "gf2_transform_elim_global_launch",
        order32.data_ptr(), Hc.data_ptr(), T.data_ptr(),
        b.data_ptr(), rank.data_ptr(), piv.data_ptr(), ws.data_ptr(), ws_words,
        B, m, Hc.shape[1], n, h_rank, int(b_exit), C, int(t_smem), int(spill),
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
