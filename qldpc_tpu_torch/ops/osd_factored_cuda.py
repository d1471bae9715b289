"""Factored (T-free) GF(2) elimination for wide systems: the CUDA kernels
K5a-d and their plain torch versions.

The transform elimination (``osd_transform_cuda``, K4) keeps each sample's
m x m row transform T in one block's shared memory. At the [[144,12,12]]
DEM (m = 1,728) T alone is 373 KB per sample, past the 227 KB a block can
hold. This module is qldpc_tpu/ops/osd_factored.py::FactoredEliminator on
the card: T is never built. Every row operation is "row r ^= (pivot-time
value of pivot s)", so

    T[r] = e_r ^ XOR_{s : C[r, s] = 1} P[s]

with P[s] the frozen T-row of the pivot of scheduled column s and C[r, s] = 1
iff row r was eliminated by that pivot. Columns go in blocks of K = 128. Per
block, for the samples still running:

  K5a  ``factored_y_*``: Y = P . H_blk, the parity of P[s] & Hc[order[col]]
       for every frozen pivot s < scur and block column (qldpc_tpu/ops/
       osd_factored.py:84 ``_y_kernel``);
  K5b  ``factored_w_*``: W = H_blk ^ C . Y, the block's current RREF bits of
       every row (:111 ``_w_kernel``), a block a sample and tile of rows
       (``w_tile_rows``);
  K5c  ``factored_panel_elim_*``: the K-column elimination on [W | b] with
       implicit pivots (the first un-pivoted row holding the bit, no row
       swaps), which updates b and the pivoted-row flags, writes the block's
       coefficients C_new into C and returns each column's pivot row (m_pad
       where none) (:183 ``_elim_kernel``);
  K5d  ``factored_resolve_*``: the block's new pivot rows
       P_new = e_p ^ G . P ^ D . P_new, the last term over the strict lower
       triangle in pivot order (:308 ``_resolve_kernel``); the kernel
       computes it as L^-1 (E ^ G . P) with L = I ^ tril(D, -1), which GF(2)
       makes the same bits.

All products are over GF(2). A sample stops at a block boundary once no
unresolved syndrome bit is left or its rank reaches rank(H) (the JAX
``lane_done``); exited samples cost no work: each block starts with one
host sync that lists the samples still running, and the kernels run on
those alone (the block's pivots are then written out through three
boolean-mask reads, each a host sync too). The JAX eliminator runs a
128-lane slab until its last lane is done, so its outputs equal this
function's run on each sample alone.

Layout, sample-major (words are int32 tensors holding uint32 bit patterns,
as in ``osd_cuda``): rows padded to m_pad = 32 * ceil(m / 32), mw = m_pad /
32; ``Hc`` (n + 1, mw) the packed columns of H with a zero sentinel column n;
``P`` (B, s_max, mw); ``C`` (B, s_max / 32, m_pad), word-major so that a
thread per row reads it coalesced; ``b`` and ``piv`` (B, mw) packed by row.

The plain versions compute the GF(2) products as float32 matmuls of 0/1
operands taken mod 2, which is exact: every sum counts at most m_pad or
s_max ones, far below 2**24.

``eliminate_factored`` is the entry point: the plain versions for CPU
tensors, the kernels for CUDA tensors, never a fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from qldpc_tpu_torch._build import KernelLibrary
from qldpc_tpu_torch.ops.osd_cuda import WORD
from qldpc_tpu_torch.ops.osd_transform_cuda import pack_columns
from qldpc_tpu_torch.utils.profiling import count, span

__all__ = [
    "BLOCK_COLS",
    "factored_columns",
    "eliminate_factored",
    "eliminate_factored_plain",
    "eliminate_factored_cuda",
    "factored_y_plain",
    "factored_y_cuda",
    "factored_w_plain",
    "factored_w_cuda",
    "w_tile_rows",
    "factored_panel_elim_plain",
    "factored_panel_elim_cuda",
    "factored_resolve_plain",
    "factored_resolve_cuda",
]

BLOCK_COLS = 128  # K: columns per block, the JAX eliminator's at this scale
_KW = BLOCK_COLS // WORD

_vp, _i = ctypes.c_void_p, ctypes.c_int
_LIB = KernelLibrary(
    "gf2_factored.cu",
    {
        "factored_y_launch": [_vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _vp],
        "factored_w_launch": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _vp],
        "factored_elim_launch": [_vp, _vp, _vp, _vp, _vp, _vp, _vp,
                                 _i, _i, _i, _i, _i, _vp],
        "factored_resolve_launch": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _vp],
    },
)


def factored_columns(H: np.ndarray) -> np.ndarray:
    """(m, n) 0/1 -> (n + 1, mw) int32: the packed columns of H and a zero
    sentinel column n, which pads each sample's column schedule."""
    hc = pack_columns(H)
    return np.concatenate([hc, np.zeros((1, hc.shape[1]), np.int32)])


# ---------------------------------------------------------------- bit helpers
def _unpack(words: torch.Tensor) -> torch.Tensor:
    """(..., nw) int32 words -> (..., nw * 32) int32 bits, bit i of word w
    at position 32 w + i."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * WORD)


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., nw * 32) 0/1 -> (..., nw) int32 words (the inverse of _unpack)."""
    shifts = torch.arange(WORD, dtype=torch.int64, device=bits.device)
    nw = bits.shape[-1] // WORD
    w = (bits.to(torch.int64).reshape(*bits.shape[:-1], nw, WORD) << shifts).sum(-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def _gf2_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched GF(2) product of 0/1 operands, as 0/1 int32."""
    return torch.remainder(a.to(torch.float32) @ b.to(torch.float32), 2).to(torch.int32)


# ------------------------------------------------------------ plain versions
def factored_y_plain(P, lanes, ids, Hc, scur: int) -> torch.Tensor:
    """K5a's plain version: ``Y (A, scur, kw)``, bit k of Y[a, s] the parity
    of ``P[lanes[a], s] & Hc[ids[a, k]]``."""
    Pb = _unpack(P[lanes.long(), :scur])  # (A, scur, m_pad)
    Hb = _unpack(Hc[ids.long()])  # (A, K, m_pad)
    return _pack(_gf2_mm(Pb, Hb.transpose(1, 2)))


def factored_w_plain(C, lanes, ids, Hc, Y, scur: int) -> torch.Tensor:
    """K5b's plain version: ``W (A, m_pad, kw)``, row r of the block's
    current RREF: the H bits of row r in the block's columns, XOR every Y[s]
    with C[r, s] = 1, s < scur."""
    Hb = _unpack(Hc[ids.long()]).transpose(1, 2)  # (A, m_pad, K)
    if scur:
        Cb = _unpack(C[lanes.long(), : scur // WORD].transpose(1, 2))  # (A, m_pad, scur)
        Hb = Hb ^ _gf2_mm(Cb, _unpack(Y))
    return _pack(Hb)


def factored_panel_elim_plain(W, b, piv, C, lanes, ids, n: int, blk: int) -> torch.Tensor:
    """K5c's plain version. Eliminates the K block columns of ``W`` in
    order: the pivot of column j (a column id < n) is the first row holding
    bit j that is not pivoted yet; every other row holding it takes the
    pivot row's W words and b bit. Updates ``b[lanes]`` and ``piv[lanes]``
    and writes the block's coefficients into ``C[lanes, blk * kw : ...]``
    (bit j of row r: row r was eliminated at column j) in place. Returns
    ``prow (A, K) int32``, each column's pivot row, m_pad where none."""
    lanes_l = lanes.long()
    A, m_pad, kw = W.shape
    K = kw * WORD
    dev = W.device
    W = W.clone()
    bb = _unpack(b[lanes_l]).bool()
    pv = _unpack(piv[lanes_l]).bool()
    cnew = torch.zeros((A, m_pad, kw), dtype=torch.int32, device=dev)
    prow = torch.full((A, K), m_pad, dtype=torch.int32, device=dev)
    rows = torch.arange(m_pad, device=dev)[None, :]
    aidx = torch.arange(A, device=dev)
    valid = ids < n
    for j in range(K):
        w, i = divmod(j, WORD)
        bits = ((W[:, :, w] >> i) & 1).bool()
        cand = bits & ~pv & valid[:, j, None]
        has = cand.any(dim=1)
        p = cand.to(torch.int8).argmax(dim=1)  # first candidate row
        wp, bp = W[aidx, p], bb[aidx, p]
        elim = bits & (rows != p[:, None]) & has[:, None]
        W = torch.where(elim[:, :, None], W ^ wp[:, None, :], W)
        bb = bb ^ (elim & bp[:, None])
        pv = pv | ((rows == p[:, None]) & has[:, None])
        cnew[:, :, w] |= elim.to(torch.int32) << i
        prow[:, j] = torch.where(has, p.to(torch.int32), m_pad)
    b[lanes_l] = _pack(bb)
    piv[lanes_l] = _pack(pv)
    C[lanes_l, blk * kw: (blk + 1) * kw] = cnew.transpose(1, 2)
    return prow


def factored_resolve_plain(P, C, lanes, prow, blk: int) -> None:
    """K5d's plain version. The frozen T-rows of the block's pivots,
    written into ``P[lanes, blk * K : (blk + 1) * K]`` in place:
    ``P_new[j] = e_{prow[j]} ^ XOR_{s < scur, G[j, s]} P[s]
    ^ XOR_{j2 < j, D[j, j2]} P_new[j2]`` with G and D the C rows of the
    pivot (earlier blocks and this block); zero where a column has no
    pivot."""
    lanes_l = lanes.long()
    A, K = prow.shape
    kw = K // WORD
    m_pad = C.shape[2]
    scur = blk * K
    dev = P.device
    valid = prow < m_pad
    pcl = prow.long().clamp(max=m_pad - 1)
    Cl = C[lanes_l]  # (A, cw, m_pad)
    rows_of = lambda words: torch.gather(words, 2, pcl[:, None, :].expand(-1, words.shape[1], -1))
    D = _unpack(rows_of(Cl[:, blk * kw: (blk + 1) * kw]).transpose(1, 2))  # (A, K, K)
    D = D * valid[:, :, None]
    Pn = torch.zeros((A, K, m_pad), dtype=torch.int32, device=dev)
    if scur:
        G = _unpack(rows_of(Cl[:, : scur // WORD]).transpose(1, 2)) * valid[:, :, None]
        Pn = _gf2_mm(G, _unpack(P[lanes_l, :scur]))
    Pn.scatter_(2, pcl[:, :, None], Pn.gather(2, pcl[:, :, None]) ^ valid[:, :, None].to(torch.int32))
    below = torch.arange(K, device=dev)[None, :]
    for j2 in range(K):
        mask = D[:, :, j2] * (below > j2)  # (A, K)
        Pn = Pn ^ (mask[:, :, None] * Pn[:, j2, None, :])
    P[lanes_l, scur: scur + K] = _pack(Pn)


# ---------------------------------------------------------------- kernels
def _check_cuda(*tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("the factored elimination kernels need their operands on one CUDA device")
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError("the factored elimination kernels take contiguous int32 tensors")
    return dev


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def factored_y_cuda(P, lanes, ids, Hc, scur: int) -> torch.Tensor:
    """Launch K5a. Same contract as ``factored_y_plain``."""
    dev = _check_cuda(P, lanes, ids, Hc)
    A = lanes.shape[0]
    B, s_max, mw = P.shape
    if ids.shape != (A, BLOCK_COLS) or Hc.shape[1] != mw or not 0 <= scur <= s_max:
        raise ValueError("factored_y: shapes do not fit")
    Y = torch.empty((A, scur, _KW), dtype=torch.int32, device=dev)
    _LIB.call("factored_y_launch", P.data_ptr(), lanes.data_ptr(), ids.data_ptr(),
              Hc.data_ptr(), Y.data_ptr(), A, s_max, mw, scur, _stream(dev))
    factored_y_cuda.launches += 1
    return Y


# K5b's row tiles, largest first: a block a sample and tile, R = rows / 512
# rows a thread from 1,024 rows on
W_TILE_ROWS = (2048, 1024, 512, 256, 128, 64, 32)


def w_tile_rows(A: int, m_pad: int, sms: int) -> int:
    """K5b's rows a block of 512 threads: the largest tile, no larger than
    the smallest that holds a sample's m_pad rows, that still gives the
    card 2 blocks an SM (Y is staged once a block: the larger the tile, the
    fewer copies); 32 when none does."""
    fits = [r for r in W_TILE_ROWS if r >= m_pad]
    cap = fits[-1] if fits else W_TILE_ROWS[0]
    for rows in W_TILE_ROWS:
        if rows <= cap and A * -(-m_pad // rows) >= 2 * sms:
            return rows
    return W_TILE_ROWS[-1]


def factored_w_cuda(C, lanes, ids, Hc, Y, scur: int) -> torch.Tensor:
    """Launch K5b. Same contract as ``factored_w_plain``."""
    dev = _check_cuda(C, lanes, ids, Hc, Y)
    A = lanes.shape[0]
    B, cw, m_pad = C.shape
    mw = Hc.shape[1]
    if ids.shape != (A, BLOCK_COLS) or Y.shape != (A, scur, _KW) or m_pad != mw * WORD \
            or scur > cw * WORD:
        raise ValueError("factored_w: shapes do not fit")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = w_tile_rows(A, m_pad, sms)
    W = torch.empty((A, m_pad, _KW), dtype=torch.int32, device=dev)
    _LIB.call("factored_w_launch", C.data_ptr(), lanes.data_ptr(), ids.data_ptr(),
              Hc.data_ptr(), Y.data_ptr(), W.data_ptr(), A, cw, m_pad, mw, scur, rows,
              _stream(dev))
    factored_w_cuda.launches += 1
    return W


def factored_panel_elim_cuda(W, b, piv, C, lanes, ids, n: int, blk: int) -> torch.Tensor:
    """Launch K5c. Same contract as ``factored_panel_elim_plain``."""
    dev = _check_cuda(W, b, piv, C, lanes, ids)
    A, m_pad, kw = W.shape
    B, cw, _ = C.shape
    if kw != _KW or C.shape[2] != m_pad or b.shape != (B, m_pad // WORD) \
            or piv.shape != b.shape or ids.shape != (A, BLOCK_COLS) or (blk + 1) * kw > cw:
        raise ValueError("factored_panel_elim: shapes do not fit")
    prow = torch.empty((A, BLOCK_COLS), dtype=torch.int32, device=dev)
    _LIB.call("factored_elim_launch", W.data_ptr(), b.data_ptr(), piv.data_ptr(),
              C.data_ptr(), lanes.data_ptr(), ids.data_ptr(), prow.data_ptr(),
              A, m_pad, cw, n, blk, _stream(dev))
    factored_panel_elim_cuda.launches += 1
    return prow


def factored_resolve_cuda(P, C, lanes, prow, blk: int) -> None:
    """Launch K5d. Same contract as ``factored_resolve_plain``."""
    _check_cuda(P, C, lanes, prow)
    dev = P.device
    A = lanes.shape[0]
    B, s_max, mw = P.shape
    _, cw, m_pad = C.shape
    if prow.shape != (A, BLOCK_COLS) or m_pad != mw * WORD or (blk + 1) * BLOCK_COLS > s_max \
            or C.shape[0] != B:
        raise ValueError("factored_resolve: shapes do not fit")
    _LIB.call("factored_resolve_launch", P.data_ptr(), C.data_ptr(), lanes.data_ptr(),
              prow.data_ptr(), A, s_max, mw, cw, m_pad, blk, _stream(dev))
    factored_resolve_cuda.launches += 1


for _fn in (factored_y_cuda, factored_w_cuda, factored_panel_elim_cuda, factored_resolve_cuda):
    _fn.launches = 0


# ----------------------------------------------------------------- the loop
def _eliminate(order, resid, Hc, h_rank: int, max_cols: int, kernels):
    B, n_order = order.shape
    m = resid.shape[1]
    n1, mw = Hc.shape
    n, m_pad, K = n1 - 1, mw * WORD, BLOCK_COLS
    dev = resid.device
    if m > m_pad or n_order > n:
        raise ValueError(f"shapes do not fit: order {tuple(order.shape)}, "
                         f"resid {tuple(resid.shape)}, Hc {tuple(Hc.shape)}")
    y, w, elim, resolve = kernels
    nb = -(-min(max_cols, n) // K)
    s_max = nb * K
    # each sample's column schedule, padded with the zero sentinel column n
    sched = torch.full((B, s_max), n, dtype=torch.int32, device=dev)
    keep = min(s_max, n_order)
    sched[:, :keep] = order[:, :keep]
    b = _pack(torch.nn.functional.pad(resid.to(torch.int32), (0, m_pad - m)))
    piv = torch.zeros((B, mw), dtype=torch.int32, device=dev)
    P = torch.zeros((B, s_max, mw), dtype=torch.int32, device=dev)
    C = torch.zeros((B, s_max // WORD, m_pad), dtype=torch.int32, device=dev)
    piv_col = torch.full((B, m_pad), -1, dtype=torch.int32, device=dev)
    rank = torch.zeros(B, dtype=torch.int64, device=dev)

    def lane_done():
        unresolved = ((b & ~piv) != 0).any(dim=1)
        return ~unresolved | (rank >= h_rank)

    with span("osd.factored"):
        for blk in range(nb):
            lanes = torch.nonzero(~lane_done()).flatten()  # the samples still running
            count("host_syncs")
            if lanes.numel() == 0:
                break
            lanes32 = lanes.to(torch.int32)
            scur = blk * K
            ids = sched[lanes, scur: scur + K].contiguous()
            Y = y(P, lanes32, ids, Hc, scur)
            W = w(C, lanes32, ids, Hc, Y, scur)
            prow = elim(W, b, piv, C, lanes32, ids, n, blk)
            resolve(P, C, lanes32, prow, blk)
            valid = prow < m_pad
            rank[lanes] += valid.sum(dim=1)
            rows = lanes[:, None].expand(-1, K)[valid]
            piv_col[rows, prow[valid].long()] = ids[valid]
            count("host_syncs", 3)  # the three boolean-mask reads
    overflow = ~lane_done()
    return (_unpack(b)[:, :m], _unpack(piv)[:, :m], piv_col[:, :m], overflow)


def eliminate_factored_plain(order, resid, Hc, h_rank: int, max_cols: int):
    """Factored RREF in plain torch, sample-major.

    order (B, n) integer column permutation per sample; resid (B, m) 0/1
    residual syndromes; Hc (n + 1, mw) int32 from ``factored_columns``;
    ``h_rank`` = rank(H); the column budget is ``min(max_cols, n)`` rounded
    up to whole blocks. Returns ``(b (B, m) int32, pivoted (B, m) int32,
    piv_col (B, m) int32, overflow (B,) bool)``: the reduced syndrome, the
    pivoted-row flags, each row's pivot column as an original column id (-1
    where none), and the samples that ran out of budget unresolved. The
    OSD-0 solution is ``corr[piv_col[r]] = b[r]`` over pivoted rows.
    """
    kernels = (factored_y_plain, factored_w_plain, factored_panel_elim_plain,
               factored_resolve_plain)
    return _eliminate(order, resid, Hc, h_rank, max_cols, kernels)


def eliminate_factored_cuda(order, resid, Hc, h_rank: int, max_cols: int):
    """The factored RREF through K5a-d. Same contract as
    ``eliminate_factored_plain``."""
    _check_cuda(Hc)
    if order.device != Hc.device or resid.device != Hc.device:
        raise ValueError("eliminate_factored_cuda needs its operands on one CUDA device")
    kernels = (factored_y_cuda, factored_w_cuda, factored_panel_elim_cuda,
               factored_resolve_cuda)
    return _eliminate(order, resid, Hc, h_rank, max_cols, kernels)


def eliminate_factored(order, resid, Hc, h_rank: int, max_cols: int):
    """Factored RREF: plain torch for CPU tensors, K5a-d for CUDA tensors."""
    if resid.device.type == "cuda":
        return eliminate_factored_cuda(order, resid, Hc, h_rank, max_cols)
    if resid.device.type != "cpu":
        raise ValueError(f"unsupported device {resid.device}")
    return eliminate_factored_plain(order, resid, Hc, h_rank, max_cols)
