"""Plain OSD-0 by Gauss-Jordan elimination over GF(2).

For a sample with syndrome s, BP posteriors llr and hard decision h, the
residual syndrome is r = s + H h. The columns are taken by ascending |llr|
(ties by column index); each column that is independent of those taken
before it becomes a pivot, until the residual is explained. The
correction x is the unique solution of H x = r supported on the pivots,
and OSD-0 returns h + x.

The elimination keeps, per sample, the transform T (m x m) with T H_S the
unit columns of the pivot rows, so that a column c reduces to T h_c, the
XOR of T's columns at h_c's support. A new pivot takes the lowest row of
T h_c that holds no pivot yet, and every other row of T h_c then adds that
row of T and of the reduced residual b = T r. Once b is zero on every row
without a pivot, x reads b on the pivot rows: further pivots would add
zeros.

Rows are packed 64 to an int64 word. A step reduces a sample's next
``AHEAD`` columns at once and takes the first independent one, passing
over the dependent ones before it; every ``COMPACT`` steps the samples
that are done leave the working set.
"""

from __future__ import annotations

import numpy as np
import torch

WORD = 64
COMPACT = 32
AHEAD = 64


def _pack(bits: torch.Tensor) -> torch.Tensor:
    """(..., m) 0/1 -> (..., ceil(m / 64)) int64 words, bit i of word w is
    row 64 w + i (bit 63 is the sign bit)."""
    m = bits.shape[-1]
    W = -(-m // WORD)
    padded = torch.nn.functional.pad(bits.to(torch.int64), (0, W * WORD - m))
    shifts = torch.arange(WORD, device=bits.device, dtype=torch.int64)
    return (padded.view(*bits.shape[:-1], W, WORD) << shifts).sum(-1)


class Columns:
    """Each column's rows, padded with the row index m (no row), on ``device``."""

    def __init__(self, H: np.ndarray, device):
        H = np.asarray(H) % 2
        self.m, self.n = H.shape
        rows, cols = np.nonzero(H.T)  # column-major
        deg = np.bincount(rows, minlength=self.n)
        pos = np.arange(rows.size) - np.repeat(np.cumsum(deg) - deg, deg)
        table = np.full((self.n, int(deg.max())), self.m, np.int64)
        table[rows, pos] = cols
        self.rows_of = torch.from_numpy(table).to(device)
        self.H = torch.from_numpy(H.astype(np.float32)).to(device)


def osd0(cols: Columns, syndromes: torch.Tensor, llrs: torch.Tensor,
         hard: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """OSD-0 solutions (B, n) int8, ``chunk`` samples at a time."""
    return torch.cat([_osd0(cols, syndromes[s:s + chunk], llrs[s:s + chunk], hard[s:s + chunk])
                      for s in range(0, syndromes.shape[0], chunk)])


def _osd0(c: Columns, syn, llrs, hard):
    B, dev, m, n = syn.shape[0], syn.device, c.m, c.n
    W = -(-m // WORD)
    resid = (syn.to(torch.int64) + (hard.to(torch.float32) @ c.H.T).to(torch.int64)) % 2
    order = torch.argsort(llrs.abs(), dim=1, stable=True)
    # T by columns, plus a zero column m for padding: Tc[:, j] is T's column j
    eye = torch.eye(m, dtype=torch.int64, device=dev)
    Tc = torch.cat([_pack(eye), torch.zeros((1, W), dtype=torch.int64, device=dev)])
    Tc = Tc.expand(B, m + 1, W).clone()
    b = _pack(resid)
    pivoted = torch.zeros((B, W), dtype=torch.int64, device=dev)
    # each row's pivot column; a last slot takes the writes of samples without one
    pivot_col = torch.full((B, W * WORD + 1), -1, dtype=torch.int64, device=dev)
    out_b, out_col = b.clone(), pivot_col.clone()
    lane = torch.arange(B, device=dev)  # each working sample's own index
    pos = torch.zeros(B, dtype=torch.int64, device=dev)  # its next column in its order
    live = (b != 0).any(-1)
    ahead = torch.arange(AHEAD, device=dev)
    for step in range(n):
        if step % COMPACT == 0:
            live &= pos < n
            if not bool(live.any()):
                break
            done = ~live
            out_b[lane[done]], out_col[lane[done]] = b[done], pivot_col[done]
            lane, order, Tc, b, pos = lane[live], order[live], Tc[live], b[live], pos[live]
            pivoted, pivot_col, live = pivoted[live], pivot_col[live], live[live]
        at = torch.arange(len(lane), device=dev)
        # the next AHEAD columns reduced by T; the first independent one pivots
        # and the dependent ones before it are passed over
        idx = pos[:, None] + ahead
        cols = torch.gather(order, 1, idx.clamp(max=n - 1))
        reduced = Tc[at[:, None, None], c.rows_of[cols]]  # (A, AHEAD, dv, W)
        v = reduced[:, :, 0]
        for j in range(1, reduced.shape[2]):
            v = v ^ reduced[:, :, j]
        has = ((v & ~pivoted[:, None, :]) != 0).any(-1) & (idx < n)
        first = torch.argmax(has.to(torch.int8), dim=1)
        new = has.any(-1) & live
        pos = torch.where(live, torch.where(new, pos + first + 1, pos + AHEAD), pos)
        col, v = cols[at, first], v[at, first]
        free = v & ~pivoted
        word = torch.argmax((free != 0).to(torch.int8), dim=-1)  # the lowest free word
        fw = free[at, word]
        low = fw & -fw
        bit = torch.where(low < 0, WORD - 1, torch.log2(low.clamp(min=1).to(torch.float64))
                          .round().to(torch.int64))
        row = word * WORD + bit
        unit = torch.zeros((len(lane), W), dtype=torch.int64, device=dev)
        unit[at, word] = low
        unit = torch.where(new[:, None], unit, 0)
        others = torch.where(new[:, None], v & ~unit, 0)
        # rows holding T h_c add row `row` of T (and of b)
        Tc ^= ((Tc[at, :, word] >> bit[:, None]) & 1)[:, :, None] * others[:, None, :]
        b ^= ((b[at, word] >> bit) & 1)[:, None] * others
        pivoted |= unit
        pivot_col[at, torch.where(new, row, W * WORD)] = col
        live &= ((b & ~pivoted) != 0).any(-1)
    out_b[lane], out_col[lane] = b, pivot_col
    out_col = out_col[:, :W * WORD]
    bits = ((out_b[:, :, None] >> torch.arange(WORD, device=dev)) & 1).reshape(B, W * WORD)
    x = torch.zeros((B, n + 1), dtype=torch.int64, device=dev)
    x.scatter_(1, torch.where(out_col >= 0, out_col, n), torch.where(out_col >= 0, bits, 0))
    return (hard.to(torch.int64) ^ x[:, :n]).to(torch.int8)
