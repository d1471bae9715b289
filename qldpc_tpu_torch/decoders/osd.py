"""Ordered-statistics decoding (OSD-0) in torch.

Port of the OSD-0 lanes pipeline of qldpc_tpu/decoders/osd.py
(``_lanes_core``): the residual syndrome of the BP hard decision, columns
ordered by ascending |LLR| (stable: ties are common and the order decides
them), a GF(2) elimination of each sample's permuted system, then
``e_perm[piv_col[r]] = b[r]``, ``corr[order] = e_perm`` and
``solution = hard XOR corr``.

Three eliminations, chosen from the shape of H alone before any launch, so
that the card and the CPU choose alike and their counters can be compared:

  * narrow systems whose packed rows fit one warp's shared memory in K2:
    the full row reduction of each sample's [H[:, order] | resid], read from
    H's packed columns in the sample's order, with (b, piv_col) alone
    returned (``ops.osd_cuda.eliminate_ordered``: plain torch on CPU, K2 on
    CUDA);
  * wide systems (``n_words > 4 * m_words``: circuit-level DEMs), and narrow
    ones too large for K2 (the space-time matrix of [[144,12,12]] at T = 12,
    864 x 2,592), whose transform fits one block's shared memory: the
    transform elimination with the b-exit on (``ops.osd_transform_cuda``:
    plain torch on CPU, K4 on CUDA), whose residual is a gather-parity over
    each check's variables instead of a dense matmul;
  * larger ones (the [[144,12,12]] DEM, m = 1,728): the factored elimination
    (``ops.osd_factored_cuda``: plain torch on CPU, K5a-d on CUDA), with the
    JAX decoder's column budget ``max(max_elim_cols, min(n, rank + 512))``.
    A sample that exhausts it unresolved returns ``hard`` unchanged, so the
    engine counts it as a failure rather than accept a partial solve.

All three give the OSD-0 solution of the JAX ``lanes`` path: the transform
elimination's ``(b, piv_col)`` are the lanes path's, and the factored one's
are for every sample that stays within its budget.

``OSDConfig.backend`` forces the transform or the factored elimination on a
system the row elimination does not take; no path falls back to another.

Not in this slice (see ROADMAP.md): OSD-e (``order > 0``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from qldpc_tpu_torch.ops.tanner import parity_tables
from qldpc_tpu_torch.ops.osd_cuda import (
    ROWS_SMEM_LIMIT,
    WORD,
    eliminate_ordered,
    rows_smem_bytes,
)
from qldpc_tpu_torch.ops.osd_factored_cuda import eliminate_factored, factored_columns
from qldpc_tpu_torch.ops.osd_transform_cuda import (
    SMEM_LIMIT,
    eliminate_transform,
    pack_columns,
    smem_bytes,
)

__all__ = ["OSDConfig", "OSDDecoder", "gf2_rank"]


_BACKENDS = ("auto", "transform", "factored")


@dataclasses.dataclass(frozen=True)
class OSDConfig:
    order: int = 0
    backend: str = "auto"  # wide systems: "auto" picks the transform
    # elimination when a sample's transform fits one block's shared memory
    # and the factored one otherwise; "transform" and "factored" force one
    max_elim_cols: int = 2048  # factored elimination: column budget floor,
    # raised to min(n, rank(H) + 512) (decoders/osd.py of the JAX package)

    def __post_init__(self):
        if self.order > 0:
            raise NotImplementedError(
                "OSD-e (order > 0) is not ported yet (ROADMAP.md, Queue 1 "
                "item 1: OSD-e)"
            )
        if self.order < 0:
            raise ValueError("order must be >= 0")
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown OSD backend {self.backend!r}; one of {_BACKENDS}")
        if self.max_elim_cols < 1:
            raise ValueError("max_elim_cols must be positive")


def gf2_rank(H: np.ndarray) -> int:
    """rank(H) over GF(2), as ``codes.gf2.rank``, by forward elimination of
    H's rows packed 64 columns a word: seconds where the unpacked RREF takes
    most of a minute (the [[288,12,18]] DEM, 5,184 x 204,765)."""
    H = np.asarray(H)
    m, n = H.shape
    R = np.zeros((m, -(-n // 64) * 8), np.uint8)
    R[:, : -(-n // 8)] = np.packbits(H & 1, axis=1, bitorder="little")
    R = R.view("<u8")
    rank = 0
    for i in range(m):
        nz = np.flatnonzero(R[i])
        if not nz.size:
            continue
        w = nz[0]
        word = int(R[i, w])
        bit = np.uint64((word & -word).bit_length() - 1)  # the row's lowest set bit
        rank += 1
        below = i + 1 + np.flatnonzero((R[i + 1:, w] >> bit) & np.uint64(1))
        R[below, w:] ^= R[i, w:]
    return rank


class OSDDecoder(nn.Module):
    """Batched OSD-0 post-processor for a fixed parity-check matrix.

    Usage::

        osd = OSDDecoder(H, OSDConfig()).to(device)
        solutions = osd(syndromes, llrs, hard)   # all batched (B, ...)
    """

    def __init__(self, H: np.ndarray, config: OSDConfig = OSDConfig()):
        super().__init__()
        self.config = config
        H = (np.asarray(H) % 2).astype(np.uint8)
        self.m, self.n = H.shape
        self.n_words = -(-self.n // WORD)
        self.m_words = -(-self.m // WORD)
        self.wide = self.n_words > 4 * self.m_words
        # a narrow system whose packed rows overflow K2's warp takes the
        # column eliminations too
        by_rows = not self.wide and rows_smem_bytes(self.m, self.n_words) <= ROWS_SMEM_LIMIT
        # every column step after a sample reaches rank(H) is a no-op
        self.h_rank = gf2_rank(H)
        if config.backend != "auto" and by_rows:
            raise ValueError(
                f"backend={config.backend!r} targets wide systems (n_words > "
                "4 * m_words) and ones too large for the row elimination; this "
                "one takes the row elimination"
            )
        if not by_rows:
            self.elimination = config.backend
            if self.elimination == "auto":
                fits = smem_bytes(self.m) <= SMEM_LIMIT
                self.elimination = "transform" if fits else "factored"
            vos, self.dc_parity = parity_tables(H)
            self.register_buffer("vos_parity", torch.from_numpy(vos.astype(np.int64)))
            if self.elimination == "transform":
                self.register_buffer("Hc", torch.from_numpy(pack_columns(H)))
            else:
                self.register_buffer("Hc", torch.from_numpy(factored_columns(H)))
                self.max_cols = max(config.max_elim_cols, min(self.n, self.h_rank + 512))
        else:
            self.elimination = "rows"
            self.register_buffer("Hc", torch.from_numpy(pack_columns(H)))
            self.register_buffer("Hf", torch.from_numpy(H.astype(np.float32)))

    def _residual(self, syndromes, hard):
        B = hard.shape[0]
        if self.elimination != "rows":
            hp = torch.nn.functional.pad(hard, (0, 1))  # phantom slots read n
            hs = hp[:, self.vos_parity].view(B, self.m, self.dc_parity)
            s_hat = hs.sum(dim=-1, dtype=torch.int32) % 2
        else:
            s_hat = torch.remainder(hard.to(torch.float32) @ self.Hf.T, 2.0).to(torch.int32)
        return (syndromes.to(torch.int32) + s_hat) % 2

    def forward(self, syndromes: torch.Tensor, llrs: torch.Tensor,
                hard: torch.Tensor) -> torch.Tensor:
        """OSD-0 solutions (B, n) int8."""
        dev = self.Hc.device
        syndromes = torch.as_tensor(syndromes, device=dev)
        llrs = torch.as_tensor(llrs, device=dev)
        hard = torch.as_tensor(hard, device=dev).to(torch.int32)
        B, n = hard.shape
        resid = self._residual(syndromes, hard)
        order = torch.argsort(llrs.abs(), dim=1, stable=True)  # (B, n)
        bidx = torch.arange(B, device=dev)[:, None]
        if self.elimination == "factored":
            # piv_col comes back in original column ids: no un-permuting
            b, _, piv, overflow = eliminate_factored(order, resid, self.Hc, self.h_rank,
                                                     self.max_cols)
            corr = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
            corr[bidx, torch.where(piv >= 0, piv, n).long()] = b
            sol = hard ^ corr[:, :n]
            return torch.where(overflow[:, None], hard, sol).to(torch.int8)
        # OSD-0 reads only (b, piv_col): the transform elimination's b-exit
        # leaves them exact, and the row elimination returns nothing else
        if self.elimination == "transform":
            _, b, _, piv = eliminate_transform(order, resid, self.Hc, self.h_rank,
                                               b_exit=True)
        else:
            b, piv = eliminate_ordered(order, resid, self.Hc, self.h_rank)
        tgt = torch.where(piv >= 0, piv, n).long()
        e_perm = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
        e_perm[bidx, tgt] = b
        corr = torch.zeros((B, n), dtype=torch.int32, device=dev)
        corr[bidx, order] = e_perm[:, :n]
        return (hard ^ corr).to(torch.int8)
