"""Ordered-statistics decoding (OSD-0) in torch.

Port of the OSD-0 lanes pipeline of qldpc_tpu/decoders/osd.py
(``_lanes_core``): the residual syndrome of the BP hard decision, columns
ordered by ascending |LLR| (stable: ties are common and the order decides
them), each sample's permuted H bit-packed, a full GF(2) elimination
(``ops.osd_cuda.eliminate_rows``: plain torch on CPU, the kernel K2 on
CUDA), then ``e_perm[piv_col[r]] = b[r]``, ``corr[order] = e_perm`` and
``solution = hard XOR corr``.

Not in this slice (see ROADMAP.md): OSD-e (``order > 0``) and wide systems
(circuit-level DEMs, which take the transform elimination).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from qldpc_tpu.codes import gf2
from qldpc_tpu_torch.ops.osd_cuda import WORD, eliminate_rows, pack_rows

__all__ = ["OSDConfig", "OSDDecoder"]


@dataclasses.dataclass(frozen=True)
class OSDConfig:
    order: int = 0

    def __post_init__(self):
        if self.order > 0:
            raise NotImplementedError(
                "OSD-e (order > 0) is not ported yet (ROADMAP.md, queue 1 "
                "item 4)"
            )
        if self.order < 0:
            raise ValueError("order must be >= 0")


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
        m_words = -(-self.m // WORD)
        if self.n_words > 4 * m_words:
            raise NotImplementedError(
                "wide systems (n_words > 4 * m_words) take the transform "
                "elimination, which is not ported yet (ROADMAP.md, queue 1 "
                "item 10)"
            )
        # every column step after a sample reaches rank(H) is a no-op
        self.h_rank = int(gf2.rank(H))
        self.register_buffer("H", torch.from_numpy(H))
        self.register_buffer("Hf", torch.from_numpy(H.astype(np.float32)))

    def forward(self, syndromes: torch.Tensor, llrs: torch.Tensor,
                hard: torch.Tensor) -> torch.Tensor:
        """OSD-0 solutions (B, n) int8."""
        dev = self.H.device
        syndromes = torch.as_tensor(syndromes, device=dev)
        llrs = torch.as_tensor(llrs, device=dev)
        hard = torch.as_tensor(hard, device=dev).to(torch.int32)
        B, n = hard.shape
        resid = (
            syndromes.to(torch.int32)
            + torch.remainder(hard.to(torch.float32) @ self.Hf.T, 2.0).to(torch.int32)
        ) % 2
        order = torch.argsort(llrs.abs(), dim=1, stable=True)  # (B, n)
        Hp = self.H[:, order].permute(1, 0, 2)  # (B, m, n) per-sample permuted
        A = pack_rows(Hp)
        _, b, piv = eliminate_rows(A, resid, n, self.h_rank)
        bidx = torch.arange(B, device=dev)[:, None]
        tgt = torch.where(piv >= 0, piv, n).long()
        e_perm = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
        e_perm[bidx, tgt] = b
        corr = torch.zeros((B, n), dtype=torch.int32, device=dev)
        corr[bidx, order] = e_perm[:, :n]
        return (hard ^ corr).to(torch.int8)
