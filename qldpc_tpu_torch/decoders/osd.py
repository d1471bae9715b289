"""Ordered-statistics decoding (OSD-0 and OSD-e) in torch.

Port of the lanes pipeline of qldpc_tpu/decoders/osd.py (``_lanes_core``,
``_osde_lanes``): the residual syndrome of the BP hard decision, columns
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
    JAX decoder's column budget ``max(max_elim_cols, min(n, rank + 512))``,
    then, with ``auto``, the transform elimination (K4g on CUDA) on the
    samples that exhaust it unresolved (route ``"factored+transform"``).
    With ``backend="factored"`` such a sample returns ``hard`` unchanged, as
    the JAX factored backend does, so that the engine counts it as a failure
    rather than accept a partial solve.

All three give the OSD-0 solution of the JAX ``lanes`` path: the transform
elimination's ``(b, piv_col)`` are the lanes path's, and the factored one's
are for every sample that stays within its budget; ``auto`` sends the
others through the transform, as the lanes path, which has no budget,
runs every sample.

OSD-e (``order > 0``): a system is consistent when every row without a
pivot carries a zero syndrome bit, and a consistent system returns its
OSD-0 solution untouched (the reference's early return). Only the
inconsistent samples are searched: the flip patterns of weight <= order
over the ``order + extra_positions`` least reliable columns without a pivot
(``make_flip_patterns``, the zero pattern first) are scored by the LLR cost
``F @ w_test + piv_vals @ w_piv`` with ``piv_vals = (F @ Tmat^T + b) mod 2``,
and the first minimum wins. A step takes ``chunk`` samples, or fewer where
their float64 ``piv_vals`` would pass ``SEARCH_BYTES`` (3 samples a step at
the [[144,12,12]] DEM with order 7, 1 at [[288,12,18]]). The costs are
summed in float64, where sums of float32 LLRs are exact in any order
(unless their magnitudes span more than 2^29), so that the card and the CPU
break ties alike (the first pattern of equal cost); the JAX package sums
them in float32 in XLA's order, so where two patterns flip the same
multiset of LLRs its rounding may pick the later one (ROADMAP.md Queue 3).
The search reads each test column's bits in the reduced system: on the
rows path from K2's packed-rows loader (``eliminate_rows``), run on those
samples' permuted rows alone, so that a workload of consistent syndromes
pays nothing for OSD-e; on the transform path from T, as
``parity(T[r] & Hc[order[c]])`` folded a word at a time. An inconsistent
sample never b-exits (a syndrome bit stays on a row without a pivot), so
its T is the full-rank transform. The search is XLA code in the JAX
package, outside any Pallas kernel, and stays torch here (``torch.bmm`` and
elementwise ops).

Past K4's block ``auto`` takes the route ``"factored+transform"`` for
every order, where the JAX package runs its XLA transform on every sample:
the factored elimination's OSD-0 on the whole batch, then the transform
elimination with the b-exit on (K4g on CUDA: a cluster of blocks a sample,
``T_BYTES`` of T at a time, any number of rows) on the samples that ran out
of the column budget, whose OSD-0 solution (the JAX path's, which has no
budget) replaces the factored one. With ``order > 0`` the factored
(b, pivoted) also tell the consistent samples apart (the transform's test on
the same rows: a sample that b-exits has cleared b at and below its rank,
an inconsistent one runs to rank(H) in both): the consistent ones keep
their OSD-0 solution, the inconsistent ones take the transform too, and the
search. A batch of syndromes in H's image pays the test, and the transform
only for its samples past the budget. ``backend="factored"`` with
``order > 0`` raises ``ValueError``, as in the JAX package.

``OSDConfig.backend`` forces the transform or the factored elimination on a
system the row elimination does not take; no path falls back to another.
``OSDDecoder.elimination`` names the route taken: ``"rows"``,
``"transform"``, ``"factored"`` or ``"factored+transform"``.
"""

from __future__ import annotations

import dataclasses
from itertools import combinations

import numpy as np
import torch
from torch import nn

from qldpc_tpu_torch.ops.tanner import parity_tables
from qldpc_tpu_torch.ops.osd_cuda import (
    ROWS_SMEM_LIMIT,
    WORD,
    eliminate_ordered,
    eliminate_rows,
    pack_permuted_rows,
    rows_smem_bytes,
)
from qldpc_tpu_torch.ops.osd_factored_cuda import eliminate_factored, factored_columns
from qldpc_tpu_torch.ops.osd_transform_cuda import (
    SMEM_LIMIT,
    column_bits,
    eliminate_transform,
    global_fits,
    pack_columns,
    smem_bytes,
    t_bytes,
)
from qldpc_tpu_torch.utils.profiling import count, span

__all__ = ["OSDConfig", "OSDDecoder", "gf2_rank", "make_flip_patterns"]

# the factored elimination's column budget past rank(H): the JAX decoder's
# (qldpc_tpu/decoders/osd.py, ``max_elim_cols``: b-exits at rank + ~150)
BUDGET_SLACK = 512
# OSD-e past K4's block: the transform of the samples it takes, at most
# this many bytes of T at a time (320 samples of the [[288,12,18]] DEM)
T_BYTES = 1 << 30
# the search's float64 piv_vals (samples x patterns x m) in one step: 64
# samples at [[144,12,12]] code capacity with order 7, 3 at its DEM
SEARCH_BYTES = 2 << 30


_BACKENDS = ("auto", "transform", "factored")


# Copied from qldpc_tpu/decoders/osd.py::make_flip_patterns.
def make_flip_patterns(
    num_positions: int, order: int, max_combinations: int | None = None
) -> np.ndarray:
    """Static (C, num_positions) 0/1 pattern matrix; row 0 is the zero pattern.

    Rows follow the reference's enumeration order — weight w = 1..order, each
    weight in lexicographic combination order (OSD_enhanced.py:89-94) — so
    truncation by ``max_combinations`` and first-minimum tie-breaking agree.
    """
    rows = [np.zeros(num_positions, dtype=np.uint8)]
    budget = np.inf if max_combinations is None else max_combinations
    count = 0
    for w in range(1, min(order, num_positions) + 1):
        for combo in combinations(range(num_positions), w):
            if count >= budget:
                break
            row = np.zeros(num_positions, dtype=np.uint8)
            row[list(combo)] = 1
            rows.append(row)
            count += 1
        if count >= budget:
            break
    return np.stack(rows)


@dataclasses.dataclass(frozen=True)
class OSDConfig:
    order: int = 0
    max_combinations: int | None = None  # OSD-e: patterns after the zero one
    extra_positions: int = 10  # OSD-e: test set size = order + extra_positions
    backend: str = "auto"  # wide systems: "auto" picks the transform
    # elimination when a sample's transform fits one block's shared memory
    # and the factored one otherwise, then the transform on the samples past
    # its budget (OSD-e: and on those it searches); "transform" and
    # "factored" force one (the factored one returns ``hard`` past its budget)
    max_elim_cols: int = 2048  # factored elimination: column budget floor,
    # raised to min(n, rank(H) + 512) (decoders/osd.py of the JAX package)
    chunk: int = 64  # OSD-e: samples a search step takes at most (fewer
    # where their patterns x m workspace would pass SEARCH_BYTES)

    def __post_init__(self):
        if self.order < 0:
            raise ValueError("order must be >= 0")
        if self.extra_positions < 0:
            raise ValueError("extra_positions must be >= 0")
        if self.max_combinations is not None and self.max_combinations < 0:
            raise ValueError("max_combinations must be >= 0")
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown OSD backend {self.backend!r}; one of {_BACKENDS}")
        if self.max_elim_cols < 1:
            raise ValueError("max_elim_cols must be positive")
        if self.chunk < 1:
            raise ValueError("chunk must be positive")


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
    """Batched OSD-0 / OSD-e post-processor for a fixed parity-check matrix.

    Usage::

        osd = OSDDecoder(H, OSDConfig(order=7)).to(device)
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
        if config.order > 0 and config.backend == "factored":
            raise ValueError(
                "backend='factored' implements OSD-0 only (OSD-e reads the "
                "transform the factored elimination does not keep)"
            )
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
                self.elimination = "transform" if fits else "factored+transform"
            vos, self.dc_parity = parity_tables(H)
            self.register_buffer("vos_parity", torch.from_numpy(vos.astype(np.int64)))
            if self.elimination == "transform":
                self.register_buffer("Hc", torch.from_numpy(pack_columns(H)))
            else:
                # factored_columns(H)[:n] is pack_columns(H): the transform
                # of the searched samples reads the same buffer
                self.register_buffer("Hc", torch.from_numpy(factored_columns(H)))
                self.max_cols = max(config.max_elim_cols,
                                    min(self.n, self.h_rank + BUDGET_SLACK))
        else:
            self.elimination = "rows"
            self.register_buffer("Hc", torch.from_numpy(pack_columns(H)))
            self.register_buffer("Hf", torch.from_numpy(H.astype(np.float32)))
        self.num_test = min(config.order + config.extra_positions, self.n) if config.order else 0
        if config.order:
            patterns = make_flip_patterns(self.num_test, config.order, config.max_combinations)
            self.register_buffer("patterns", torch.from_numpy(patterns.astype(np.float32)))

    def _apply(self, fn, *args, **kwargs):
        super()._apply(fn, *args, **kwargs)
        self._check_device(self.Hc.device)
        return self

    def _check_device(self, device) -> None:
        """Past K4's block the transform runs K4g on the card, which takes
        any system whose per-slot state fits its widest cluster (217,808
        rows, ``global_fits``; every system whose one-sample T fits
        ``T_BYTES``): a larger one is refused when the decoder moves to the
        card, not at its first call. The CPU's plain version takes any size."""
        if self.elimination == "factored+transform" and torch.device(device).type == "cuda" \
                and not global_fits(self.m):
            raise ValueError(
                f"OSD on a {self.m}-row system past K4's block needs K4g, whose cluster "
                "of 16 blocks does not hold that many rows on the card; decode it on the "
                "CPU or with backend='factored'")

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
        """OSD-0 (``order == 0``) or OSD-e solutions (B, n) int8."""
        dev = self.Hc.device
        syndromes = torch.as_tensor(syndromes, device=dev)
        llrs = torch.as_tensor(llrs, device=dev)
        hard = torch.as_tensor(hard, device=dev).to(torch.int32)
        B, n = hard.shape
        resid = self._residual(syndromes, hard)
        order = torch.argsort(llrs.abs(), dim=1, stable=True)  # (B, n)
        if self.elimination == "transform":
            return self._transform_osd(order, resid, llrs, hard).to(torch.int8)
        if self.elimination == "rows":
            # OSD-0 reads only (b, piv_col), all the ordered loader returns;
            # the search reads K2's packed-rows loader on the samples it takes:
            # it pivots as the ordered loader does, so (b, piv) are the same
            b, piv = eliminate_ordered(order, resid, self.Hc, self.h_rank)

            def reduced(sel):
                rows = pack_permuted_rows(order[sel], self.Hc, self.m)
                return eliminate_rows(rows, resid[sel], n, self.h_rank)[0]

            return self._solve(b, piv, order, llrs, hard, reduced).to(torch.int8)
        # piv_col comes back in original column ids: no un-permuting
        b, pivoted, piv, overflow = eliminate_factored(order, resid, self.Hc, self.h_rank,
                                                       self.max_cols)
        bidx = torch.arange(B, device=dev)[:, None]
        corr = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
        corr[bidx, torch.where(piv >= 0, piv, n).long()] = b
        sol = torch.where(overflow[:, None], hard, hard ^ corr[:, :n])
        if self.elimination == "factored+transform":
            # the samples out of budget take the transform elimination,
            # ``T_BYTES`` of T at a time; OSD-e: also the inconsistent ones, by
            # the transform's test (a row without a pivot carrying a syndrome
            # bit) on the factored (b, pivoted), the same verdict for every
            # sample within the budget
            if self.config.order:
                overflow = overflow | ((pivoted == 0) & (b != 0)).any(dim=1)
            redo = torch.nonzero(overflow).flatten()
            count("host_syncs")
            count("osd.k4g_lanes", len(redo))
            group = max(1, T_BYTES // t_bytes(self.m))
            with span("osd.transform"):
                for s in range(0, len(redo), group):
                    g = redo[s:s + group]
                    sol[g] = self._transform_osd(order[g], resid[g], llrs[g], hard[g])
        return sol.to(torch.int8)

    def _transform_osd(self, order, resid, llrs, hard):
        """The transform elimination with the b-exit on, then the search on
        its inconsistent samples, which never b-exit (a syndrome bit stays on
        a row without a pivot), so that their T is the full-rank transform."""
        T, b, _, piv = eliminate_transform(order, resid, self.Hc[:self.n], self.h_rank,
                                           b_exit=True)
        return self._solve(b, piv, order, llrs, hard, lambda sel: T[sel])

    def _solve(self, b, piv, order, llrs, hard, reduced):
        """``hard ^ e`` (B, n) int32 from an elimination's (b, piv_col) in
        permuted columns: OSD-0's ``e_perm[piv_col[r]] = b[r]``, searched on
        the inconsistent samples with ``reduced(sel)``, their reduced rows
        or transforms."""
        B, n = hard.shape
        dev = hard.device
        bidx = torch.arange(B, device=dev)[:, None]
        e_perm = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
        e_perm[bidx, torch.where(piv >= 0, piv, n).long()] = b
        e_perm = e_perm[:, :n]
        if self.config.order:
            sel = torch.nonzero(((piv < 0) & (b != 0)).any(dim=1)).flatten()
            count("host_syncs")
            if len(sel):
                w = llrs[sel].abs() * (1.0 - 2.0 * hard[sel].to(llrs.dtype))
                e_perm[sel] = self._search(reduced(sel), b[sel], piv[sel], order[sel],
                                           torch.gather(w, 1, order[sel]))
        corr = torch.zeros((B, n), dtype=torch.int32, device=dev)
        corr[bidx, order] = e_perm
        return hard ^ corr

    def _search(self, R, b, piv, order, w_perm):
        """OSD-e corrections (k, n) int32 in permuted columns of k
        inconsistent samples: ``_search_single`` (R their reduced rows) or
        ``_search_single_T`` (R their transforms) of the JAX package. A step
        takes at most ``chunk`` samples, and fewer where their (patterns x m)
        float64 ``piv_vals`` would pass ``SEARCH_BYTES``. ``w_perm`` = |llr|
        * (1 - 2 * hard) in permuted columns."""
        per_sample = self.patterns.shape[0] * self.m * 8
        ch = max(1, min(self.config.chunk, SEARCH_BYTES // per_sample))
        return torch.cat([
            self._search_chunk(R[s:s + ch], b[s:s + ch], piv[s:s + ch], order[s:s + ch],
                               w_perm[s:s + ch])
            for s in range(0, piv.shape[0], ch)
        ])

    def _search_chunk(self, R, b, piv, order, w_perm):
        k, m, n, t = piv.shape[0], self.m, self.n, self.num_test
        # float64 costs: sums of float32 LLRs, exact in any order unless
        # their magnitudes span more than 2^29, so that patterns of equal
        # cost tie on every device and the first wins (and TF32, which
        # applies to float32 products alone, cannot round them)
        dev, dtype = piv.device, torch.float64
        w_perm = w_perm.to(dtype)
        tgt = torch.where(piv >= 0, piv, n).long()
        is_piv = torch.zeros((k, n + 1), dtype=torch.bool, device=dev)
        is_piv.scatter_(1, tgt, piv >= 0)  # only n repeats, always False
        is_piv = is_piv[:, :n]
        # the t least reliable columns without a pivot, pivots after them
        col_ids = torch.arange(n, device=dev)
        test_cols = torch.argsort(torch.where(is_piv, n + col_ids, col_ids), dim=1)[:, :t]
        valid = (~torch.gather(is_piv, 1, test_cols)).to(dtype)  # (k, t)
        if self.elimination == "rows":
            words = torch.gather(R, 2, (test_cols // WORD)[:, None, :].expand(k, m, t))
            bits = (words >> (test_cols % WORD).to(torch.int32)[:, None, :]) & 1
        else:
            # (k, m, t): the RREF bits of the test columns, parity(T[r] & hc[c])
            bits = column_bits(R, self.Hc, torch.gather(order, 1, test_cols))
        Tmat = bits.to(dtype) * valid[:, None, :]
        F = self.patterns.to(dtype)[None] * valid[:, None, :]  # (k, C, t)
        piv_vals = torch.bmm(F, Tmat.transpose(1, 2))  # (k, C, m), exact
        piv_vals.add_(b.to(dtype)[:, None, :]).remainder_(2.0)
        w_test = torch.gather(w_perm, 1, test_cols) * valid
        w_piv = torch.where(piv >= 0, torch.gather(w_perm, 1, piv.clamp(0, n - 1).long()),
                            torch.zeros((), dtype=dtype, device=dev))
        costs = torch.bmm(F, w_test[..., None]) + torch.bmm(piv_vals, w_piv[..., None])
        best = costs[..., 0].argmin(dim=1)  # the first minimum
        ar = torch.arange(k, device=dev)
        e = torch.zeros((k, n + 1), dtype=dtype, device=dev)
        e.scatter_(1, test_cols, F[ar, best])
        e.scatter_(1, tgt, torch.where(piv >= 0, piv_vals[ar, best], 0.0))
        return e[:, :n].to(torch.int32)
