# Copied from qldpc_tpu/ops/tanner.py: the port keeps its own copy and imports nothing of qldpc_tpu.
"""Tanner-graph edge-list layout for TPU message passing.

The reference's accelerated decoders all use a dense masked ``(m, n)`` message
matrix (reference: decoding/beliefPropagation.py:101-133,
decoding/beliefPropagationJAX.py:36-69), which wastes O(m*n) work on a graph
with only O(E) edges (BB codes: row weight 6, column weight 3, so E = 6m
while m*n = 2*m^2*... ~24x larger). This module builds the *edge-list* layout
the TPU decoders use instead:

- edges are sorted by (check, variable), so per-check message groups are
  contiguous: for check-regular codes the check-side "gather" is a reshape;
- per-variable groups are padded fixed-width tables of edge indices, so the
  variable-side update is a single static gather;
- one phantom edge (index E) absorbs padding: its message is pinned to the
  operation's neutral element.

All tables are static numpy arrays baked into the jitted decoder as constants.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TannerGraph", "parity_tables"]


def parity_tables(H: np.ndarray) -> tuple[np.ndarray, int]:
    """Padded var-of-slot table for gather-parity syndromes.

    Returns ``(vos (m * dc_pad,) int32, dc_pad)`` with phantom slots
    pointing at column index ``n`` (callers append a zero column). Computing
    ``s = parity over each check's slots of bits[vos]`` replaces the dense
    ``bits @ H.T`` matmul — essential for wide systems (circuit DEMs:
    a [[144,12,12]] H as an f32 constant is 463 MB, which both bloats HBM
    and overflows the remote-compile request), and built fully vectorized
    (no per-edge Python loop)."""
    H = (np.asarray(H) % 2).astype(np.uint8)
    m, n = H.shape
    checks, vars_ = np.nonzero(H)  # row-major: sorted by check
    dc = np.bincount(checks, minlength=m)
    dc_pad = int(dc.max()) if vars_.size else 1
    starts = np.concatenate([[0], np.cumsum(dc)[:-1]])
    pos = np.arange(vars_.size) - np.repeat(starts, dc)
    vos = np.full(m * dc_pad, n, np.int64)
    vos[checks * dc_pad + pos] = vars_
    return vos.astype(np.int32), dc_pad


@dataclasses.dataclass(frozen=True)
class TannerGraph:
    """Static edge-list representation of a parity-check matrix.

    Attributes:
      m, n, num_edges: checks, variables, edges (nnz of H).
      check_edge: (m, dc_max) int32 edge ids per check, padded with num_edges.
      var_edge: (n, dv_max) int32 edge ids per variable, padded with num_edges.
      var_of_edge: (num_edges,) int32 variable index of each edge.
      check_of_edge: (num_edges,) int32 check index of each edge.
      check_slot_of_edge: (num_edges,) int32 flat position of each edge in the
        row-major (m, dc_max) check table — the inverse map used to read
        check-side results back into edge order with one gather.
      check_regular: True when every check has degree dc_max AND the edge
        order makes check_edge the identity layout (reshape, no gather).
    """

    m: int
    n: int
    num_edges: int
    dc_max: int
    dv_max: int
    check_edge: np.ndarray
    var_edge: np.ndarray
    var_of_edge: np.ndarray
    check_of_edge: np.ndarray
    check_slot_of_edge: np.ndarray
    check_regular: bool
    H: np.ndarray  # (m, n) uint8, kept for syndrome/matmul paths

    @classmethod
    def from_H(cls, H: np.ndarray) -> "TannerGraph":
        H = (np.asarray(H) % 2).astype(np.uint8)
        m, n = H.shape
        checks, vars_ = np.nonzero(H)  # row-major: sorted by (check, var)
        E = checks.size
        dc = np.bincount(checks, minlength=m)
        dv = np.bincount(vars_, minlength=n)
        dc_max = int(dc.max()) if E else 1
        dv_max = int(dv.max()) if E else 1

        # fully vectorized table builds (DEM graphs have 10^5-10^6 edges;
        # per-edge Python loops cost seconds per engine build there).
        # Edges are check-major, so within-check slot = e - first edge of
        # its check; the var table uses the same trick on the var-stable
        # edge ordering.
        check_edge = np.full((m, dc_max), E, dtype=np.int32)
        starts_c = np.concatenate([[0], np.cumsum(dc)[:-1]])
        slot_in_check = (np.arange(E) - np.repeat(starts_c, dc)).astype(
            np.int32
        )
        check_edge[checks, slot_in_check] = np.arange(E, dtype=np.int32)

        var_edge = np.full((n, dv_max), E, dtype=np.int32)
        by_var = np.argsort(vars_, kind="stable")  # edge ids, var-major
        starts_v = np.concatenate([[0], np.cumsum(dv)[:-1]])
        slot_in_var = np.arange(E) - np.repeat(starts_v, dv)
        var_edge[vars_[by_var], slot_in_var] = by_var.astype(np.int32)

        check_slot_of_edge = (checks * dc_max + slot_in_check).astype(np.int32)
        check_regular = bool((dc == dc_max).all()) and bool(
            np.array_equal(check_slot_of_edge, np.arange(E, dtype=np.int32))
        )
        return cls(
            m=m,
            n=n,
            num_edges=E,
            dc_max=dc_max,
            dv_max=dv_max,
            check_edge=check_edge,
            var_edge=var_edge,
            var_of_edge=vars_.astype(np.int32),
            check_of_edge=checks.astype(np.int32),
            check_slot_of_edge=check_slot_of_edge,
            check_regular=check_regular,
            H=H,
        )
