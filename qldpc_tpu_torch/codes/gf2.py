# Copied from qldpc_tpu/codes/gf2.py: the port keeps its own copy and imports nothing of qldpc_tpu.
"""GF(2) linear algebra (host-side, NumPy).

Foundation for code construction: row reduction, rank, null space, and
logical-operator computation for CSS codes. The reference delegated all of
this to the external ``qldpc`` library (reference: generateCodeMatrices.py:2,52);
here it is owned by the framework so code construction has no external
dependencies.

All matrices are dense uint8 arrays with entries in {0, 1}. These routines run
once per code at construction time, so clarity beats speed; the *on-device*
GF(2) elimination used by the OSD decoder lives in
``qldpc_tpu.decoders.osd`` and is a separate, batched, bit-packed design.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "row_reduce",
    "rank",
    "null_space",
    "row_space_basis",
    "in_row_space",
    "solve",
    "css_logical_ops",
]


def _as_gf2(M: np.ndarray) -> np.ndarray:
    return (np.asarray(M) % 2).astype(np.uint8)


def row_reduce(M: np.ndarray, ncols: int | None = None):
    """Reduced row echelon form over GF(2).

    Returns ``(R, pivot_cols)`` where ``R`` is the RREF of ``M`` (same shape)
    and ``pivot_cols`` lists the pivot column of each nonzero row, in order.
    Only the first ``ncols`` columns are eligible as pivots (useful for
    augmented systems).
    """
    R = _as_gf2(M).copy()
    m, n = R.shape
    if ncols is None:
        ncols = n
    pivot_cols: list[int] = []
    r = 0
    for c in range(ncols):
        if r >= m:
            break
        rows = np.nonzero(R[r:, c])[0]
        if rows.size == 0:
            continue
        p = r + rows[0]
        if p != r:
            R[[r, p]] = R[[p, r]]
        # clear every other row containing this pivot column
        others = np.nonzero(R[:, c])[0]
        others = others[others != r]
        R[others] ^= R[r]
        pivot_cols.append(c)
        r += 1
    return R, pivot_cols


def rank(M: np.ndarray) -> int:
    _, piv = row_reduce(M)
    return len(piv)


def row_space_basis(M: np.ndarray) -> np.ndarray:
    R, piv = row_reduce(M)
    return R[: len(piv)]


def null_space(M: np.ndarray) -> np.ndarray:
    """Basis of the right null space: rows ``v`` with ``M @ v = 0 (mod 2)``.

    Returns an array of shape ``(n - rank, n)``.
    """
    M = _as_gf2(M)
    m, n = M.shape
    R, piv = row_reduce(M)
    piv_set = set(piv)
    free = [c for c in range(n) if c not in piv_set]
    basis = np.zeros((len(free), n), dtype=np.uint8)
    for i, f in enumerate(free):
        basis[i, f] = 1
        # each pivot row reads: x[piv[r]] = sum of free-column entries
        for r, pc in enumerate(piv):
            if R[r, f]:
                basis[i, pc] = 1
    return basis


def in_row_space(M: np.ndarray, v: np.ndarray) -> bool:
    """True iff ``v`` lies in the GF(2) row space of ``M``."""
    M = _as_gf2(M)
    v = _as_gf2(np.atleast_2d(v))
    base = rank(M)
    return rank(np.vstack([M, v])) == base


def solve(A: np.ndarray, b: np.ndarray) -> np.ndarray | None:
    """One solution ``x`` of ``A @ x = b (mod 2)``, or None if inconsistent."""
    A = _as_gf2(A)
    b = _as_gf2(b).ravel()
    m, n = A.shape
    aug = np.hstack([A, b[:, None]])
    R, piv = row_reduce(aug, ncols=n)
    # inconsistent iff some zero-row of A-part has 1 in the augmented column
    a_part, b_part = R[:, :n], R[:, n]
    zero_rows = ~a_part.any(axis=1)
    if (b_part[zero_rows] == 1).any():
        return None
    x = np.zeros(n, dtype=np.uint8)
    for r, c in enumerate(piv):
        x[c] = b_part[r]
    return x


def css_logical_ops(Hx: np.ndarray, Hz: np.ndarray):
    """Logical operator bases (Lx, Lz) of a CSS code.

    ``Hx`` (mx, n) detects Z errors; ``Hz`` (mz, n) detects X errors; CSS
    requires ``Hx @ Hz.T = 0``. Returns ``(Lx, Lz)`` each of shape (k, n)
    with: rows of Lx in ker(Hz) independent of rowspace(Hx); rows of Lz in
    ker(Hx) independent of rowspace(Hz); and the symplectic pairing
    ``Lx @ Lz.T = I`` (each logical-X anticommutes with exactly its paired
    logical-Z). Functional replacement for the external
    ``qldpc.get_logical_ops`` used at reference generateCodeMatrices.py:52-58.
    """
    Hx = _as_gf2(Hx)
    Hz = _as_gf2(Hz)
    n = Hx.shape[1]
    rx, rz = rank(Hx), rank(Hz)
    k = n - rx - rz
    if k <= 0:
        return (np.zeros((0, n), np.uint8), np.zeros((0, n), np.uint8))

    def quotient_basis(kernel: np.ndarray, stab: np.ndarray) -> np.ndarray:
        """Rows of ``kernel``-span independent of rowspace(stab), k of them."""
        base = row_space_basis(stab)
        r0 = base.shape[0]
        picked = []
        cur = base
        for v in kernel:
            cand = np.vstack([cur, v[None, :]])
            if rank(cand) > cur.shape[0]:
                cur = row_space_basis(cand)
                picked.append(v)
            if len(picked) == k:
                break
        return np.array(picked, dtype=np.uint8).reshape(len(picked), n)

    Lx = quotient_basis(null_space(Hz), Hx)
    Lz = quotient_basis(null_space(Hx), Hz)
    assert Lx.shape[0] == k and Lz.shape[0] == k, "logical extraction failed"

    # Symplectic Gram-Schmidt: make pairing Lx @ Lz.T the identity.
    P = (Lx @ Lz.T) % 2
    # P is invertible over GF(2) (the quotient pairing is non-degenerate);
    # want M with Lx @ (M Lz).T = P M^T = I, i.e. M = (P^{-1})^T.
    Pinv = _gf2_inverse(P)
    Lz = (Pinv.T @ Lz) % 2
    assert np.array_equal((Lx @ Lz.T) % 2, np.eye(k, dtype=np.uint8))
    return Lx.astype(np.uint8), Lz.astype(np.uint8)


def _gf2_inverse(P: np.ndarray) -> np.ndarray:
    P = _as_gf2(P)
    k = P.shape[0]
    aug = np.hstack([P, np.eye(k, dtype=np.uint8)])
    R, piv = row_reduce(aug, ncols=k)
    if len(piv) != k:
        raise np.linalg.LinAlgError("matrix not invertible over GF(2)")
    return R[:, k:]
