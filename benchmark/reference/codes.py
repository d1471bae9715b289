"""Bivariate-bicycle codes and their logical operators, frozen for the reference.

A BB code over Z_l x Z_m is given by two polynomials a = sum x^i y^j and
b = sum x^i y^j; with A = a(X, Y), B = b(X, Y), X = S_l (x) I_m and
Y = I_l (x) S_m (S the cyclic shift with S[i, (i + 1) % size] = 1):

    Hx = [A | B],   Hz = [B^T | A^T].

The logical bases are picked as the engines under test pick them (the
first kernel vectors, in the order of a GF(2) null-space basis, that are
independent of the stabilizers, then paired so that Lx @ Lz^T = I). The
choice matters: a circuit's observables are the rows of Lz, and they enter
every mechanism's signature in the detector error model.
"""

from __future__ import annotations

import numpy as np


def _gf2(M) -> np.ndarray:
    return (np.asarray(M) % 2).astype(np.uint8)


def row_reduce(M, ncols: int | None = None):
    """(RREF of M over GF(2), pivot columns), pivots among the first ``ncols``."""
    R = _gf2(M).copy()
    m, n = R.shape
    ncols = n if ncols is None else ncols
    pivots: list[int] = []
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
        others = np.nonzero(R[:, c])[0]
        others = others[others != r]
        R[others] ^= R[r]
        pivots.append(c)
        r += 1
    return R, pivots


def rank(M) -> int:
    return len(row_reduce(M)[1])


def _null_space(M) -> np.ndarray:
    M = _gf2(M)
    n = M.shape[1]
    R, piv = row_reduce(M)
    free = [c for c in range(n) if c not in set(piv)]
    basis = np.zeros((len(free), n), dtype=np.uint8)
    for i, f in enumerate(free):
        basis[i, f] = 1
        for r, pc in enumerate(piv):
            if R[r, f]:
                basis[i, pc] = 1
    return basis


def _inverse(P) -> np.ndarray:
    k = P.shape[0]
    R, piv = row_reduce(np.hstack([_gf2(P), np.eye(k, dtype=np.uint8)]), ncols=k)
    if len(piv) != k:
        raise np.linalg.LinAlgError("not invertible over GF(2)")
    return R[:, k:]


def logicals(Hx, Hz):
    """(Lx, Lz), k rows each, with Lx @ Lz^T = I over GF(2)."""
    Hx, Hz = _gf2(Hx), _gf2(Hz)
    n = Hx.shape[1]
    k = n - rank(Hx) - rank(Hz)

    def quotient(kernel, stab):
        cur = row_reduce(stab)[0][: rank(stab)]
        picked = []
        for v in kernel:
            cand = np.vstack([cur, v[None, :]])
            if rank(cand) > cur.shape[0]:
                R, piv = row_reduce(cand)
                cur = R[: len(piv)]
                picked.append(v)
            if len(picked) == k:
                break
        return np.array(picked, dtype=np.uint8).reshape(len(picked), n)

    Lx = quotient(_null_space(Hz), Hx)
    Lz = quotient(_null_space(Hx), Hz)
    Lz = (_inverse((Lx.astype(np.int64) @ Lz.T) % 2).T.astype(np.int64) @ Lz) % 2
    if not np.array_equal((Lx.astype(np.int64) @ Lz.T) % 2, np.eye(k, dtype=np.int64)):
        raise ValueError("logical pairing failed")
    return Lx.astype(np.uint8), Lz.astype(np.uint8)


def _shift(size: int, power: int) -> np.ndarray:
    return np.roll(np.eye(size, dtype=np.uint8), power, axis=1)


def _block(l: int, m: int, terms) -> np.ndarray:
    M = np.zeros((l * m, l * m), dtype=np.uint8)
    for i, j in terms:
        M ^= np.kron(_shift(l, i), _shift(m, j))
    return M


def bb_code(spec: dict) -> dict:
    """{"Hx", "Hz", "Lx", "Lz", "distance"} of the BB code that ``spec``
    gives by ``l``, ``m``, ``a``, ``b`` (lists of [x power, y power]) and
    ``d``; checks the published ``n`` and ``k``."""
    A = _block(spec["l"], spec["m"], spec["a"])
    B = _block(spec["l"], spec["m"], spec["b"])
    Hx, Hz = np.hstack([A, B]), np.hstack([B.T, A.T])
    if ((Hx.astype(np.int64) @ Hz.T) % 2).any():
        raise ValueError("not a CSS code")
    Lx, Lz = logicals(Hx, Hz)
    if Hx.shape[1] != spec["n"] or Lx.shape[0] != spec["k"]:
        raise ValueError(f"built [[{Hx.shape[1]}, {Lx.shape[0]}]], the source says "
                         f"[[{spec['n']}, {spec['k']}]]")
    return {"Hx": Hx, "Hz": Hz, "Lx": Lx, "Lz": Lz, "distance": int(spec["d"])}
