# Copied from qldpc_tpu/codes/bb.py: the port keeps its own copy and imports nothing of qldpc_tpu.
"""Bivariate-bicycle (BB) code construction.

Builds the IBM "gross code" family from circulant shift polynomials, replacing
the reference's dependency on the external ``qldpc.codes.BBCode``
(reference: generateCodeMatrices.py:5-46). A BB code over Z_l x Z_m is defined
by two bivariate polynomials

    a(x, y) = sum_i x^{a_i} y^{b_i},    b(x, y) = sum_j x^{c_j} y^{d_j}

where x acts as the cyclic shift on Z_l and y on Z_m. With
A = a(X, Y), B = b(X, Y) (sums of permutation matrices, size lm x lm):

    Hx = [A | B],    Hz = [B^T | A^T]

which satisfies the CSS condition since A and B commute (both are polynomials
in the commuting shifts X = S_l (x) I_m, Y = I_l (x) S_m).
"""

from __future__ import annotations

import numpy as np

from . import gf2
from .css import CSSCode

__all__ = ["shift_matrix", "bb_block", "make_bb_code"]


def shift_matrix(size: int, power: int = 1) -> np.ndarray:
    """Cyclic shift permutation S with S[i, (i + power) % size] = 1.

    (np.roll(eye, power, axis=1) places row i's one at column (i + power) %
    size.) The shift direction matches the convention of the reference's code
    files (verified bit-exact against codes/*.npz produced by
    generateCodeMatrices.py).
    """
    return np.roll(np.eye(size, dtype=np.uint8), power, axis=1)


def bb_block(l: int, m: int, terms: list[tuple[int, int]]) -> np.ndarray:
    """Sum over GF(2) of x^i y^j monomial matrices, x over Z_l, y over Z_m."""
    M = np.zeros((l * m, l * m), dtype=np.uint8)
    for (i, j) in terms:
        M ^= np.kron(shift_matrix(l, i), shift_matrix(m, j))
    return M


def make_bb_code(
    l: int,
    m: int,
    a_terms: list[tuple[int, int]],
    b_terms: list[tuple[int, int]],
    name: str | None = None,
    distance: int = 0,
    compute_logicals: bool = True,
) -> CSSCode:
    """Construct a BB CSS code from its defining polynomials.

    Args:
      l, m: circulant orders (x has order l, y has order m).
      a_terms/b_terms: monomials as (x_power, y_power) pairs.
      distance: known code distance (stored as metadata).
    """
    A = bb_block(l, m, a_terms)
    B = bb_block(l, m, b_terms)
    Hx = np.hstack([A, B])
    Hz = np.hstack([B.T, A.T])
    n = 2 * l * m
    if compute_logicals:
        Lx, Lz = gf2.css_logical_ops(Hx, Hz)
    else:
        Lx = Lz = np.zeros((0, n), dtype=np.uint8)
    k = n - gf2.rank(Hx) - gf2.rank(Hz)
    code = CSSCode(
        name=name or f"[[{n}, {k}, {distance}]]",
        Hx=Hx,
        Hz=Hz,
        Lx=Lx,
        Lz=Lz,
        distance=distance,
    )
    code.validate()
    return code
