# Copied from qldpc_tpu/codes/registry.py: the port keeps its own copy and imports nothing of qldpc_tpu.
"""Named registry of built-in codes.

The five BB codes studied by the reference (generateCodeMatrices.py:5-46) plus
the Steane [[7,1,3]] code (generateCodeMatrices.py:64-70). Codes are built on
first access and cached; ``get_code(name)`` is the framework-wide entry point.
"""

from __future__ import annotations

import functools

import numpy as np

from . import gf2
from .bb import make_bb_code
from .css import CSSCode

# name -> (l, m, a_terms, b_terms, distance); polynomial exponents follow the
# reference definitions, e.g. [[144,12,12]]: a = x^3 + y + y^2, b = y^3 + x + x^2.
BB_CODE_DEFS: dict[str, tuple[int, int, list, list, int]] = {
    "[[72, 12, 6]]": (6, 6, [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)], 6),
    "[[90, 8, 10]]": (15, 3, [(9, 0), (0, 1), (0, 2)], [(0, 0), (2, 0), (7, 0)], 10),
    "[[108, 8, 10]]": (9, 6, [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)], 10),
    "[[144, 12, 12]]": (12, 6, [(3, 0), (0, 1), (0, 2)], [(0, 3), (1, 0), (2, 0)], 12),
    "[[288, 12, 18]]": (12, 12, [(3, 0), (0, 2), (0, 7)], [(0, 3), (1, 0), (2, 0)], 18),
}

BB_CODE_NAMES = tuple(BB_CODE_DEFS)
ALL_CODE_NAMES = BB_CODE_NAMES + ("steane",)


def make_steane() -> CSSCode:
    """Steane [[7,1,3]]: H = Hamming(7,4) check matrix for both X and Z."""
    H = np.array(
        [
            [1, 0, 1, 0, 1, 0, 1],
            [0, 1, 1, 0, 0, 1, 1],
            [0, 0, 0, 1, 1, 1, 1],
        ],
        dtype=np.uint8,
    )
    Lx, Lz = gf2.css_logical_ops(H, H)
    return CSSCode(name="steane", Hx=H, Hz=H, Lx=Lx, Lz=Lz, distance=3)


@functools.lru_cache(maxsize=None)
def get_code(name: str) -> CSSCode:
    """Build (and cache) a registered code by name."""
    if name == "steane":
        return make_steane()
    if name in BB_CODE_DEFS:
        l, m, a, b, d = BB_CODE_DEFS[name]
        return make_bb_code(l, m, a, b, name=name, distance=d)
    raise KeyError(f"unknown code {name!r}; known: {list(ALL_CODE_NAMES)}")
