# Copied from qldpc_tpu/codes/css.py: the port keeps its own copy and imports nothing of qldpc_tpu.
"""CSS code container.

The framework's code object: parity checks, logical operators, and metadata.
Interface-compatible with the reference's ``codes/*.npz`` persistence format
(keys ``Hx, Hz, Lx, Lz, distance``; reference: generateCodeMatrices.py:62-70),
so reference-generated code files load directly as fixtures.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from . import gf2


@dataclasses.dataclass(frozen=True)
class CSSCode:
    """A CSS quantum code defined by X/Z parity-check matrices.

    Attributes:
      name: human-readable identifier, e.g. ``"[[144, 12, 12]]"``.
      Hx: (mx, n) uint8 X-type parity checks (detect Z errors).
      Hz: (mz, n) uint8 Z-type parity checks (detect X errors).
      Lx: (k, n) uint8 logical-X operators (may be empty if unknown).
      Lz: (k, n) uint8 logical-Z operators.
      distance: code distance (0 when unknown).
    """

    name: str
    Hx: np.ndarray
    Hz: np.ndarray
    Lx: np.ndarray
    Lz: np.ndarray
    distance: int = 0

    def __post_init__(self):
        for f in ("Hx", "Hz", "Lx", "Lz"):
            object.__setattr__(self, f, (np.asarray(getattr(self, f)) % 2).astype(np.uint8))
        css = (self.Hx @ self.Hz.T) % 2
        if css.size and css.any():
            raise ValueError(f"{self.name}: Hx @ Hz.T != 0 — not a CSS code")

    # ---- derived quantities -------------------------------------------------
    @property
    def n(self) -> int:
        return int(self.Hx.shape[1])

    @property
    def k(self) -> int:
        return self.n - gf2.rank(self.Hx) - gf2.rank(self.Hz)

    @property
    def params(self) -> tuple[int, int, int]:
        return (self.n, self.k, self.distance)

    def validate(self) -> None:
        """Check logical-operator invariants (commutation + pairing)."""
        if self.Lx.size:
            assert not ((self.Hz @ self.Lx.T) % 2).any(), "Lx must commute with Hz"
        if self.Lz.size:
            assert not ((self.Hx @ self.Lz.T) % 2).any(), "Lz must commute with Hx"
        if self.Lx.size and self.Lz.size:
            pairing = (self.Lx @ self.Lz.T) % 2
            assert pairing.shape[0] == pairing.shape[1]

    # ---- persistence (reference-compatible npz) -----------------------------
    def save(self, path: str | Path) -> None:
        np.savez(
            path,
            Hx=self.Hx.astype(np.int64),
            Hz=self.Hz.astype(np.int64),
            Lx=self.Lx,
            Lz=self.Lz,
            distance=self.distance,
        )

    @classmethod
    def load(cls, path: str | Path, name: str | None = None) -> "CSSCode":
        """Load from npz; accepts reference files lacking Lx/Lz (e.g. steane.npz)."""
        d = np.load(path)
        n = d["Hx"].shape[1]
        empty = np.zeros((0, n), dtype=np.uint8)
        return cls(
            name=name or Path(path).stem,
            Hx=d["Hx"],
            Hz=d["Hz"],
            Lx=d["Lx"] if "Lx" in d else empty,
            Lz=d["Lz"] if "Lz" in d else empty,
            distance=int(d["distance"]) if "distance" in d else 0,
        )
