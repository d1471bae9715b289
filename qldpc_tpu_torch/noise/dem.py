# Copied from qldpc_tpu/noise/dem.py: the port keeps its own copy and imports nothing of qldpc_tpu.
"""Detector-error-model (circuit-level) import path.

The reference's circuit-level pipeline builds a stim circuit, extracts the
detector error model, and converts it to check matrices via the external
``ldpc`` package (studies/studyComplete.py:72-94). stim is not an in-core
dependency of this framework; instead the decoder consumes a pre-exported
DEM bundle — ``(check_matrix H, observables_matrix L, priors)`` — from npz,
which any stim-based exporter can produce. Decoding then runs entirely
on-device: priors -> LLRs (with the reference's 1e-15 clipping,
studyComplete.py:88-89), BP on H, predicted observable flip = L @ e mod 2.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

__all__ = ["DEMData", "priors_to_llrs"]


def priors_to_llrs(priors: np.ndarray) -> np.ndarray:
    """Per-mechanism LLRs log((1-p)/p), priors clipped to [1e-15, 1-1e-15]."""
    q = np.clip(np.asarray(priors, np.float64), 1e-15, 1 - 1e-15)
    return np.log((1 - q) / q).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class DEMData:
    """A detector error model as decoding matrices.

    Attributes:
      H: (num_detectors, num_mechanisms) uint8 detector-mechanism incidence.
      L: (num_observables, num_mechanisms) uint8 observable-mechanism matrix.
      priors: (num_mechanisms,) float — mechanism probabilities.
    """

    H: np.ndarray
    L: np.ndarray
    priors: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "H", (np.asarray(self.H) % 2).astype(np.uint8))
        object.__setattr__(self, "L", (np.asarray(self.L) % 2).astype(np.uint8))
        object.__setattr__(
            self, "priors", np.asarray(self.priors, np.float64).ravel()
        )
        if self.H.shape[1] != self.L.shape[1] or self.H.shape[1] != self.priors.size:
            raise ValueError("H, L, priors disagree on mechanism count")

    @property
    def llrs(self) -> np.ndarray:
        return priors_to_llrs(self.priors)

    def sample(self, key_or_rng, shots: int):
        """Host-side mechanism sampling: each mechanism fires iid with its
        prior. Returns (mechanisms (S, M), detectors (S, D), observables (S, O))
        — the same triple a stim detector sampler provides
        (studyComplete.py:91-94), generated from the DEM itself."""
        rng = (
            key_or_rng
            if isinstance(key_or_rng, np.random.Generator)
            else np.random.default_rng(key_or_rng)
        )
        mech = (rng.random((shots, self.priors.size)) < self.priors).astype(np.uint8)
        det = (mech @ self.H.T) % 2
        obs = (mech @ self.L.T) % 2
        return mech, det, obs

    def save(self, path: str | Path) -> None:
        np.savez(path, H=self.H, L=self.L, priors=self.priors)

    @classmethod
    def load(cls, path: str | Path) -> "DEMData":
        d = np.load(path)
        return cls(H=d["H"], L=d["L"], priors=d["priors"])
