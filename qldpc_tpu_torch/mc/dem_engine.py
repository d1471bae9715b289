"""Circuit-level decoding engine over a detector error model, on one device
or a process mesh.

Port of qldpc_tpu/mc/dem_engine.py onto the port's ``MonteCarloEngine``:
every mechanism of the DEM fires as an independent Bernoulli of its prior,
drawn as ``u < prior`` from the counter-mode RNG with the JAX engine's keys
and sample ids; the detector syndrome is a gather-parity over each
detector's mechanisms; BP (+ OSD-0 on its failures) decodes it; a logical
error is a predicted observable flip ``L @ e_hat`` that differs from the
actual ``L @ e``. The weight-versus-distance split has no meaning in
mechanism space, so the distance is 0 and every logical error counts as
``incorrectable``, as in the JAX engine.

For a ``ParametricDEM`` the priors are its closed form at the physical rate
p, ``q = (1 - exp(counts @ log1p(-2 r p))) / 2`` clipped to [1e-15,
1 - 1e-15] and ``llr = log((1 - q) / q)``, in float32 like the JAX engine.
They are computed on the CPU and then moved, so every device decodes with
the same prior bits. A plain ``DEMData`` carries its own priors.

On a ``parallel.Mesh`` each process draws its slice of every batch from the
global stream and sizes its OSD capacity from it, as ``MonteCarloEngine``
does (qldpc_tpu/mc/dem_engine.py:62-74, :117-124).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from qldpc_tpu_torch.ops.tanner import parity_tables
from qldpc_tpu_torch.decoders.osd import OSDDecoder
from qldpc_tpu_torch.mc.engine import EngineConfig, MonteCarloEngine, engine_device
from qldpc_tpu_torch.mc.metrics import counters_to_dict
from qldpc_tpu_torch.noise.circuit import ParametricDEM
from qldpc_tpu_torch.noise.dem import DEMData
from qldpc_tpu_torch.parallel.mesh import Mesh
from qldpc_tpu_torch.utils import rng

__all__ = ["DEMEngine", "DEMEngineConfig"]


@dataclasses.dataclass(frozen=True)
class DEMEngineConfig(EngineConfig):
    channel: str = "dem"

    _channels: ClassVar[tuple[str, ...]] = ("dem",)


@dataclasses.dataclass(frozen=True)
class _DEMCodeShim:
    """The ``code`` of a DEM engine: a name for sweep results."""

    name: str


class DEMEngine(MonteCarloEngine):
    """Batched logical-error estimation for one detector error model on one
    device: the card by default, the CPU when asked for, and ``mesh`` as in
    ``MonteCarloEngine``. ``dem`` is the port's ``DEMData`` or
    ``ParametricDEM``; carry a JAX-built one across with
    ``convert.dem_from_reference``."""

    def __init__(self, dem: DEMData | ParametricDEM,
                 config: DEMEngineConfig = DEMEngineConfig(),
                 device="cuda", name: str = "dem", mesh: Mesh | None = None):
        dev = engine_device(device)
        if not isinstance(dem, (DEMData, ParametricDEM)):
            raise TypeError(
                f"expected the port's DEMData or ParametricDEM, got {type(dem)!r}; "
                "convert a JAX-built DEM with qldpc_tpu_torch.convert.dem_from_reference"
            )
        if not isinstance(config, DEMEngineConfig):
            fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}
            config = DEMEngineConfig(**{**fields, "channel": "dem"})
        self.dem = dem
        self.code = _DEMCodeShim(name=name)
        self.config = config
        self.device = dev
        self._shard(config, mesh)
        self.m_checks, self.n_vars = dem.H.shape
        self.distance = 0  # every logical error is "incorrectable"
        self.n_rounds = 0  # the DEM's rounds are in its H: no data folding
        self.bp, self.bp_short = self._bp_decoders(dem.H)
        self.osd = OSDDecoder(dem.H, config.osd).to(dev) if config.osd is not None else None
        if self.osd is not None and self.osd.elimination != "rows":
            # the OSD decoder's residual uses the same gather-parity tables
            self._vos_parity, self._dc_parity = self.osd.vos_parity, self.osd.dc_parity
        else:
            vos, self._dc_parity = parity_tables(dem.H)
            self._vos_parity = torch.from_numpy(vos.astype(np.int64)).to(dev)
        self._Lf = torch.tensor(np.asarray(dem.L) % 2, dtype=torch.float32, device=dev)
        # one uniform per mechanism: the largest stride of any engine
        self._check_counter_space(self.n_vars)
        self._parametric = isinstance(dem, ParametricDEM)
        if self._parametric:
            self._ratios = torch.tensor(dem.ratios, dtype=torch.float32)
            self._counts = torch.tensor(dem.counts, dtype=torch.float32)
        else:
            self._fixed = (
                torch.tensor(dem.priors, dtype=torch.float32).to(dev),
                torch.tensor(dem.llrs, dtype=torch.float32).to(dev),
            )

    def _syndrome(self, errors):
        """Gather-parity detector syndrome, (B, n) -> (B, m) int8."""
        ep = torch.nn.functional.pad(errors.to(torch.int32), (0, 1))
        es = ep[:, self._vos_parity].view(errors.shape[0], self.m_checks, self._dc_parity)
        return (es.sum(dim=-1, dtype=torch.int32) % 2).to(torch.int8)

    def priors(self, p: float):
        """Mechanism priors and their LLRs, (n,) float32 each, on the device."""
        if not self._parametric:
            return self._fixed
        p32 = torch.tensor(p, dtype=torch.float32)
        acc = self._counts @ torch.log1p(-2.0 * self._ratios * p32)
        q = 0.5 * (1.0 - torch.exp(acc))
        qc = torch.clamp(q, 1e-15, 1.0 - 1e-15)
        llr = torch.log((1.0 - qc) / qc)
        return q.to(self.device), llr.to(self.device)

    def _sample(self, key, p: float):
        """Per-mechanism Bernoulli firings; returns (errors, syndromes,
        priors). ``p`` is ignored for a plain DEMData."""
        prob, llr = self.priors(p)
        u = rng.counter_uniform(key, self.base, self.local_batch, self.n_vars,
                                device=self.device)
        errors = (u < prob[None, :]).to(torch.int8)
        return errors, self._syndrome(errors), llr

    def run(self, shots: int, seed: int = 0, p: float = 0.0, checkpoint=None) -> dict:
        """Estimate the logical error rate over ``shots`` sampled shots.
        ``p`` is the physical rate of a ParametricDEM (ignored otherwise);
        with a ``CheckpointManager`` the run resumes from its last saved
        batch."""
        if self._parametric and p <= 0.0:
            raise ValueError("a ParametricDEM needs a physical rate: run(..., p=...)")
        if checkpoint is not None:
            counters = checkpoint.run_rate(self, p, shots, seed)
        else:
            counters = self.run_rate(p, shots, seed=seed)
        return counters_to_dict(counters)
