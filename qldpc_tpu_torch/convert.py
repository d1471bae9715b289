"""Carry configurations, codes, DEMs and RNG state across from the JAX package.

Each function takes an object of ``qldpc_tpu`` (a config dataclass, an
``ExperimentSpec``, a ``CSSCode``, a ``DEMData`` or ``ParametricDEM``) or a
dict of its fields,
reads the fields by name as numpy arrays or plain values, so that neither
``jax`` nor ``qldpc_tpu`` is ever imported, and returns the port's object.
Config selectors that only choose a TPU code path are dropped: on the port
the tensor's device decides the path. Fields that change the numerics carry
over, the bf16 message modes (``stream_dtype``, ``mm_dtype``) among them;
where the JAX package refuses a combination, so does the port.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from qldpc_tpu_torch.codes import CSSCode
from qldpc_tpu_torch.decoders.bp import BPConfig
from qldpc_tpu_torch.decoders.osd import OSDConfig
from qldpc_tpu_torch.mc.dem_engine import DEMEngineConfig
from qldpc_tpu_torch.mc.engine import EngineConfig
from qldpc_tpu_torch.noise.circuit import ParametricDEM
from qldpc_tpu_torch.noise.dem import DEMData

__all__ = [
    "bp_config_from_reference",
    "osd_config_from_reference",
    "engine_config_from_reference",
    "dem_engine_config_from_reference",
    "spec_from_reference",
    "key_from_reference",
    "code_from_reference",
    "dem_from_reference",
]

# chunk_size only spaces the XLA path's whole-batch exit checks, and the
# others only pick a TPU code path or tile or a dispatch ladder: the results
# do not depend on them. schedule, n_layers and n_rounds do, and carry over.
_BP_DROPPED = {"backend", "batch_tile", "chunk_size"}
# the OSD decoder's dtype is its LLRs' in either package
_OSD_DROPPED = {"batch_tile", "dtype"}
_ENGINE_DROPPED = {"osd_tiers", "osd_chunk", "fused_dispatch", "rescue_tiers"}


def _fields(cfg) -> dict:
    if isinstance(cfg, dict):
        return dict(cfg)
    if dataclasses.is_dataclass(cfg):
        return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    raise TypeError(f"expected a config dataclass or dict, got {type(cfg)!r}")


def _take(fields: dict, target) -> dict:
    known = {f.name for f in dataclasses.fields(target)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"{target.__name__} has no fields {sorted(unknown)}")
    return fields


def bp_config_from_reference(cfg) -> BPConfig:
    f = _fields(cfg)
    # the bf16 modes belong to the JAX package's Pallas kernels: with another
    # backend named, its BPConfig refuses them (qldpc_tpu/decoders/bp.py:94-110)
    for name in ("stream_dtype", "mm_dtype"):
        if f.get(name, "float32") != "float32" and f.get("backend", "pallas") != "pallas":
            raise ValueError(f"{name} applies only to the pallas backend's kernels")
    for name in _BP_DROPPED:
        f.pop(name, None)
    return BPConfig(**_take(f, BPConfig))


def osd_config_from_reference(cfg) -> OSDConfig:
    f = _fields(cfg)
    for name in _OSD_DROPPED:
        f.pop(name, None)
    # the JAX backends other than the factored elimination ("lanes",
    # "pallas", "vmap") pick the same arithmetic by platform: the port picks
    # its elimination from the shape of H
    if "backend" in f:
        f["backend"] = "factored" if f["backend"] == "factored" else "auto"
    return OSDConfig(**_take(f, OSDConfig))


def _engine_fields(cfg) -> dict:
    f = _fields(cfg)
    for name in _ENGINE_DROPPED:
        f.pop(name, None)
    if "bp" in f:
        f["bp"] = bp_config_from_reference(f["bp"])
    if f.get("osd") is not None:
        f["osd"] = osd_config_from_reference(f["osd"])
    return f


def engine_config_from_reference(cfg) -> EngineConfig:
    return EngineConfig(**_take(_engine_fields(cfg), EngineConfig))


def dem_engine_config_from_reference(cfg) -> DEMEngineConfig:
    """The port's ``DEMEngineConfig`` from the JAX package's, its BP
    config's bf16 streams included."""
    return DEMEngineConfig(**_take(_engine_fields(cfg), DEMEngineConfig))


def spec_from_reference(spec) -> ExperimentSpec:
    """The port's ``ExperimentSpec`` from the JAX package's (or a dict of its
    fields, such as a spec JSON the JAX CLI wrote): the same fields, so
    ``run_experiment`` maps its TPU selectors as it maps any spec's."""
    from qldpc_tpu_torch.experiments.configs import ExperimentSpec  # its runner imports this module

    f = {k: copy.deepcopy(v) for k, v in _fields(spec).items()}
    return ExperimentSpec(**_take(f, ExperimentSpec))


def key_from_reference(key_data) -> torch.Tensor:
    """A port RNG key from ``jax.random.key_data(key)`` (two uint32 words)."""
    kd = np.asarray(key_data)
    if kd.shape != (2,):
        raise ValueError(f"expected key data of shape (2,), got {kd.shape}")
    return torch.tensor([int(v) & 0xFFFFFFFF for v in kd], dtype=torch.int64)


def code_from_reference(code) -> CSSCode:
    """The port's ``CSSCode`` from a ``qldpc_tpu.codes.CSSCode`` (or a dict
    of its fields)."""
    f = _fields(code)
    return CSSCode(
        name=f["name"], Hx=np.asarray(f["Hx"]), Hz=np.asarray(f["Hz"]),
        Lx=np.asarray(f["Lx"]), Lz=np.asarray(f["Lz"]), distance=int(f["distance"]),
    )


def dem_from_reference(dem) -> DEMData | ParametricDEM:
    """The port's ``ParametricDEM`` (fields ``H, L, ratios, counts``) or
    ``DEMData`` (fields ``H, L, priors``) from the JAX package's."""
    f = _fields(dem)
    H, L = np.asarray(f["H"]), np.asarray(f["L"])
    if "ratios" in f:
        return ParametricDEM(H=H, L=L, ratios=np.asarray(f["ratios"]),
                             counts=np.asarray(f["counts"]))
    return DEMData(H=H, L=L, priors=np.asarray(f["priors"]))
