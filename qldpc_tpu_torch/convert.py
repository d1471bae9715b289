"""Carry configurations and RNG state across from the JAX package.

Each function takes a config dataclass instance of ``qldpc_tpu`` or a dict
of its fields, read by name so that ``jax`` is never imported, and returns
the port's config. Selectors that only choose a TPU code path are dropped:
on the port the tensor's device decides the path. Fields that would change
the numerics, or that need a feature outside this slice, raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qldpc_tpu_torch.decoders.bp import BPConfig
from qldpc_tpu_torch.decoders.osd import OSDConfig
from qldpc_tpu_torch.mc.engine import EngineConfig

__all__ = [
    "bp_config_from_reference",
    "osd_config_from_reference",
    "engine_config_from_reference",
    "key_from_reference",
]

# chunk_size only spaces the XLA path's whole-batch exit checks: the
# results do not depend on it
_BP_DROPPED = {"backend", "batch_tile", "n_layers", "chunk_size"}
_OSD_DROPPED = {"backend", "batch_tile", "chunk", "max_elim_cols"}
_OSD_ORDER_E_ONLY = {"max_combinations", "extra_positions", "dtype"}
_ENGINE_DROPPED = {"osd_tiers", "osd_chunk", "fused_dispatch", "rescue_tiers",
                   "n_rounds"}


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
    for name in ("mm_dtype", "stream_dtype"):
        if f.pop(name, "float32") != "float32":
            raise ValueError(
                f"{name} other than float32 changes the BP numerics; the port "
                "runs float32 messages"
            )
    for name in _BP_DROPPED:
        f.pop(name, None)
    return BPConfig(**_take(f, BPConfig))


def osd_config_from_reference(cfg) -> OSDConfig:
    f = _fields(cfg)
    # the OSD-e fields shape only the pattern search; OSDConfig itself
    # raises for order > 0
    for name in _OSD_DROPPED | _OSD_ORDER_E_ONLY:
        f.pop(name, None)
    return OSDConfig(**_take(f, OSDConfig))


def engine_config_from_reference(cfg) -> EngineConfig:
    f = _fields(cfg)
    if f.pop("rescue_iters", 0):
        raise NotImplementedError(
            "rescue_iters is not ported yet (ROADMAP.md, queue 1 item 7)"
        )
    for name in _ENGINE_DROPPED:
        f.pop(name, None)
    if "bp" in f:
        f["bp"] = bp_config_from_reference(f["bp"])
    if f.get("osd") is not None:
        f["osd"] = osd_config_from_reference(f["osd"])
    return EngineConfig(**_take(f, EngineConfig))


def key_from_reference(key_data) -> torch.Tensor:
    """A port RNG key from ``jax.random.key_data(key)`` (two uint32 words)."""
    kd = np.asarray(key_data)
    if kd.shape != (2,):
        raise ValueError(f"expected key data of shape (2,), got {kd.shape}")
    return torch.tensor([int(v) & 0xFFFFFFFF for v in kd], dtype=torch.int64)
