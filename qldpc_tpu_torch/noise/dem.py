"""Detector error models for the port, from the JAX package's numpy builders.

``qldpc_tpu/noise/dem.py`` and ``qldpc_tpu/noise/circuit.py`` are pure
numpy, so the port imports them rather than forking them. Importing them the
usual way would run ``qldpc_tpu/noise/__init__.py``, which imports the JAX
channels module. So each file is loaded under its own module name
(``qldpc_tpu.noise.dem``, ``qldpc_tpu.noise.circuit``) straight from its
path, and nothing is registered for the ``qldpc_tpu.noise`` package itself:
a later ``from qldpc_tpu.noise import ...`` in the same process runs that
``__init__`` normally and finds these two modules already loaded, so both
packages share one ``DEMData`` class. ``circuit.py``'s own
``from qldpc_tpu.noise.dem import DEMData`` resolves to the loaded module
without touching the package.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import qldpc_tpu

__all__ = [
    "DEMData",
    "ParametricDEM",
    "parametric_memory_dem",
    "memory_experiment_dem",
    "priors_to_llrs",
]

_NOISE_DIR = Path(qldpc_tpu.__file__).resolve().parent / "noise"


def _load(name: str):
    """The module ``qldpc_tpu.noise.<name>``, loaded from its file unless
    some import already loaded it."""
    full = f"qldpc_tpu.noise.{name}"
    if full in sys.modules:
        return sys.modules[full]
    spec = importlib.util.spec_from_file_location(full, _NOISE_DIR / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    # registered before it runs: dataclasses look their module up there
    sys.modules[full] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[full]
        raise
    parent = sys.modules.get("qldpc_tpu.noise")
    if parent is not None:
        setattr(parent, name, module)
    return module


_dem = _load("dem")
_circuit = _load("circuit")

DEMData = _dem.DEMData
priors_to_llrs = _dem.priors_to_llrs
ParametricDEM = _circuit.ParametricDEM
parametric_memory_dem = _circuit.parametric_memory_dem
memory_experiment_dem = _circuit.memory_experiment_dem
