from .checkpoint import CheckpointManager
from .dem_engine import DEMEngine, DEMEngineConfig
from .engine import EngineConfig, MonteCarloEngine, SweepResult
from .metrics import HIST_BINS, Counters, counters_to_dict, zeros_counters

__all__ = [
    "CheckpointManager",
    "EngineConfig",
    "MonteCarloEngine",
    "SweepResult",
    "DEMEngine",
    "DEMEngineConfig",
    "Counters",
    "HIST_BINS",
    "counters_to_dict",
    "zeros_counters",
]
