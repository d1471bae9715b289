from .engine import EngineConfig, MonteCarloEngine, SweepResult
from .metrics import HIST_BINS, Counters, counters_to_dict, zeros_counters

__all__ = [
    "EngineConfig",
    "MonteCarloEngine",
    "SweepResult",
    "Counters",
    "HIST_BINS",
    "counters_to_dict",
    "zeros_counters",
]
