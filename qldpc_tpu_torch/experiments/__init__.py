from .configs import PRESETS, ExperimentSpec, get_preset
from .runners import build_engine, run_experiment

__all__ = ["PRESETS", "ExperimentSpec", "get_preset", "run_experiment", "build_engine"]
