from . import plotting, profiling, rng

__all__ = ["plotting", "profiling", "rng"]
