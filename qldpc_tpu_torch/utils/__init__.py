from . import rng

__all__ = ["rng"]
