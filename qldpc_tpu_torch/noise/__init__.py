from .channels import (
    code_capacity,
    doubled_channel,
    phenomenological,
    syndrome_of,
    uniform_prior_llr,
)
from .circuit import ParametricDEM, memory_experiment_dem, parametric_memory_dem
from .dem import DEMData, priors_to_llrs

__all__ = [
    "code_capacity",
    "doubled_channel",
    "phenomenological",
    "syndrome_of",
    "uniform_prior_llr",
    "DEMData",
    "ParametricDEM",
    "memory_experiment_dem",
    "parametric_memory_dem",
    "priors_to_llrs",
]
