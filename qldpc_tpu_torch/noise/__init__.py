from .channels import (
    code_capacity,
    doubled_channel,
    phenomenological,
    syndrome_of,
    uniform_prior_llr,
)

__all__ = [
    "code_capacity",
    "doubled_channel",
    "phenomenological",
    "syndrome_of",
    "uniform_prior_llr",
]
