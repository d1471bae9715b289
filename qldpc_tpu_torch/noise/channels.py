"""Noise channels and syndrome generation, in torch.

Port of qldpc_tpu/noise/channels.py. Every channel draws from the global
counter-mode RNG (utils/rng.py), so sample i's draws are a pure function of
its global id and the port samples exactly the errors the JAX engine samples.
``base`` is the first global sample id of the batch.
"""

from __future__ import annotations

import torch

from qldpc_tpu_torch.utils.profiling import count
from qldpc_tpu_torch.utils.rng import counter_bernoulli, counter_uniform

__all__ = [
    "uniform_prior_llr",
    "syndrome_of",
    "code_capacity",
    "doubled_channel",
    "phenomenological",
]


def uniform_prior_llr(n: int, p, device=None) -> torch.Tensor:
    """Uniform channel prior ``log((1-p)/p)`` per variable, in float32.

    The scalar is computed on the CPU and then moved, so every device decodes
    with the same prior bits."""
    p = torch.as_tensor(p, dtype=torch.float32)
    count("host_syncs")  # the prior's copy to the device
    return torch.log((1.0 - p) / p).to(device).expand(n)


def syndrome_of(Hf: torch.Tensor, errors: torch.Tensor) -> torch.Tensor:
    """Batched ``e @ H^T mod 2`` as a float matmul; (B, n) -> (B, m) int8.
    ``Hf`` is the (m, n) parity-check matrix as float32 (exact: the sums are
    small integers)."""
    s = errors.to(torch.float32) @ Hf.T
    return torch.remainder(s, 2.0).to(torch.int8)


def code_capacity(key, base: int, p, batch: int, n: int, device=None):
    """iid Bernoulli(p) bit flips on each of n qubits."""
    return counter_bernoulli(key, p, base, (batch, n), device=device)


def doubled_channel(key, base: int, p, batch: int, n: int, device=None):
    """``e = e1 XOR e2`` with e_i ~ Bernoulli(p), sampled as one
    Bernoulli(2p(1-p)) draw computed in float32 like the JAX channel."""
    p = torch.as_tensor(p, dtype=torch.float32)
    return counter_bernoulli(key, 2.0 * p * (1.0 - p), base, (batch, n), device=device)


def phenomenological(key, base: int, p, batch: int, n: int, m: int, q=None,
                     device=None):
    """Code-capacity data errors plus Bernoulli(q) syndrome-bit flips (q
    defaults to p), both from one counter stream of stride n + m.

    Returns ``(errors (B, n), syndrome_flips (B, m))``, both int8.
    """
    q = p if q is None else q
    u = counter_uniform(key, base, batch, n + m, device=device)
    p32 = torch.as_tensor(p, dtype=torch.float32, device=u.device)
    q32 = torch.as_tensor(q, dtype=torch.float32, device=u.device)
    count("host_syncs", 2)  # p's and q's copies to the device
    errors = (u[:, :n] < p32).to(torch.int8)
    flips = (u[:, n:] < q32).to(torch.int8)
    return errors, flips
