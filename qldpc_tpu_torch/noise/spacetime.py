"""Space-time (multi-round) decoding: the matrix, the sampler, the priors.

Port of qldpc_tpu/noise/spacetime.py. The decoding matrix is the
phenomenological space-time model

    H_st = [ I_T (x) H  |  I_{mT} + S_{-m} ]        shape (m*T, n*T + m*T)

over the variables (e_1..e_T data errors, u_1..u_T measurement errors),
and the detector syndrome is the round-to-round difference
``d_t = H e_t + u_t + u_{t-1}`` (u_0 = 0). Syndromes are computed per round
with the base matrix; the dense H_st is built on the host only for OSD and
the classification's syndrome check.

Left out (ROADMAP.md): ``sample_space_time``, the keyed
``jax.random.bernoulli`` sampler, which the engine does not use.
"""

from __future__ import annotations

import numpy as np
import torch

from qldpc_tpu_torch.utils.rng import counter_uniform

__all__ = [
    "space_time_matrix",
    "sample_space_time_counters",
    "fold_data_correction",
    "space_time_prior_llr",
]


def space_time_matrix(H: np.ndarray, n_rounds: int) -> np.ndarray:
    """Dense (m*T, n*T + m*T) space-time check matrix (host-side, uint8)."""
    H = (np.asarray(H) % 2).astype(np.uint8)
    m, n = H.shape
    T = n_rounds
    spatial = np.kron(np.eye(T, dtype=np.uint8), H)
    temporal = np.eye(m * T, dtype=np.uint8)
    idx = np.arange(m * (T - 1))
    temporal[m + idx, idx] ^= 1  # u_{t-1} feeds detector row t
    return np.hstack([spatial, temporal])


def sample_space_time_counters(key, base: int, H, p, batch: int, n_rounds: int,
                               q=None, device=None):
    """Counter-mode space-time sampling: sample i's first ``T*n`` uniforms
    are its data errors and the next ``T*m`` its measurement errors, as in
    the JAX engine (the comparisons are ``u < float32(p)``).

    ``H`` is the base (m, n) matrix, numpy or a float32 tensor on ``device``.
    Returns ``(errors (B, T*n + T*m) int8, detectors (B, T*m) int8)``.
    """
    Hf = torch.as_tensor(np.asarray(H) % 2 if isinstance(H, np.ndarray) else H,
                         dtype=torch.float32, device=device)
    m, n = Hf.shape
    T = n_rounds
    q = p if q is None else q
    u_all = counter_uniform(key, base, batch, T * n + T * m, device=device)
    p32 = torch.as_tensor(p, dtype=torch.float32, device=u_all.device)
    q32 = torch.as_tensor(q, dtype=torch.float32, device=u_all.device)
    e = (u_all[:, : T * n].reshape(batch, T, n) < p32).to(torch.int8)
    u = (u_all[:, T * n:].reshape(batch, T, m) < q32).to(torch.int8)
    s = torch.remainder(e.to(torch.float32) @ Hf.T, 2.0).to(torch.int8)  # (B, T, m)
    u_prev = torch.cat([torch.zeros_like(u[:, :1]), u[:, :-1]], dim=1)
    d = (s + u + u_prev) % 2
    errors = torch.cat([e.reshape(batch, T * n), u.reshape(batch, T * m)], dim=1)
    return errors, d.reshape(batch, T * m)


def fold_data_correction(v: torch.Tensor, n: int, n_rounds: int) -> torch.Tensor:
    """``(B, n*T + m*T) -> (B, n)``: the XOR of the T per-round data blocks,
    the net flip of each data qubit, as int32."""
    data = v[..., : n * n_rounds].reshape(*v.shape[:-1], n_rounds, n)
    return data.to(torch.int32).sum(dim=-2) % 2


def space_time_prior_llr(n: int, m: int, n_rounds: int, p, q=None,
                         device=None) -> torch.Tensor:
    """Per-variable prior LLRs in float32: ``log((1-p)/p)`` on the T*n data
    variables, likewise q on the T*m measurement variables. The scalars are
    computed on the CPU and then moved, so every device decodes with the
    same prior bits."""
    q = p if q is None else q
    p = torch.as_tensor(p, dtype=torch.float32)
    q = torch.as_tensor(q, dtype=torch.float32)
    lp = torch.log((1 - p) / p)
    lq = torch.log((1 - q) / q)
    return torch.cat([lp.expand(n * n_rounds), lq.expand(m * n_rounds)]).to(device)
