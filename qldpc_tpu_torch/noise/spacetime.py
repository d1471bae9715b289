"""Space-time (multi-round) decoding: the matrix, the sampler, the priors.

Port of qldpc_tpu/noise/spacetime.py. The decoding matrix is the
phenomenological space-time model

    H_st = [ I_T (x) H  |  I_{mT} + S_{-m} ]        shape (m*T, n*T + m*T)

over the variables (e_1..e_T data errors, u_1..u_T measurement errors),
and the detector syndrome is the round-to-round difference
``d_t = H e_t + u_t + u_{t-1}`` (u_0 = 0). Syndromes are computed per round
with the base matrix; the dense H_st is built on the host only for OSD and
the classification's syndrome check.

Two samplers draw the same model: ``sample_space_time`` from keyed
``jax.random.bernoulli`` draws (one key, or one key per sample), and
``sample_space_time_counters`` from the counter-mode stream the engine uses.
"""

from __future__ import annotations

import numpy as np
import torch

from qldpc_tpu_torch.utils.profiling import count, span
from qldpc_tpu_torch.utils.rng import bernoulli, counter_uniform, split

__all__ = [
    "space_time_matrix",
    "sample_space_time",
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


def _base_matrix(H, device) -> torch.Tensor:
    """The base (m, n) matrix as float32 on ``device`` (numpy or a tensor)."""
    return torch.as_tensor(H % 2 if isinstance(H, np.ndarray) else H,
                           dtype=torch.float32, device=device)


def _detectors(e, u, Hf, batch: int, T: int):
    """d_t = H e_t + u_t + u_{t-1} (u_0 = 0) from (B, T, n) data and (B, T, m)
    measurement errors; returns (errors, detectors) flattened."""
    s = torch.remainder(e.to(torch.float32) @ Hf.T, 2.0).to(torch.int8)  # (B, T, m)
    u_prev = torch.cat([torch.zeros_like(u[:, :1]), u[:, :-1]], dim=1)
    d = (s + u + u_prev) % 2
    errors = torch.cat([e.reshape(batch, -1), u.reshape(batch, -1)], dim=1)
    return errors, d.reshape(batch, -1)


def sample_space_time(key, H, p, batch: int, n_rounds: int, q=None,
                      dtype=torch.float32, device=None):
    """Keyed space-time sampling, as ``jax.random`` draws it
    (qldpc_tpu/noise/spacetime.py:52). ``key`` is one key (2,), split into
    the data and the measurement key, or a (batch, 2) tensor of per-sample
    keys, each split likewise. ``dtype`` is the dtype of the comparisons
    ``u < p`` (JAX's for a Python float: float32, float64 under x64).

    Returns ``(errors (B, T*n + T*m) int8, detectors (B, T*m) int8)``.
    """
    Hf = _base_matrix(H, device)
    m, n = Hf.shape
    T = n_rounds
    q = p if q is None else q
    key = torch.as_tensor(key, dtype=torch.int64)
    if key.dim() == 2:  # per-sample keys
        kk = split(key)  # (batch, 2, 2)
        e = bernoulli(kk[:, 0], p, (T, n), dtype, device)
        u = bernoulli(kk[:, 1], q, (T, m), dtype, device)
    else:
        ke, ku = split(key)
        e = bernoulli(ke, p, (batch, T, n), dtype, device)
        u = bernoulli(ku, q, (batch, T, m), dtype, device)
    return _detectors(e, u, Hf, batch, T)


def sample_space_time_counters(key, base: int, H, p, batch: int, n_rounds: int,
                               q=None, device=None):
    """Counter-mode space-time sampling: sample i's first ``T*n`` uniforms
    are its data errors and the next ``T*m`` its measurement errors, as in
    the JAX engine (the comparisons are ``u < float32(p)``).

    ``H`` is the base (m, n) matrix, numpy or a float32 tensor on ``device``.
    Returns ``(errors (B, T*n + T*m) int8, detectors (B, T*m) int8)``.
    """
    Hf = _base_matrix(H, device)
    m, n = Hf.shape
    T = n_rounds
    q = p if q is None else q
    u_all = counter_uniform(key, base, batch, T * n + T * m, device=device)
    p32 = torch.as_tensor(p, dtype=torch.float32, device=u_all.device)
    q32 = torch.as_tensor(q, dtype=torch.float32, device=u_all.device)
    count("host_syncs", 2)  # p's and q's copies to the device
    e = (u_all[:, : T * n].reshape(batch, T, n) < p32).to(torch.int8)
    u = (u_all[:, T * n:].reshape(batch, T, m) < q32).to(torch.int8)
    with span("sample.detectors"):
        return _detectors(e, u, Hf, batch, T)


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
    count("host_syncs")  # the priors' copy to the device
    return torch.cat([lp.expand(n * n_rounds), lq.expand(m * n_rounds)]).to(device)
