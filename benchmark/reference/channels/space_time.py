"""Space time: T rounds of the code's basis matrix H (m x n) with a
measurement error on every check of every round, decoded at once on

    H_st = [ I_T (x) H | I_{mT} + S_{-m} ]        (m T) x (n T + m T)

whose columns are the T data rounds e_1..e_T, then the T measurement
rounds u_1..u_T, and whose row t m + i is round t's detector i:
(H e_t)_i + u_t,i + u_{t-1},i, with u_0 = 0. The data variables are drawn
at p, the measurement variables at q (the spec's ``syndrome_flip_rate``,
else p); T is the spec's ``n_rounds``, else the code's distance.
Classification reads the net flip of each qubit, the XOR of its T data
rounds: the logicals and the weights see it, the syndrome test and the
mismatch see the whole space-time vector.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import codes


def matrix(H: np.ndarray, rounds: int) -> np.ndarray:
    """H_st of ``rounds`` rounds of H, uint8."""
    H = (np.asarray(H) % 2).astype(np.uint8)
    m = H.shape[0]
    spatial = np.kron(np.eye(rounds, dtype=np.uint8), H)
    temporal = np.eye(m * rounds, dtype=np.uint8) + np.eye(m * rounds, k=-m, dtype=np.uint8)
    return np.hstack([spatial, temporal])


def problem(config: dict, p: float) -> dict:
    code = codes.bb_code(config["code"])
    H = code["Hx"] if config["basis"] == "x" else code["Hz"]
    L = code["Lx"] if config["basis"] == "x" else code["Lz"]
    spec = config["spec"]
    T = int(spec.get("n_rounds") or 0) or max(code["distance"], 1)
    q = spec.get("syndrome_flip_rate")
    m, n = H.shape
    p32 = torch.tensor(p, dtype=torch.float32)
    q32 = torch.tensor(p if q is None else q, dtype=torch.float32)
    prior = torch.cat([p32.expand(T * n), q32.expand(T * m)])
    llr = torch.cat([torch.log((1.0 - p32) / p32).expand(T * n),
                     torch.log((1.0 - q32) / q32).expand(T * m)])

    def fold(bits):
        data = bits[..., : T * n].reshape(*bits.shape[:-1], T, n)
        return data.sum(-2) % 2

    return {"H": matrix(H, T), "L": L, "prior": prior, "band": 0.0,
            "distance": code["distance"], "llr": llr, "fold": fold}
