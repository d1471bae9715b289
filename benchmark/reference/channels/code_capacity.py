"""Code capacity: independent flips at p on the code's qubits, decoded on
the basis matrix with the prior log((1 - p) / p)."""

from __future__ import annotations

import torch

from benchmark.reference import codes
from benchmark.reference.channels import identity


def problem(config: dict, p: float) -> dict:
    code = codes.bb_code(config["code"])
    H = code["Hx"] if config["basis"] == "x" else code["Hz"]
    L = code["Lx"] if config["basis"] == "x" else code["Lz"]
    p32 = torch.tensor(p, dtype=torch.float32)
    llr = torch.log((1.0 - p32) / p32).expand(H.shape[1])
    return {"H": H, "L": L, "prior": p32, "band": 0.0, "distance": code["distance"],
            "llr": llr, "fold": identity}
