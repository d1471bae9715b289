"""Circuit level: the memory experiment's detector error model at p
(``reference/circuit.py``), checked against the configuration's stated
size. A draw within 2^-22 of its prior may fall either way, as float32
priors round."""

from __future__ import annotations

from benchmark.reference import circuit, codes
from benchmark.reference.channels import identity

PRIOR_BAND = 2.0 ** -22


def problem(config: dict, p: float) -> dict:
    code = codes.bb_code(config["code"])
    dem = circuit.parametric_dem(code, config["basis"], int(config["rounds"]))
    H, L = dem["H"], dem["L"]
    if H.shape != (config["detectors"], config["mechanisms"]):
        raise ValueError(f"the DEM is {H.shape[0]} x {H.shape[1]}; the configuration "
                         f"states {config['detectors']} x {config['mechanisms']}")
    q, llr = circuit.priors(dem, p)
    return {"H": H, "L": L, "prior": q, "band": PRIOR_BAND, "distance": 0, "llr": llr,
            "fold": identity}
