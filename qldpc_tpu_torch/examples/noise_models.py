"""Noise-model walkthrough (parity with the reference's noise_models.ipynb).

    python -m qldpc_tpu_torch.examples.noise_models [--device cpu]

Port of examples/noise_models.py: samples each channel the port supports,
shows the induced syndrome statistics, and decodes a batch under each, all
on the device. The keys are ``rng.split``'s, which equal ``jax.random.split``'s,
so the draws are the JAX example's.
"""

import argparse

import numpy as np
import torch

from qldpc_tpu_torch.codes import get_code
from qldpc_tpu_torch.decoders import BPConfig, BPDecoder
from qldpc_tpu_torch.mc.engine import engine_device
from qldpc_tpu_torch.noise import (
    DEMData,
    code_capacity,
    doubled_channel,
    phenomenological,
    syndrome_of,
    uniform_prior_llr,
)
from qldpc_tpu_torch.noise.spacetime import (
    sample_space_time,
    space_time_matrix,
    space_time_prior_llr,
)
from qldpc_tpu_torch.utils import rng


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m qldpc_tpu_torch.examples.noise_models")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    dev = engine_device(ap.parse_args(argv).device)

    code = get_code("[[72, 12, 6]]")
    H = code.Hx
    Hf = torch.tensor(H % 2, dtype=torch.float32, device=dev)
    p, B = 0.02, 1024
    key = rng.key(0)
    dec = BPDecoder(H, BPConfig(max_iter=50)).to(dev)
    prior = uniform_prior_llr(code.n, p, device=dev)
    rate = lambda mask: float(mask.float().mean())

    print(f"code {code.name}, p={p}, batch={B}\n")

    k1, k2, k3, k4 = rng.split(key, 4)

    e = code_capacity(k1, 0, p, B, code.n, device=dev)
    s = syndrome_of(Hf, e)
    res = dec(s, prior)
    print(f"code capacity:       mean wt={rate(e.sum(1)):.2f} "
          f"syndrome wt={rate(s.sum(1)):.2f} "
          f"BP converged={rate(res.converged):.3f}")

    e = doubled_channel(k2, 0, p, B, code.n, device=dev)
    s = syndrome_of(Hf, e)
    res = dec(s, prior)
    print(f"doubled (e1^e2):     mean wt={rate(e.sum(1)):.2f} "
          f"BP converged={rate(res.converged):.3f}")

    e, flips = phenomenological(k3, 0, p, B, code.n, H.shape[0], device=dev)
    s = (syndrome_of(Hf, e) + flips) % 2
    res = dec(s, prior)
    print(f"phenomenological:    syndrome flips={rate(flips.sum(1)):.2f} "
          f"BP converged={rate(res.converged):.3f}  (noisy syndromes "
          "often have no exact solution -> OSD territory)")

    T = 4
    Hst = space_time_matrix(H, T)
    est, det = sample_space_time(k4, H, p / 4, B, T, device=dev)
    dec_st = BPDecoder(Hst, BPConfig(max_iter=50)).to(dev)
    res = dec_st(det, space_time_prior_llr(code.n, H.shape[0], T, p / 4, device=dev))
    print(f"space-time (T={T}):    vars={Hst.shape[1]} checks={Hst.shape[0]} "
          f"BP converged={rate(res.converged):.3f}")

    dem = DEMData(H=code.Hx, L=code.Lx, priors=np.full(code.n, p))
    _, det, obs = dem.sample(0, shots=B)
    res = dec(torch.from_numpy(det.astype(np.int8)).to(dev),
              torch.from_numpy(dem.llrs.astype(np.float32)).to(dev))
    print(f"DEM (circuit-level): mechanisms={dem.priors.size} "
          f"BP converged={rate(res.converged):.3f}")


if __name__ == "__main__":
    main()
