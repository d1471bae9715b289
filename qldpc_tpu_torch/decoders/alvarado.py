"""Alvarado-style consistency-corrected min-sum normalization (alpha).

Port of qldpc_tpu/decoders/alvarado.py: sample code-capacity errors with the
keyed ``jax.random`` draws of ``utils.rng`` (bit for bit with the JAX
package's), take the *unnormalized* check messages R of the first BP
iteration (``BPDecoder.check_messages``), split them by the true value of
each edge's variable, histogram both populations and fit
log(f0(x)/f1(x)) = alpha * x through the origin. The sampling and the
messages run on the device; the histogram fit, a copy of the JAX package's
numpy code, on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from qldpc_tpu_torch.decoders.bp import BPConfig, BPDecoder
from qldpc_tpu_torch.utils import rng

__all__ = ["estimate_alpha"]


def estimate_alpha(
    H: np.ndarray,
    error_rate: float,
    trials: int = 5000,
    bins: int = 50,
    seed: int = 0,
    at_iter: int = 0,
    method: str = "min-sum",
    batch_size: int = 1024,
    device="cuda",
    draw_dtype=torch.float32,
) -> float:
    """Estimate the min-sum normalization alpha for a code at one error rate.

    Args:
      H: parity-check matrix used for decoding.
      error_rate: physical error rate of the code-capacity channel.
      trials: number of Monte-Carlo samples (whole batches of ``batch_size``).
      bins: histogram bins for the message populations.
      at_iter: which iteration's messages to use (0 == first pass).
      method: "min-sum" (reference default) or "sum-product".
      device: where the sampling and the messages run (the card by default).
      draw_dtype: the dtype of the uniform draws: float32, as JAX draws them
        by default, or float64, as it draws them with x64 enabled.

    Batch b draws ``bernoulli(fold_in(key(seed), b), error_rate,
    (batch_size, n))``, as the JAX function does, so at equal seeds and
    draw dtypes the errors are the JAX function's.
    """
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("estimate_alpha runs on the card by default, but torch finds "
                           "no CUDA device; pass device='cpu' to run it on the CPU")
    H = (np.asarray(H) % 2).astype(np.uint8)
    n = H.shape[1]
    dec = BPDecoder(H, BPConfig(max_iter=1, method=method, alpha=1.0)).to(device)
    # the JAX prior: log((1 - p) / p) in float64, then rounded to float32
    prior = torch.full((n,), float(np.log((1 - error_rate) / error_rate)),
                       dtype=torch.float32, device=device)
    Hf = torch.from_numpy(H.astype(np.float32)).to(device)
    var_of_edge = torch.from_numpy(dec.graph.var_of_edge).to(device).long()
    key = rng.key(seed)
    msgs, bits = [], []
    for b in range(-(-trials // batch_size)):
        errors = rng.bernoulli(rng.fold_in(key, b), error_rate, (batch_size, n),
                               dtype=draw_dtype, device=device)
        syn = torch.remainder(errors.to(torch.float32) @ Hf.T, 2.0).to(torch.int8)
        R = dec._raw_check_messages(syn, prior, at_iter=at_iter)
        msgs.append(R.cpu().numpy().ravel())
        bits.append(errors[:, var_of_edge].cpu().numpy().ravel())
    msgs = np.concatenate(msgs)
    bits = np.concatenate(bits)

    # Copied from qldpc_tpu/decoders/alvarado.py::estimate_alpha (the fit).
    true0 = msgs[bits == 0]
    true1 = msgs[bits == 1]
    if true1.size == 0 or true0.size == 0:
        return 1.0
    lo = min(true0.min(), true1.min())
    hi = max(true0.max(), true1.max())
    h0, edges = np.histogram(true0, bins=bins, range=(lo, hi), density=True)
    h1, _ = np.histogram(true1, bins=bins, range=(lo, hi), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    ok = (h0 > 0) & (h1 > 0)
    x = centers[ok]
    y = np.log(h0[ok] / h1[ok])
    if x.size == 0 or not np.any(x != 0):
        return 1.0
    # least-squares fit of y = alpha * x through the origin
    return float(np.dot(x, y) / np.dot(x, x))
