"""Counter-mode Monte-Carlo RNG: an exact port of the threefry2x32 stream.

The JAX engine draws sample ``g``'s uniform ``j`` as

    u[g, j] = convert( threefry2x32(key, g*P + j//2, 0)[j % 2] )

with ``P = ceil(stride/2)`` counter pairs per sample (qldpc_tpu/utils/rng.py).
This module computes the same 20-round threefry2x32 block cipher in plain
torch, so the port draws exactly the errors the JAX engine draws at the same
seed and whole-engine counters can be compared bit for bit.

torch has no unsigned 32-bit arithmetic worth using, so words are carried in
int64 and reduced with ``& 0xFFFFFFFF`` after every add and rotate. A key is
an int64 tensor of shape (2,) holding the two 32-bit key words, the same
``key_data`` layout as ``jax.random.key_data``; keys are explicit values,
never global state.
"""

from __future__ import annotations

import torch

__all__ = [
    "key",
    "fold_in",
    "threefry2x32",
    "counter_uniform",
    "counter_bernoulli",
]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(
    k0, k1, x0: torch.Tensor, x1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds on int64 tensors holding uint32 words.

    ``k0``/``k1`` are Python ints or 0-d/broadcastable int64 tensors; ``x0``
    and ``x1`` are the two counter words. Returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed: int) -> torch.Tensor:
    """Key data of ``jax.random.key(seed)``: ``[seed >> 32, seed & 0xFFFFFFFF]``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: threefry2x32 of the counter pair ``(0, data)``."""
    k0, k1 = (int(v) for v in k.tolist())
    x0 = torch.zeros(1, dtype=torch.int64)
    x1 = torch.tensor([int(data) & _MASK], dtype=torch.int64)
    o0, o1 = threefry2x32(k0, k1, x0, x1)
    return torch.cat([o0, o1])


def counter_uniform(
    k: torch.Tensor, first_sample: int, batch: int, stride: int, device=None
) -> torch.Tensor:
    """(batch, stride) float32 uniforms in [0, 1) for global samples
    ``first_sample .. first_sample + batch`` (qldpc_tpu/utils/rng.py:48)."""
    P = (stride + 1) // 2  # counter pairs per sample
    k0, k1 = (int(v) for v in k.tolist())
    base = (int(first_sample) * P) & _MASK
    cnt = (torch.arange(batch * P, dtype=torch.int64, device=device) + base) & _MASK
    o0, o1 = threefry2x32(k0, k1, cnt, torch.zeros_like(cnt))
    # 24-bit mantissa conversion: exact in float32
    conv = lambda o: (o >> 8).to(torch.float32) * (2.0**-24)
    u = torch.stack([conv(o0), conv(o1)], dim=1).reshape(batch, 2 * P)
    return u[:, :stride] if 2 * P != stride else u


def counter_bernoulli(
    k: torch.Tensor, p, first_sample: int, shape: tuple[int, int], device=None
) -> torch.Tensor:
    """Bernoulli(p) int8 draws, one global counter stream per sample row;
    the comparison is ``u < float32(p)`` as in the JAX engine."""
    batch, stride = shape
    u = counter_uniform(k, first_sample, batch, stride, device=device)
    p32 = torch.as_tensor(p, dtype=torch.float32, device=u.device)
    return (u < p32).to(torch.int8)
