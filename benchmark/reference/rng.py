"""Counter-mode threefry2x32 stream, frozen for the reference.

The engines under test draw sample ``g``'s uniform ``j`` of batch ``b`` at
rate ``p`` and seed ``s`` as

    key_b = fold_in(fold_in(key(s), hash(p) % 2**31), b)
    u[g, j] = (threefry2x32(key_b, g * P + j // 2, 0)[j % 2] >> 8) * 2**-24

with ``P = ceil(stride / 2)`` counter pairs per sample: the stream of
``jax.random``'s threefry2x32 (20 rounds), which this module computes in
plain torch on int64 tensors holding uint32 words.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor):
    """The two output words of threefry2x32 (20 rounds) of the counter
    words ``x0``, ``x1`` under the key words ``k0``, ``k1``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    seed = int(seed)
    return (seed >> 32) & MASK, seed & MASK


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    o0, o1 = threefry2x32(k[0], k[1], torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & MASK], dtype=torch.int64))
    return int(o0), int(o1)


def batch_key(seed: int, p: float, batch: int) -> tuple[int, int]:
    return fold_in(fold_in(key(seed), hash(float(p)) % (2**31)), batch)


def counter_uniform(k: tuple[int, int], first_sample: int, batch: int, stride: int,
                    device=None) -> torch.Tensor:
    """(batch, stride) float32 uniforms of global samples ``first_sample``
    onwards."""
    pairs = (stride + 1) // 2
    base = (int(first_sample) * pairs) & MASK
    cnt = (torch.arange(batch * pairs, dtype=torch.int64, device=device) + base) & MASK
    o0, o1 = threefry2x32(k[0], k[1], cnt, torch.zeros_like(cnt))
    u = torch.stack([(o0 >> 8).to(torch.float32), (o1 >> 8).to(torch.float32)], dim=1)
    return (u * (2.0 ** -24)).reshape(batch, 2 * pairs)[:, :stride]
