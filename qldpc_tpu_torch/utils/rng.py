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
never global state. On a card ``counter_uniform`` launches the kernel K8
(``ops/threefry_cuda.py``), which computes the same stream in uint32
registers; the int64 code, ``counter_uniform_plain``, is its plain version
and the CPU's path.

Beside the counter mode, ``split``, ``uniform`` and ``bernoulli`` compute
``jax.random``'s keyed draws bit for bit, as JAX 0.9 does them with
``jax_threefry_partitionable`` on: the counters of an array of shape ``s``
are the flattened iota over ``s`` split into its high and low 32-bit words,
and the two cipher outputs are combined per element. A ``(..., 2)`` tensor of
keys draws for each key what ``jax.vmap`` over the keys would.
"""

from __future__ import annotations

import math

import torch

from qldpc_tpu_torch.ops import threefry_cuda
from qldpc_tpu_torch.utils.profiling import count

__all__ = [
    "key",
    "fold_in",
    "threefry2x32",
    "counter_uniform",
    "counter_uniform_plain",
    "counter_bernoulli",
    "split",
    "random_bits",
    "uniform",
    "bernoulli",
]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on int64 tensors or Python ints holding
    uint32 words.

    ``k0``/``k1`` are Python ints or 0-d/broadcastable int64 tensors; ``x0``
    and ``x1`` are the two counter words, int64 tensors or Python ints.
    Returns the two output words, Python ints when all four inputs are.
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
    """``jax.random.fold_in``: threefry2x32 of the counter pair ``(0, data)``,
    one block computed on Python ints, so a batch key costs one tensor."""
    k0, k1 = (int(v) for v in k.tolist())
    o0, o1 = threefry2x32(k0, k1, 0, int(data) & _MASK)
    return torch.tensor([o0, o1], dtype=torch.int64)


def counter_uniform(
    k: torch.Tensor, first_sample: int, batch: int, stride: int, device=None
) -> torch.Tensor:
    """(batch, stride) float32 uniforms in [0, 1) for global samples
    ``first_sample .. first_sample + batch`` (qldpc_tpu/utils/rng.py:48):
    ``counter_uniform_plain`` on the CPU, the kernel K8
    (``ops/threefry_cuda.py``) on a card, never a fallback."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cuda":
        return threefry_cuda.counter_uniform_cuda(k, first_sample, batch, stride, device)
    if device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return counter_uniform_plain(k, first_sample, batch, stride, device)


def counter_uniform_plain(
    k: torch.Tensor, first_sample: int, batch: int, stride: int, device=None
) -> torch.Tensor:
    """``counter_uniform`` in int64 torch on ``device``."""
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
    count("host_syncs")  # p's copy to the device
    return (u < p32).to(torch.int8)


def _iota_bits(k: torch.Tensor, shape: tuple[int, ...], device=None):
    """The two threefry2x32 output words for every element of ``shape``
    under each key of ``k`` (..., 2): counters are the flattened iota's high
    and low words. Returns two int64 tensors of shape ``(..., *shape)``."""
    k = torch.as_tensor(k, dtype=torch.int64).to(device)
    size = math.prod(shape)
    idx = torch.arange(size, dtype=torch.int64, device=k.device)
    lead = k.shape[:-1]
    k0 = k[..., 0].reshape(*lead, 1)
    k1 = k[..., 1].reshape(*lead, 1)
    o0, o1 = threefry2x32(k0, k1, (idx >> 32).expand(*lead, size), (idx & _MASK).expand(*lead, size))
    return o0.reshape(*lead, *shape), o1.reshape(*lead, *shape)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``num`` new keys from ``k`` (..., 2), shape
    (..., num, 2)."""
    o0, o1 = _iota_bits(k, (num,))
    return torch.stack([o0, o1], dim=-1)


def random_bits(k: torch.Tensor, shape: tuple[int, ...], width: int = 32,
                device=None) -> torch.Tensor:
    """``jax.random.bits`` of 32 or 64 bits as int64 (the 64-bit words
    hold the two's-complement pattern of the uint64)."""
    o0, o1 = _iota_bits(k, tuple(shape), device)
    if width == 32:
        return o0 ^ o1
    if width == 64:
        return (o0 << 32) | o1
    raise ValueError(f"width must be 32 or 64, got {width}")


def uniform(k: torch.Tensor, shape: tuple[int, ...], dtype=torch.float32,
            device=None) -> torch.Tensor:
    """``jax.random.uniform`` in [0, 1): random mantissa bits under the
    exponent of 1.0, minus 1.0 (not the 24-bit conversion of
    ``counter_uniform``)."""
    o0, o1 = _iota_bits(k, tuple(shape), device)
    if dtype == torch.float32:
        word = ((o0 ^ o1) >> 9) | 0x3F800000
        return word.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        # the top 52 bits of the uint64 (o0 << 32) | o1
        word = (o0 << 20) | (o1 >> 12) | 0x3FF0000000000000
        return word.view(torch.float64) - 1.0
    raise ValueError(f"dtype must be float32 or float64, got {dtype}")


def bernoulli(k: torch.Tensor, p, shape: tuple[int, ...], dtype=torch.float32,
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli`` as int8: ``uniform < p``, both in ``dtype``,
    which is the dtype JAX gives ``p`` (float32 for a Python float, float64
    when JAX runs with x64 enabled)."""
    u = uniform(k, shape, dtype, device)
    return (u < torch.as_tensor(p, dtype=dtype, device=u.device)).to(torch.int8)
