"""The sampler's counter stream on the card: the CUDA kernel K8.

K8 (``csrc/threefry_uniform.cu``) replaces no Pallas kernel: the JAX
package's qldpc_tpu/utils/rng.py:counter_uniform is XLA code. It computes
``utils/rng.py:counter_uniform_plain`` bit for bit, the 20-round
threefry2x32 of every counter pair and the 24-bit conversion, in uint32
registers, and writes the (batch, stride) float32 uniforms once in their
final layout; its header says what bounds it on the card.

``utils/rng.py:counter_uniform`` is the entry point: the plain version for
the CPU, K8 on a card, never a fallback.
"""

from __future__ import annotations

import ctypes

import torch

from qldpc_tpu_torch._build import KernelLibrary
from qldpc_tpu_torch.utils.profiling import count

__all__ = ["launch_shape", "counter_uniform_cuda"]

_THREADS = 256  # K8_THREADS: the most threads a block
_MAX_GRID_Y = 65535

_vp, _i, _u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_LIB = KernelLibrary(
    "threefry_uniform.cu",
    {"threefry_uniform_launch": [_vp, _u, _u, _u, _i, _i, _i, _i, _i, _i, _vp]},
)


def launch_shape(batch: int, pairs: int) -> tuple[int, int, int, int]:
    """K8's (bx, gy, grid_x, grid_y) for ``batch`` samples of ``pairs``
    counter pairs: a row cut into ``chunks = ceil(pairs / 256)`` runs of
    ``bx`` pairs, ``gy`` samples a block, a block per ``gy`` samples and
    chunk (at most 65,535 chunks in the grid; the threads step past them)."""
    chunks = -(-pairs // _THREADS)
    bx = -(-pairs // chunks)
    gy = max(1, _THREADS // bx)
    return bx, gy, -(-batch // gy), min(chunks, _MAX_GRID_Y)


def counter_uniform_cuda(k: torch.Tensor, first_sample: int, batch: int, stride: int,
                         device) -> torch.Tensor:
    """Launch K8: ``counter_uniform_plain``'s (batch, stride) float32
    uniforms on the CUDA ``device``. ``k`` is the key on the CPU (its words
    are read on the host and passed by value)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("counter_uniform_cuda needs a CUDA device")
    if k.device.type != "cpu":
        raise ValueError("the key must be on the CPU: its words are passed by value")
    if stride < 1 or batch < 0:
        raise ValueError(f"need stride >= 1 and batch >= 0, got {stride} and {batch}")
    k0, k1 = (int(v) for v in k.tolist())
    P = (stride + 1) // 2
    base = (int(first_sample) * P) & 0xFFFFFFFF
    out = torch.empty((batch, stride), dtype=torch.float32, device=device)
    if batch == 0:
        return out
    _LIB.call(
        "threefry_uniform_launch", out.data_ptr(), k0, k1, base, batch, stride,
        *launch_shape(batch, P), torch.cuda.current_stream(device).cuda_stream,
    )
    counter_uniform_cuda.launches += 1
    count("sample.kernel_draws", batch * stride)
    return out


counter_uniform_cuda.launches = 0
