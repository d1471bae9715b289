"""qldpc_tpu_torch — the PyTorch/CUDA port of qldpc_tpu for one NVIDIA H100.

The code-capacity Monte-Carlo slice: counter-mode RNG, noise channels,
flooding BP and OSD-0 decoders, and the single-device engine. Plain torch
runs everywhere; on CUDA tensors BP and the OSD elimination launch the
hand-written kernels under ``ops/csrc/`` (built with nvcc at first use, see
``_build.py``). The JAX package ``qldpc_tpu`` stays the reference; this
package imports only its JAX-free host modules (codes, the Tanner graph).
"""

from qldpc_tpu import codes

__version__ = "0.1.0"

__all__ = ["codes"]
