"""qldpc_tpu_torch — the PyTorch/CUDA port of qldpc_tpu for one NVIDIA H100.

The code-capacity Monte-Carlo loop (counter-mode RNG, noise channels,
flooding BP and OSD-0, the single-device engine), circuit-level decoding of
detector error models (BP on irregular graphs, wide-system OSD-0, the DEM
engine), space-time decoding (structured BP over T rounds), the layered BP
schedule, and the experiments layer on top (presets, checkpointed sweeps,
``python -m qldpc_tpu_torch.experiments.cli``). Plain torch runs everywhere; on CUDA tensors BP
and the OSD eliminations launch the hand-written kernels under ``ops/csrc/``
(built with nvcc at first use, see ``_build.py``). The JAX package
``qldpc_tpu`` stays the reference, and this package imports nothing of it:
the host modules it needs (codes, the Tanner graph, the numpy DEM builders)
are copies kept here, and ``convert`` carries JAX-built objects across.
"""

from . import codes

__version__ = "0.1.0"

__all__ = ["codes"]
