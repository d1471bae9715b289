"""Build and load the port's CUDA kernels.

Each kernel source under ``qldpc_tpu_torch/ops/csrc/`` is compiled with
``nvcc`` at first use into a shared library with a plain C interface and
loaded with ctypes. Libraries land in ``qldpc_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is never
served a stale library. A source outside ``csrc/`` (an edited copy) finds
the shared headers there too.

The flags pin the numerics: ``-fmad=false`` keeps nvcc from contracting
``a*b + c`` into one fused multiply-add, which torch's separate elementwise
kernels never do, so a kernel can match its plain torch version bit for bit.
No fast-math flag is used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "KernelLibrary", "nvcc_path"]

CSRC_DIR = Path(__file__).resolve().parent / "ops" / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    location. Raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class KernelLibrary:
    """One kernel source, compiled on first use and loaded with ctypes.

    ``declare`` maps each exported C function to its ctypes argument types;
    every exported function returns the ``cudaError_t`` of its launch.
    """

    def __init__(self, source: str, declare: dict[str, list]):
        self.source = CSRC_DIR / source
        self._declare = declare
        self._lib = None
        self.build_log = ""

    def _library_path(self) -> Path:
        headers = b"".join(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh")))
        digest = hashlib.sha256(
            self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}_{digest}.so"

    def build(self) -> Path:
        """Compile the source unless its library already exists."""
        out = self._library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(self.source)],
            capture_output=True, text=True,
        )
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source.name}:\n{self.build_log}"
            )
        os.replace(tmp, out)
        return out

    @property
    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for name, argtypes in self._declare.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, name: str, *args) -> None:
        """Launch through the C entry point; raise on a CUDA error."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.source.name}::{name} launch failed with cudaError {err}"
            )
