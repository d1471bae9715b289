"""The port package's boundaries: no JAX, no kernel fallback, config carry-over."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from qldpc_tpu_torch.convert import osd_config_from_reference
from qldpc_tpu_torch.decoders import OSDConfig
from qldpc_tpu_torch.ops import bp_cuda, osd_cuda

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import qldpc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(qldpc_tpu_torch.__path__, "qldpc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print(len(names), leaked)
"""


def _run(code: str) -> str:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_importing_every_module_leaves_jax_out():
    count, leaked = _run(_IMPORT_ALL).split(" ", 1)
    assert int(count) >= 12  # every module of the slice was imported
    assert leaked == "[]", f"qldpc_tpu_torch pulled in {leaked}"


def test_chip_smoke_imports_no_jax():
    # its module level must stay importable without JAX and a card
    out = _run(
        "import sys, chip_smoke;"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'jax'))"
    )
    assert out.splitlines()[-1] == "[]"


def test_kernel_sources_ship_beside_the_wrappers():
    csrc = REPO / "qldpc_tpu_torch" / "ops" / "csrc"
    assert (csrc / "bp_flooding.cu").is_file()
    assert (csrc / "gf2_elim.cu").is_file()
    assert bp_cuda._LIB.source.parent == osd_cuda._LIB.source.parent == csrc


def test_wrappers_refuse_unknown_devices():
    meta = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        osd_cuda.eliminate_rows(meta.to(torch.int32).view(2, 3, 1), meta.to(torch.int32), 3)
    with pytest.raises(ValueError, match="needs CUDA"):
        bp_cuda.bp_flooding_cuda(torch.zeros(1, 3), torch.zeros(7), None, None)
    with pytest.raises(ValueError, match="needs A and b on one CUDA device"):
        osd_cuda.eliminate_rows_cuda(torch.zeros((1, 3, 1), dtype=torch.int32),
                                     torch.zeros((1, 3), dtype=torch.int32), 3)


def test_osd_config_conversion():
    ref = {"order": 0, "max_combinations": None, "extra_positions": 10,
           "dtype": "float32", "backend": "pallas", "max_elim_cols": 2048,
           "chunk": 64, "batch_tile": 256}
    assert osd_config_from_reference(ref) == OSDConfig(order=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        osd_config_from_reference({**ref, "order": 1})
    with pytest.raises(ValueError, match="no fields"):
        osd_config_from_reference({"order": 0, "bogus": 1})
    with pytest.raises(TypeError):
        osd_config_from_reference(42)
