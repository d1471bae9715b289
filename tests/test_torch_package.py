"""The port package's boundaries: no JAX, no kernel fallback, config carry-over."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from qldpc_tpu_torch.convert import osd_config_from_reference
from qldpc_tpu_torch.decoders import OSDConfig
from qldpc_tpu_torch.ops import (
    bp_cuda,
    bp_layered_cuda,
    dem_bp_cuda,
    osd_cuda,
    osd_factored_cuda,
    osd_transform_cuda,
    spacetime_bp_cuda,
)

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


def test_dem_kernel_sources_ship_beside_the_wrappers():
    csrc = REPO / "qldpc_tpu_torch" / "ops" / "csrc"
    for module, source in ((dem_bp_cuda, "dem_bp.cu"),
                           (osd_transform_cuda, "gf2_transform_elim.cu"),
                           (osd_factored_cuda, "gf2_factored.cu")):
        assert (csrc / source).is_file()
        assert module._LIB.source == csrc / source


def test_spacetime_and_layered_kernel_sources_ship_beside_the_wrappers():
    csrc = REPO / "qldpc_tpu_torch" / "ops" / "csrc"
    for module, source in ((spacetime_bp_cuda, "spacetime_bp.cu"),
                           (bp_layered_cuda, "bp_layered.cu")):
        assert (csrc / source).is_file()
        assert module._LIB.source == csrc / source


_DEM_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None  # any import of jax now raises
sys.modules["qldpc_tpu"] = None  # and so does any import of the JAX package
from qldpc_tpu_torch.codes import get_code
from qldpc_tpu_torch.noise.circuit import parametric_memory_dem
from qldpc_tpu_torch.mc import DEMEngine, DEMEngineConfig
dem = parametric_memory_dem(get_code("steane"), basis="z", rounds=2)
eng = DEMEngine(dem, DEMEngineConfig(batch_size=16), device="cpu")
d = eng.run(16, seed=0, p=0.01)
print(dem.H.shape, d["trials"], sorted(m for m in sys.modules if m.startswith("qldpc_tpu.")))
"""


def test_dem_path_runs_with_jax_blocked():
    shape, trials, loaded = _run(_DEM_WITHOUT_JAX).rsplit(" ", 2)
    assert shape.startswith("(") and int(trials) == 16
    # nothing of the JAX package was loaded
    assert loaded == "[]"


_IMPORT_ALL_BLOCKED = """
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["qldpc_tpu"] = None
import qldpc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(qldpc_tpu_torch.__path__, "qldpc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "qldpc_tpu_torch.decoders.alvarado" in names
for name in ("parallel.mesh", "parallel.smoke", "examples.quickstart", "examples.noise_models",
             "examples.degeneracy_count"):
    assert "qldpc_tpu_torch." + name in names, name
import chip_smoke
for script in ("validate_port", "mesh_throughput"):
    spec = importlib.util.spec_from_file_location(script, f"scripts/{script}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(len(names))
"""


def test_port_imports_nothing_of_the_jax_package():
    # every module of the port, chip_smoke.py and the scripts that drive the
    # port on the card import with both jax and qldpc_tpu blocked
    assert int(_run(_IMPORT_ALL_BLOCKED)) >= 20


def test_wrappers_refuse_unknown_devices():
    meta = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        osd_cuda.eliminate_rows(meta.to(torch.int32).view(2, 3, 1), meta.to(torch.int32), 3)
    with pytest.raises(ValueError, match="needs CUDA"):
        bp_cuda.bp_flooding_cuda(torch.zeros(1, 3), torch.zeros(7), None, None)
    with pytest.raises(ValueError, match="needs CUDA"):
        spacetime_bp_cuda.st_bp_cuda(torch.zeros(1, 3), torch.zeros(7), None, 1, None)
    with pytest.raises(ValueError, match="needs CUDA"):
        bp_layered_cuda.bp_layered_cuda(torch.zeros(1, 3), torch.zeros(7), None, None)
    with pytest.raises(ValueError, match="needs A and b on one CUDA device"):
        osd_cuda.eliminate_rows_cuda(torch.zeros((1, 3, 1), dtype=torch.int32),
                                     torch.zeros((1, 3), dtype=torch.int32), 3)


def test_osd_config_conversion():
    ref = {"order": 0, "max_combinations": None, "extra_positions": 10,
           "dtype": "float32", "backend": "pallas", "max_elim_cols": 2048,
           "chunk": 64, "batch_tile": 256}
    assert osd_config_from_reference(ref) == OSDConfig(order=0)
    # the factored elimination carries over; every other JAX backend is "auto"
    got = osd_config_from_reference({**ref, "backend": "factored", "max_elim_cols": 4096})
    assert got == OSDConfig(order=0, backend="factored", max_elim_cols=4096)
    # OSD-e's fields carry over; dtype (the LLRs' in either package) and
    # batch_tile are dropped
    assert osd_config_from_reference({**ref, "order": 1, "max_combinations": 9}) == OSDConfig(
        order=1, max_combinations=9)
    with pytest.raises(ValueError, match="no fields"):
        osd_config_from_reference({"order": 0, "bogus": 1})
    with pytest.raises(TypeError):
        osd_config_from_reference(42)


_CLI_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["qldpc_tpu"] = None
from qldpc_tpu_torch.experiments.cli import main
from qldpc_tpu_torch.experiments.results_io import load_results
out = sys.argv[1]
code = main(["run", "complete-bposd", "--codes", "steane", "--trials", "32", "--batch-size",
             "32", "--error-rates", "0.005", "--device", "cpu", "--out", out, "--quiet"])
d = load_results(out + "/complete-bposd.npz")["steane"][0.005]
print(code, d["trials"], sorted(m for m, v in sys.modules.items()
                                if v is not None and m.split(".")[0] in ("jax", "qldpc_tpu")))
"""


def test_cli_runs_with_jax_blocked(tmp_path):
    # the experiments CLI (a circuit-level preset: DEM build, BP, OSD,
    # checkpoints, archives) with both jax and qldpc_tpu blocked
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_WITHOUT_JAX, str(tmp_path)], capture_output=True,
        text=True, cwd=REPO, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    code, trials, loaded = proc.stdout.strip().splitlines()[-1].split(" ", 2)
    assert (code, trials, loaded) == ("0", "32", "[]")
    assert "not ported" not in proc.stderr  # the preset's bf16 streams run as shipped
    assert (tmp_path / "complete-bposd_ckpt").is_dir()


_GENERATE_WITHOUT_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["qldpc_tpu"] = None
from qldpc_tpu_torch.codes.generate import main
main(sys.argv[1])
print(sorted(m for m, v in sys.modules.items()
             if v is not None and m.split(".")[0] in ("jax", "qldpc_tpu")))
"""


def test_generate_writes_the_jax_modules_code_files(tmp_path, capsys):
    """``qldpc_tpu_torch.codes.generate``, run with jax and qldpc_tpu
    blocked, writes every registered code's npz with the arrays the JAX
    package's ``qldpc_tpu.codes.generate`` writes, array for array."""
    import numpy as np

    from qldpc_tpu.codes.generate import main as jax_main

    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run(
        [sys.executable, "-c", _GENERATE_WITHOUT_JAX, str(tmp_path / "port")],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    jax_main(str(tmp_path / "jax"))
    capsys.readouterr()
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.npz"))
    assert len(names) >= 6
    assert sorted(p.name for p in (tmp_path / "port").glob("*.npz")) == names
    for name in names:
        with np.load(tmp_path / "port" / name) as got, np.load(tmp_path / "jax" / name) as ref:
            assert sorted(got.files) == sorted(ref.files), name
            for key in ref.files:
                assert got[key].dtype == ref[key].dtype, (name, key)
                assert np.array_equal(got[key], ref[key]), (name, key)
