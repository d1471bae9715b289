"""The benchmark loads neither JAX nor the JAX package, and its reference
loads nothing of the program."""

import ast
import subprocess
import sys
import types
from pathlib import Path

from benchmark import harness

BENCH = Path(__file__).resolve().parent.parent


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    for name in ("qldpc_tpu", "qldpc_tpu.mc", "jax.numpy", "jaxlib", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "qldpc_tpu_torch_extra", types.ModuleType("x"))
    found = harness.forbidden_modules()
    assert {"qldpc_tpu", "qldpc_tpu.mc", "jax.numpy", "jaxlib", "flax.linen"} <= set(found)
    assert "qldpc_tpu_torch_extra" not in found
    assert not [m for m in found if m.startswith("qldpc_tpu_torch")]


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_only_numpy_torch_and_itself():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert _imports(path) <= {"__future__", "numpy", "torch", "benchmark"}, path


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in sorted(BENCH.rglob("*.py")):
        bad = _imports(path) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_a_cpu_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.tests import tiny\n"
            "res = tiny.run('cc')\n"
            "from benchmark import harness\n"
            "assert res['correct'], res['checks']\n"
            "print(harness.forbidden_modules())\n") % str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(BENCH.parent))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
