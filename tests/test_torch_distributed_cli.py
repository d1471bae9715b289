"""The port's multi-process entry points on the CPU: ``parallel.smoke`` and
the experiments CLI under ``torchrun``.

``torchrun --standalone`` picks its own free port, and every subprocess has
a timeout, so a hung rendezvous fails its test. The CLI's archive at 2 ranks
must equal one process's, and only rank 0 prints and writes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qldpc_tpu_torch.experiments.cli import main
from qldpc_tpu_torch.experiments.results_io import load_results
from qldpc_tpu_torch.parallel import rank_device, smoke

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, PYTHONPATH=str(REPO), GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")


def _run(args: list[str], timeout: float = 300) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=REPO,
                          env=ENV, timeout=timeout)


def test_parallel_smoke_exits_0_on_two_cpu_processes():
    proc = _run(["-m", "qldpc_tpu_torch.parallel.smoke", "--procs", "2", "--device", "cpu",
                 "--timeout", "240"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["ok"] and report["procs"] == 2
    assert [c["name"] for c in report["cases"]] == [
        "steane-code-capacity", "steane-dem", "steane-rate-sharded"]
    assert all(c["identical"] for c in report["cases"])


ARGS = ["run", "study", "--device", "cpu", "--codes", "steane", "[[72, 12, 6]]", "--trials",
        "200", "--batch-size", "64", "--error-rates", "0.03", "0.05"]


def test_cli_under_torchrun_equals_one_process(tmp_path):
    out2, out1 = tmp_path / "two", tmp_path / "one"
    proc = _run(["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                 "-m", "qldpc_tpu_torch.experiments.cli", *ARGS, "--out", str(out2)])
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert main([*ARGS, "--out", str(out1), "--quiet"]) == 0
    # one process printed the per-rate lines
    assert proc.stdout.count("[study] steane p=0.03:") == 1
    a, b = load_results(out2 / "study.npz"), load_results(out1 / "study.npz")
    cells = [(c, p) for c in ("steane", "[[72, 12, 6]]") for p in (0.03, 0.05)]
    for c, p in cells:
        assert a[c][p].keys() == b[c][p].keys()
        for k in b[c][p]:
            np.testing.assert_array_equal(np.asarray(a[c][p][k]), np.asarray(b[c][p][k]),
                                          err_msg=f"{c} {p} {k}")
    assert a[cells[0][0]][0.03]["trials"] == 200
    # the same files, checkpoints included, written once
    files = lambda d: sorted(str(f.relative_to(d)) for f in d.rglob("*"))
    assert files(out2) == files(out1)
    assert not list(out2.rglob("*.tmp"))


def test_rank_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for local, card in (("0", "cuda:0"), ("1", "cuda:1"), ("3", "cuda:1")):
        monkeypatch.setenv("LOCAL_RANK", local)
        assert rank_device() == torch.device(card)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_device()


def test_launch_fails_rather_than_hangs(tmp_path):
    """A worker that hangs is killed when the timeout expires, and one that
    fails raises with its exit code and log; neither outlives the call."""
    hang = tmp_path / "hang.py"
    hang.write_text("import sys, time\nif sys.argv[-1] == '1':\n    time.sleep(600)\n")
    with pytest.raises(RuntimeError, match="did not finish in 3 s"):
        smoke.launch(2, {}, 3, script=str(hang))
    fail = tmp_path / "fail.py"
    fail.write_text("import sys\nprint('rank', sys.argv[-1])\nsys.exit(3 if sys.argv[-1] == '1' else 0)\n")
    with pytest.raises(RuntimeError, match="worker 1 exited with 3:\nrank 1"):
        smoke.launch(2, {}, 60, script=str(fail))
