"""Multi-process smoke of the Monte-Carlo engines: N processes against one.

    python -m qldpc_tpu_torch.parallel.smoke --procs 2 --device cpu
    python -m qldpc_tpu_torch.parallel.smoke --procs 4 --device cuda

The port's counterpart of ``__graft_entry__.dryrun_multichip`` and
``scripts/distributed_smoke.py``. It starts ``--procs`` worker processes
(``python -m qldpc_tpu_torch.parallel.smoke --worker``, one per rank, joined
in a gloo group over a ``file://`` store in a fresh temporary directory),
which run one batch of the code-capacity and DEM engines at tiny shapes on
the world's 1-D mesh, and, where the count is even, a three-rate sweep on
the ``(rate, mc)`` mesh of two rate groups. This process then runs the same
cases alone and compares every counter. It prints one JSON line and exits
non-zero on any mismatch, on a worker's failure, or when ``--timeout``
expires (the workers are then killed).

``--device cuda`` gives each rank ``parallel.rank_device()`` (one card a
rank, or all ranks on one card where the host has one); ``cuda:0`` puts
every rank on that card. ``run_cases`` and ``launch`` are the pieces
``chip_smoke.py`` drives at full width.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import pkgutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from qldpc_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh, rank_device

__all__ = ["CASE_DEFAULTS", "build_engine", "compare", "jsonable", "join", "kernel_wrappers",
           "launch", "run_cases", "tiny_cases"]

ROOT = Path(__file__).resolve().parents[2]  # the directory holding the package
CASE_DEFAULTS = dict(seed=0, method="sum-product", osd_order=0, osd_fraction=1.0,
                     n_rounds=0, q=None, rounds=0, rate_shards=1, warm=False)


def tiny_cases(procs: int) -> list[dict]:
    """One batch each of Steane code capacity and the Steane DEM, and a
    rate-sharded sweep over three rates (padded to four) for an even count."""
    ms = dict(code="steane", batch=64, max_iter=20, method="min-sum")
    cases = [
        dict(ms, name="steane-code-capacity", channel="code-capacity", rates=[0.05], trials=64),
        dict(ms, name="steane-dem", channel="dem", rounds=2, rates=[0.01], trials=64),
    ]
    if procs % 2 == 0:
        cases.append(dict(ms, name="steane-rate-sharded", channel="code-capacity",
                          rates=[0.03, 0.05, 0.07], trials=128, rate_shards=2))
    return cases


def kernel_wrappers() -> dict:
    """Every kernel wrapper of ``qldpc_tpu_torch.ops``, by name: each counts
    its launches in ``.launches``."""
    from qldpc_tpu_torch import ops

    found = {}
    for info in pkgutil.iter_modules(ops.__path__):
        module = importlib.import_module(f"qldpc_tpu_torch.ops.{info.name}")
        for name, fn in vars(module).items():
            if callable(fn) and hasattr(fn, "launches"):
                found[name] = fn
    return found


def build_engine(case: dict, device, mesh: Mesh):
    """The engine a case names: ``code``, ``channel`` (an engine channel, or
    ``dem`` for the Z-memory DEM of ``rounds`` rounds), ``batch``, BP's
    ``max_iter`` and ``method``, ``osd_order`` (None: BP alone),
    ``osd_fraction``, ``n_rounds`` and ``q`` (space-time, phenomenological)."""
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
    from qldpc_tpu_torch.mc import DEMEngine, DEMEngineConfig, EngineConfig, MonteCarloEngine
    from qldpc_tpu_torch.noise.circuit import parametric_memory_dem

    c = {**CASE_DEFAULTS, **case}
    kw = dict(bp=BPConfig(max_iter=c["max_iter"], method=c["method"]),
              osd=None if c["osd_order"] is None else OSDConfig(order=c["osd_order"]),
              batch_size=c["batch"], osd_fraction=c["osd_fraction"])
    code = get_code(c["code"])
    if c["channel"] == "dem":
        dem = parametric_memory_dem(code, basis="z", rounds=c["rounds"] or code.distance)
        return DEMEngine(dem, DEMEngineConfig(**kw), device=device, name=c["code"], mesh=mesh)
    cfg = EngineConfig(channel=c["channel"], n_rounds=c["n_rounds"],
                       syndrome_flip_rate=c["q"], **kw)
    return MonteCarloEngine(code, cfg, device=device, mesh=mesh)


def jsonable(d: dict) -> dict:
    """A counters_to_dict result with its arrays as lists, for JSON."""
    return {k: v.tolist() if isinstance(v, np.ndarray) else v for k, v in d.items()}


def run_cases(cases: list[dict], device, meshes=make_mesh) -> list[dict]:
    """Run each case's sweep (``rates``, ``trials``, ``seed``) on the mesh
    ``meshes(rate_shards)`` gives; returns per case the counters of each
    rate, the sweep's wall seconds between barriers and the kernel launches
    it made here. ``warm`` runs one batch first, untimed."""
    device = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    wrappers = kernel_wrappers()
    out = []
    for case in cases:
        c = {**CASE_DEFAULTS, **case}
        mesh = meshes(c["rate_shards"])
        eng = build_engine(c, device, mesh)
        if c["warm"]:
            eng.run_rate(c["rates"][0], c["batch"], seed=c["seed"] + 1_000_000)
        sync()
        for fn in wrappers.values():
            fn.launches = 0
        if mesh.world_size > 1:
            dist.barrier()
        t0 = time.perf_counter()
        res = eng.sweep(c["rates"], c["trials"], seed=c["seed"])
        sync()
        seconds = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items() if fn.launches}
        out.append(dict(name=c["name"], per_rate=[jsonable(d) for d in res.per_rate],
                        seconds=seconds, trials=c["trials"] * len(c["rates"]),
                        launches=launches))
        del eng
    return out


def compare(reference: list[dict], ranks: list[list[dict]]) -> list[dict]:
    """Each case: its counters identical on every rank and to the
    reference, and the times on one process and on the ranks (the slowest)."""
    rows = []
    for i, ref in enumerate(reference):
        got = [r[i] for r in ranks]
        seconds = max(g["seconds"] for g in got)
        rows.append(dict(
            name=ref["name"], identical=all(g["per_rate"] == ref["per_rate"] for g in got),
            trials=ref["trials"], seconds_1=ref["seconds"], seconds_n=seconds,
            trials_per_s_1=ref["trials"] / ref["seconds"], trials_per_s_n=ref["trials"] / seconds,
            launches_1=ref["launches"], launches_n=[g["launches"] for g in got],
        ))
    return rows


def launch(procs: int, job: dict, timeout: float, module: str | None = None,
           script: str | None = None) -> list:
    """Start ``procs`` worker processes (``python -m module`` or ``python
    script``, each given ``--worker --job DIR --rank r``) on ``job`` (written
    to DIR/job.json with the store's address and the timeout), wait for them
    and return each rank's result, read from DIR/rank{r}.json. Raises when a
    worker fails or the timeout expires; every worker is gone by then."""
    with tempfile.TemporaryDirectory(prefix="qldpc-mesh-") as tmp:
        job = dict(job, procs=procs, timeout=timeout, store=f"file://{tmp}/store",
                   threads=max(1, torch.get_num_threads() // procs))
        Path(tmp, "job.json").write_text(json.dumps(job))
        entry = ["-m", module] if module is not None else [script]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            x for x in (str(ROOT), os.environ.get("PYTHONPATH", "")) if x))
        # every worker runs on this host: gloo binds the loopback device
        # rather than resolving the host's name
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        workers, logs = [], []
        try:
            for r in range(procs):
                logs.append(open(Path(tmp, f"rank{r}.log"), "w"))
                workers.append(subprocess.Popen(
                    [sys.executable, *entry, "--worker", "--job", tmp, "--rank", str(r)],
                    stdout=logs[-1], stderr=subprocess.STDOUT, cwd=ROOT,
                    env=dict(env, LOCAL_RANK=str(r)),
                ))
            deadline = time.monotonic() + timeout
            codes = []
            for w in workers:
                try:
                    codes.append(w.wait(timeout=max(deadline - time.monotonic(), 0.1)))
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"the workers did not finish in {timeout} s") from None
            failed = [r for r, code in enumerate(codes) if code != 0]
            if failed:
                raise RuntimeError("\n".join(
                    f"worker {r} exited with {codes[r]}:\n"
                    + Path(tmp, f"rank{r}.log").read_text()[-3000:] for r in failed))
            return [json.loads(Path(tmp, f"rank{r}.json").read_text()) for r in range(procs)]
        finally:
            for w in workers:
                if w.poll() is None:
                    w.kill()
                    w.wait()
            for log in logs:
                log.close()


def join(job_dir: str, rank: int) -> dict:
    """A worker's start: read the job, join the group, set the threads."""
    job = json.loads(Path(job_dir, "job.json").read_text())
    torch.set_num_threads(job["threads"])
    init_distributed(job["store"], timeout_s=job["timeout"], rank=rank,
                     world_size=job["procs"])
    return job


def worker_device(name: str) -> torch.device:
    """``cuda`` is this rank's card (``rank_device``); any other name is
    taken as it is."""
    return rank_device() if name == "cuda" else torch.device(name)


def _worker(job_dir: str, rank: int) -> None:
    job = join(job_dir, rank)
    try:
        # make_mesh creates each rate group's ProcessGroup: once per shape
        result = run_cases(job["cases"], worker_device(job["device"]), functools.cache(make_mesh))
        Path(job_dir, f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m qldpc_tpu_torch.parallel.smoke")
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="cpu, cuda (a card a rank, from LOCAL_RANK) or cuda:N")
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--job", help=argparse.SUPPRESS)
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        _worker(args.job, args.rank)
        return 0
    from qldpc_tpu_torch.mc.engine import engine_device

    device = engine_device(args.device)  # raises for cuda without a card
    cases = tiny_cases(args.procs)
    try:
        ranks = launch(args.procs, dict(cases=cases, device=args.device), args.timeout,
                       module="qldpc_tpu_torch.parallel.smoke")
    except RuntimeError as err:
        print(json.dumps({"ok": False, "error": str(err)}))
        return 1
    rows = compare(run_cases(cases, device, meshes=lambda r: Mesh()), ranks)
    ok = all(row["identical"] for row in rows)
    print(json.dumps({"ok": ok, "procs": args.procs, "device": args.device, "cases": rows}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
