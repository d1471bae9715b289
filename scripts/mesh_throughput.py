"""Trials/s of the port's engines alone and as N processes sharing one card.

    python3 scripts/mesh_throughput.py [--procs 2] [--rounds 2] [--out DIR]

Runs four full-width workloads, each as one process (this one) and as
``--procs`` processes of ``parallel.smoke`` on cuda:0 that split every batch
(a 1-D mesh), in turns: alone, N, N, alone, ... for ``--rounds`` pairs.
Every run's counters must equal the first alone run's. A run's time is its
sweep between barriers after one untimed batch (the engine build and the
processes' start-up are not in it). Prints one line per run, then a JSON
summary (also written to DIR/mesh_throughput.json with ``--out DIR``) with
the card's name and power limit.

The workloads: [[144,12,12]] code capacity BP(50) + OSD-0, batch 65,536, at
p = 0.01 and p = 0.050119 (20 batches each); [[144,12,12]] space-time at
T = 12, BP(100) + OSD-0, batch 512, p = 0.008 (100 batches); the [[72,12,6]]
Z-memory DEM, BP(50) + OSD-0, batch 1,024, p = 0.002 (16 batches).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CODE = "[[144, 12, 12]]"
CASES = [
    dict(name="cc144-p0.01", code=CODE, channel="code-capacity", batch=65536, max_iter=50,
         rates=[0.01], trials=20 * 65536, seed=1, warm=True),
    dict(name="cc144-p0.050119", code=CODE, channel="code-capacity", batch=65536, max_iter=50,
         rates=[0.050119], trials=20 * 65536, seed=1, warm=True),
    dict(name="st144-T12-p0.008", code=CODE, channel="space-time", n_rounds=12, batch=512,
         max_iter=100, rates=[0.008], trials=100 * 512, seed=1, warm=True),
    dict(name="dem72-p0.002", code="[[72, 12, 6]]", channel="dem", rounds=6, batch=1024,
         max_iter=50, rates=[0.002], trials=16 * 1024, seed=1, warm=True),
]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="also write DIR/mesh_throughput.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mesh_throughput: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from qldpc_tpu_torch.parallel import Mesh, smoke

    card_line = card()
    dev = torch.device("cuda:0")
    runs = {c["name"]: {"1": [], str(args.procs): []} for c in CASES}
    reference = None  # the first turn's: one process
    for r in range(args.rounds):
        for n in ([1, args.procs] if r % 2 == 0 else [args.procs, 1]):
            if n == 1:
                result = smoke.run_cases(CASES, dev, meshes=lambda r: Mesh())
                reference = reference or result
                ranks = [result]
            else:
                ranks = smoke.launch(n, dict(cases=CASES, device="cuda:0"), 600,
                                     module="qldpc_tpu_torch.parallel.smoke")
            for i, ref in enumerate(reference):
                if any(rank[i]["per_rate"] != ref["per_rate"] for rank in ranks):
                    raise AssertionError(f"{ref['name']}: {n} process(es) differ from the first run")
                # the slowest rank's time
                got = max((rank[i] for rank in ranks), key=lambda x: x["seconds"])
                rate = got["trials"] / got["seconds"]
                runs[got["name"]][str(n)].append(rate)
                print(f"{got['name']}: {n} process(es), {got['trials']} trials in "
                      f"{got['seconds']:.4f} s = {rate:.1f} trials/s on {card_line}", flush=True)
    summary = {"card": card_line, "procs": args.procs, "rounds": args.rounds, "cases": {
        name: dict(trials_per_s=r, median_1=statistics.median(r["1"]),
                   median_n=statistics.median(r[str(args.procs)]),
                   ratio=statistics.median(r[str(args.procs)]) / statistics.median(r["1"]))
        for name, r in runs.items()}}
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        Path(args.out, "mesh_throughput.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
