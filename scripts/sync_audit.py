"""Every operation that makes the host wait for the card, in the batches of
the benchmark's cells, under ``torch.cuda.set_sync_debug_mode("warn")``.

    python3 scripts/sync_audit.py [--cells dem144_p001 cc144_p050 ...] \
        [--root DIR] [--batches 2] [--seed N] [--out FILE.json]

For each cell the engine is built as ``benchmark/run.py`` builds it, its
kernel libraries loaded and one batch run to warm it; then ``--batches``
batches of ``run_rate`` with an ``on_batch`` (the benchmark's path) run
under the sync debug mode. Each warning is put down to the innermost frame
of the package that raised it, and counted per batch between one
``on_batch`` and the next; where the package keeps
``utils.profiling.counts()``, its ``host_syncs`` a batch is printed beside
the warnings. ``--root`` imports the package and the benchmark from another
checkout (an earlier commit unpacked with ``git archive``). Needs CUDA.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import traceback
import warnings
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def audit(cell_name: str, seed: int, batches: int) -> dict:
    import torch

    from benchmark import harness

    cell = harness.load_cell(cell_name)
    p = float(cell.traffic["p"])
    engine = harness.build_engine(cell.config, "cuda")
    harness.load_kernels()
    B = engine.config.batch_size
    engine.run_rate(p, B, seed=seed)
    try:
        from qldpc_tpu_torch.utils.profiling import counts
    except ImportError:
        counts = None

    per_batch = [collections.Counter()]
    syncs = []
    root = str(Path(sys.modules["qldpc_tpu_torch"].__file__).resolve().parent.parent)

    def site(frames) -> str:
        mine = [f for f in frames if "qldpc_tpu_torch" in f.filename]
        if not mine:
            return "outside the package"
        f = mine[-1]
        return f"{Path(f.filename).resolve().relative_to(root)}:{f.lineno} {f.name}: {f.line}"

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            per_batch[-1][site(traceback.extract_stack()[:-1])] += 1

    def on_batch(b, n_batches, total):
        if counts is not None:
            syncs.append(counts().get("host_syncs", 0))
        per_batch.append(collections.Counter())

    torch.cuda.synchronize()
    before = counts().get("host_syncs", 0) if counts is not None else None
    old_show = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            engine.run_rate(p, batches * B, seed=seed + 1, on_batch=on_batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = old_show
    per_batch.pop()  # after the last on_batch: run_rate's return
    counted = None
    if counts is not None:
        marks = [before] + syncs
        counted = [b - a for a, b in zip(marks, marks[1:])]
    return {"cell": cell_name, "batch": B,
            "warnings": [sum(c.values()) for c in per_batch],
            "host_syncs": counted,
            "sites": [dict(sorted(c.items())) for c in per_batch]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+",
                    default=["dem144_p001", "dem144_p003", "cc144_p050", "cc144_p014"])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--seed", type=int, default=2**31 + 977)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("sync_audit: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"root": args.root, "card": card.strip(), "cells": []}
    for name in args.cells:
        r = audit(name, args.seed, args.batches)
        out["cells"].append(r)
        print(f"{name}: warnings a batch {r['warnings']}, host_syncs {r['host_syncs']}",
              flush=True)
        for b, sites in enumerate(r["sites"]):
            for s, n in sites.items():
                print(f"  batch {b}: {n:4d}  {s}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
