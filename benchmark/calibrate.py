"""Readings of the check's numbers over many seeds, for setting its limits.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        [--first-seed N] [--out FILE]

In one process: the cell's engine as configured, then its control (the
configuration's lower precision: the program's own bf16 path, or, where
the path has none, the reference's BP with bfloat16 messages in its
place), each warmed once; for every seed the window's first
``within_first`` batches (the traffic file's), the checked batches kept
as a run keeps them, and
the comparison with the reference. One JSON line a seed, on standard
output and in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(cell, engine, ref, seeds, control: bool, out) -> None:
    from benchmark import check, harness

    p = float(cell.traffic["p"])
    for seed in seeds:
        t0 = time.perf_counter()
        capture = harness.Capture(engine, keep=harness.draw_checked(seed, cell.traffic))
        try:
            win = harness.window(engine, p, seed, float("inf"), capture,
                                 max_batches=int(cell.traffic["check"]["within_first"]))
        finally:
            capture.remove()
        t1 = time.perf_counter()
        counters = {b: harness.batch_counters(win["totals"], b) for b in capture.kept}
        numbers = check.compare(ref, seed, capture.kept, counters)
        line = {"workload": cell.name, "control": control, "seed": seed,
                "batches": sorted(capture.kept), "numbers": numbers,
                "program_s": t1 - t0, "check_s": time.perf_counter() - t1}
        print(json.dumps(line), flush=True)
        if out is not None:
            out.write(json.dumps(line) + "\n")
            out.flush()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from benchmark import check, harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    p = float(cell.traffic["p"])
    ref = check.Reference(cell.config, p)
    ref.place(torch.device("cuda"))
    out = open(args.out, "a") if args.out else None
    seeds = [args.first_seed + i for i in range(args.seeds + args.control_seeds)]
    for control, chosen in ((False, seeds[:args.seeds]), (True, seeds[args.seeds:])):
        if not chosen:
            continue
        engine = harness.build_engine(cell.config, torch.device("cuda"), control=control,
                                      p=p)
        harness.load_kernels()
        engine.run_rate(p, engine.config.batch_size, seed=chosen[0])
        readings(cell, engine, ref, chosen, control, out)
        del engine
        torch.cuda.empty_cache()
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
