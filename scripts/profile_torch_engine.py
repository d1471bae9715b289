"""Where the port's Monte-Carlo engine spends its time on one CUDA device.

    python3 scripts/profile_torch_engine.py [--code "[[144, 12, 12]]"] \
        [--batch 65536] [--p 0.01 0.050119] [--out DIR]

For each error rate: the wall time of each stage of one batch (sampling,
BP, OSD-0 post-processing, classification), each ending in a device
synchronize, and a torch.profiler trace of one whole ``run_rate`` with the
device time summed by kernel and the device's busy share of the wall time.
With ``--out`` the report also goes to ``DIR/profile_torch_engine.txt``.
Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from qldpc_tpu.codes import get_code  # noqa: E402
from qldpc_tpu_torch.decoders import BPConfig, OSDConfig  # noqa: E402
from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine  # noqa: E402
from qldpc_tpu_torch.utils import rng  # noqa: E402


def stage_times(eng: MonteCarloEngine, p: float, reps: int = 5) -> dict:
    """Median wall milliseconds of each stage of one batch."""
    a32 = float(np.float32(eng.config.bp.alpha))
    rows = []
    for b in range(reps + 1):  # the first batch warms the caches
        key = rng.fold_in(rng.fold_in(rng.key(0), hash(p) % 2**31), b)
        t = [time.perf_counter()]
        errors, syn, priors = eng._sample(key, p)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        bp_res = eng.bp(syn, priors, alpha=a32)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        final, _ = eng._post_process(syn, bp_res)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        valid = torch.ones(eng.config.batch_size, dtype=torch.bool, device=eng.device)
        eng._classify(errors, final, syn, bp_res, valid)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        rows.append(np.diff(t) * 1e3)
    med = np.median(np.array(rows[1:]), axis=0)
    return dict(zip(("sample", "bp", "osd", "classify"), med.tolist()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--code", default="[[144, 12, 12]]")
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--p", type=float, nargs="+", default=[0.01, 0.050119])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_engine: needs a CUDA device", file=sys.stderr)
        return 1
    eng = MonteCarloEngine(
        get_code(args.code),
        EngineConfig(bp=BPConfig(max_iter=50), osd=OSDConfig(order=0),
                     batch_size=args.batch),
        device="cuda",
    )
    eng.run_rate(args.p[0], args.batch)  # build the kernels, warm the allocator
    report = []
    for p in args.p:
        st = stage_times(eng, p)
        total = sum(st.values())
        line = (f"p={p} batch={args.batch}: " + ", ".join(
            f"{k} {v:.3f} ms ({100 * v / total:.1f}%)" for k, v in st.items())
            + f"; total {total:.3f} ms = {args.batch / total * 1e3:.0f} trials/s")
        print(line, flush=True)
        report.append(line)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        trials = 4 * args.batch
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            eng.run_rate(p, trials, seed=1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        # kernels carry the device time; the aten ops above them repeat it
        dev_us = sum(e.self_device_time_total for e in events
                     if e.device_type == DeviceType.CUDA)
        line = (f"p={p} run_rate({trials}): wall {wall * 1e3:.3f} ms, device busy "
                f"{dev_us / 1e3:.3f} ms ({100 * dev_us / 1e6 / wall:.1f}% of wall)")
        print(line, flush=True)
        report.append(line)
        table = events.table(sort_by="self_device_time_total", row_limit=25)
        report.append(table)
        print(table, flush=True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "profile_torch_engine.txt").write_text("\n".join(report) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
