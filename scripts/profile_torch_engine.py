"""Where the port's Monte-Carlo engine spends its time on one CUDA device.

    python3 scripts/profile_torch_engine.py [--code "[[144, 12, 12]]"] \
        [--batch 65536] [--p 0.01 0.050119] [--out DIR]
    python3 scripts/profile_torch_engine.py --dem --code "[[72, 12, 6]]" \
        --batch 1024 --p 0.001 0.002
    python3 scripts/profile_torch_engine.py --spacetime --batch 512 \
        --max-iter 100 --p 0.004 0.008
    python3 scripts/profile_torch_engine.py --schedule layered --p 0.050119

Code capacity by default; with ``--dem`` the circuit-level DEM engine on the
code's Z-basis memory-experiment DEM, with ``--spacetime`` the space-time
channel (``--rounds``, default the distance, for either); ``--schedule
layered`` runs BP check-serially. For each error rate: the wall time of each
stage of one batch (sampling, BP, OSD-0 post-processing, classification),
each ending in a device synchronize, and a torch.profiler trace of one whole
``run_rate`` with the device time summed by kernel, the device's busy share
of the wall time and the BP kernel's share of the device time. With
``--out`` the report also goes to ``DIR/profile_torch_engine.txt``.
Needs CUDA; imports no JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from qldpc_tpu_torch.codes import get_code  # noqa: E402
from qldpc_tpu_torch.decoders import BPConfig, OSDConfig  # noqa: E402
from qldpc_tpu_torch.mc import (  # noqa: E402
    DEMEngine,
    DEMEngineConfig,
    EngineConfig,
    MonteCarloEngine,
)
from qldpc_tpu_torch.noise.circuit import parametric_memory_dem  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--code", default="[[144, 12, 12]]")
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--p", type=float, nargs="+", default=[0.01, 0.050119])
    ap.add_argument("--out", default=None)
    ap.add_argument("--dem", action="store_true")
    ap.add_argument("--spacetime", action="store_true")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--schedule", default="flooding", choices=["flooding", "layered"])
    ap.add_argument("--max-iter", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_engine: needs a CUDA device", file=sys.stderr)
        return 1
    code = get_code(args.code)
    kw = dict(bp=BPConfig(max_iter=args.max_iter, schedule=args.schedule),
              osd=OSDConfig(order=0), batch_size=args.batch)
    if args.dem:
        dem = parametric_memory_dem(code, basis="z", rounds=args.rounds or code.distance)
        eng = DEMEngine(dem, DEMEngineConfig(**kw), device="cuda", name=args.code)
        bp_kernels = ("dem_",)
    elif args.spacetime:
        eng = MonteCarloEngine(code, EngineConfig(channel="space-time", n_rounds=args.rounds or 0,
                                                  **kw), device="cuda")
        bp_kernels = ("st_bp_kernel",)
    else:
        eng = MonteCarloEngine(code, EngineConfig(**kw), device="cuda")
        bp_kernels = ("bp_layered_",) if args.schedule == "layered" else ("bp_flooding_",)
    eng.run_rate(args.p[0], args.batch)  # build the kernels, warm the allocator
    report = []
    for p in args.p:
        st = eng.stage_times(p)
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
        # a template kernel's name starts with its return type
        bp_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA
                    and e.key.removeprefix("void ").startswith(bp_kernels))
        line = (f"p={p} run_rate({trials}): wall {wall * 1e3:.3f} ms, device busy "
                f"{dev_us / 1e3:.3f} ms ({100 * dev_us / 1e6 / wall:.1f}% of wall); BP kernel "
                f"{bp_us / 1e3:.3f} ms ({100 * bp_us / max(dev_us, 1e-9):.1f}% of device time)")
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
