"""Command-line interface of the port: the JAX package's CLI.

    python -m qldpc_tpu_torch.experiments.cli run study --trials 1000 --out results/
    python -m qldpc_tpu_torch.experiments.cli run complete-bposd --codes "[[90, 8, 10]]"
    python -m qldpc_tpu_torch.experiments.cli presets
    python -m qldpc_tpu_torch.experiments.cli run --config my_experiment.json
    python -m qldpc_tpu_torch.experiments.cli run study --device cpu --codes steane
    torchrun --standalone --nproc-per-node 2 -m qldpc_tpu_torch.experiments.cli run study

The same parser and subcommands as qldpc_tpu/experiments/cli.py, plus
``--device``: the card (``cuda``, the default; without one the run raises)
or ``cpu``, which runs the plain torch versions of the kernels. A spec JSON
written by the JAX CLI runs unchanged.

Under ``torchrun`` (``WORLD_SIZE`` set) every process joins the gloo group,
takes its card from ``parallel.rank_device()`` for ``--device cuda`` (or
the device named), and runs its slice of each batch on the world's 1-D
mesh; process 0 alone prints and writes. Like the JAX CLI it has no flag
for this.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch.distributed as dist

from qldpc_tpu_torch.mc.engine import engine_device
from qldpc_tpu_torch.parallel.mesh import init_distributed, make_mesh, rank_device

from .configs import PRESETS, ExperimentSpec, get_preset
from .runners import run_experiment


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qldpc-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("presets", help="list experiment presets")

    r = sub.add_parser("run", help="run an experiment preset or config file")
    r.add_argument("preset", nargs="?", default=None, help="preset name")
    r.add_argument("--config", help="JSON config file (overrides preset)")
    r.add_argument("--codes", nargs="+", help="restrict to these codes")
    r.add_argument("--trials", type=int)
    r.add_argument("--batch-size", type=int)
    r.add_argument("--seed", type=int)
    r.add_argument("--error-rates", nargs="+", type=float)
    r.add_argument("--max-iter", type=int, help="BP max iterations")
    r.add_argument("--chunk-size", type=int, help="BP early-exit chunk")
    r.add_argument("--osd-order", type=int)
    r.add_argument("--bp-only", action="store_true", help="disable OSD")
    r.add_argument("--out", help="output directory")
    r.add_argument("--no-checkpoint", action="store_true")
    r.add_argument("--quiet", action="store_true")
    r.add_argument(
        "--trace",
        metavar="DIR",
        help="record a torch.profiler trace of the run into DIR "
        "(DIR/trace.json, a Chrome trace: chrome://tracing or Perfetto)",
    )
    r.add_argument(
        "--device",
        default="cuda",
        help="the device to run on: cuda (the default, raises without a "
        "card), cuda:N or cpu",
    )
    r.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="FIELD=VALUE",
        dest="overrides",
        help="override any ExperimentSpec field (repeatable; value parsed "
        "as JSON, bare words as strings) — e.g. --set bp_method=min-sum "
        "--set offset=0.3",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "presets":
        for name, spec in PRESETS.items():
            print(f"{name:16s} channel={spec.channel:16s} trials={spec.trials} "
                  f"bp={spec.bp_method}({spec.bp_max_iter}) osd={spec.osd_order}")
        return 0

    if args.config:
        spec = ExperimentSpec.from_json(args.config)
    elif args.preset:
        spec = get_preset(args.preset)
    else:
        print("error: provide a preset name or --config", file=sys.stderr)
        return 2

    overrides = {}
    if args.codes:
        overrides["codes"] = args.codes
    if args.trials is not None:
        overrides["trials"] = args.trials
    if args.batch_size is not None:
        overrides["batch_size"] = args.batch_size
    if args.seed is not None:
        overrides["seed"] = args.seed
    if args.error_rates:
        overrides["error_rates"] = args.error_rates
        overrides["per_code_rates"] = None
    if args.max_iter is not None:
        overrides["bp_max_iter"] = args.max_iter
    if args.chunk_size is not None:
        overrides["bp_chunk_size"] = args.chunk_size
    if args.osd_order is not None:
        overrides["osd_order"] = args.osd_order
    if args.bp_only:
        overrides["osd_order"] = None
    if args.out:
        overrides["output_dir"] = args.out
    if args.overrides:
        import dataclasses
        import json as _json

        known = {f.name for f in dataclasses.fields(ExperimentSpec)}
        for item in args.overrides:
            key, sep, raw = item.partition("=")
            if not sep or key not in known:
                print(
                    f"error: --set {item!r}: expected FIELD=VALUE with FIELD "
                    f"one of {sorted(known)}",
                    file=sys.stderr,
                )
                return 2
            try:
                overrides[key] = _json.loads(raw)
            except _json.JSONDecodeError:
                overrides[key] = raw  # bare string (e.g. min-sum)
    spec = spec.replace(**overrides)
    if "WORLD_SIZE" not in os.environ:
        _run(args, spec, engine_device(args.device), mesh=None)
        return 0
    init_distributed()
    try:
        device = rank_device() if args.device == "cuda" else engine_device(args.device)
        _run(args, spec, device, make_mesh())
    finally:
        dist.destroy_process_group()
    return 0


def _run(args, spec: ExperimentSpec, device, mesh) -> None:
    run = lambda: run_experiment(spec, device=device, verbose=not args.quiet,
                                 checkpoint=not args.no_checkpoint, mesh=mesh)
    if args.trace and (mesh is None or mesh.rank == 0):
        from qldpc_tpu_torch.utils.profiling import trace

        with trace(args.trace):
            run()
    else:
        run()


if __name__ == "__main__":
    raise SystemExit(main())
