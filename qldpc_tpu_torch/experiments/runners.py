"""Experiment runners: turn an ExperimentSpec into engine sweeps + artifacts.

Port of qldpc_tpu/experiments/runners.py over the port's engines on one
device (the card by default, the CPU when asked for), or on a process mesh
(``mesh=``, one device a process): every process of the mesh returns the
same results, and process 0 alone prints and writes the archives, plots and
checkpoints. The results dict, the npz archives (ours and the reference's
schema) and the plots are the JAX runner's.

The spec's fields that only pick a TPU code path (``bp_backend``,
``bp_batch_tile``, ``bp_chunk_size``, ``osd_backend`` other than
``factored``) are dropped, as ``convert.py`` drops them from a JAX config:
the tensor's device picks the path. A field that
would change the numerics refuses before any engine is built:
``bp_mm_dtype="bfloat16"``. ``estimate_alpha`` fits Alvarado's alpha per
rate (``decoders.alvarado.estimate_alpha`` on the device, float32 draws as
the JAX CLI makes them) and runs the rate with it, as the JAX runner does;
each process of a mesh fits it itself, from the same keyed draws.
``bp_stream_dtype="bfloat16"`` is not ported: such a spec runs with float32
streams, says so on stderr, and its archived spec says ``float32``.
Circuit-level specs run the DEM engine at the spec's batch size (the JAX
runner's clamp guards a TPU's memory).
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from qldpc_tpu_torch.codes import get_code
from qldpc_tpu_torch.convert import bp_config_from_reference, osd_config_from_reference
from qldpc_tpu_torch.decoders.alvarado import estimate_alpha
from qldpc_tpu_torch.decoders.bp import BPConfig, BPDecoder
from qldpc_tpu_torch.decoders.osd import OSDConfig
from qldpc_tpu_torch.mc import (
    CheckpointManager,
    DEMEngine,
    DEMEngineConfig,
    EngineConfig,
    MonteCarloEngine,
    counters_to_dict,
)
from qldpc_tpu_torch.mc.engine import engine_device
from qldpc_tpu_torch.noise.circuit import parametric_memory_dem
from qldpc_tpu_torch.parallel.mesh import Mesh, make_mesh
from qldpc_tpu_torch.utils import plotting, rng
from qldpc_tpu_torch.utils.profiling import PhaseTimer

from .configs import ExperimentSpec

__all__ = ["run_experiment", "build_engine"]


def check_spec(spec: ExperimentSpec, warn: bool = True) -> ExperimentSpec:
    """Refuse what the port cannot run as asked, before any engine is built;
    returns the spec the port runs (float32 streams), saying so on stderr
    where ``warn``."""
    if spec.bp_stream_dtype != "float32" and warn:
        print(
            f"[{spec.name}] bp_stream_dtype={spec.bp_stream_dtype!r} is not "
            "ported: running float32 streams",
            file=sys.stderr, flush=True,
        )
    spec = spec.replace(bp_stream_dtype="float32")
    _bp_config(spec)  # raises for a bp_mm_dtype other than float32
    return spec


# The JAX runner's configs, field by field (qldpc_tpu/experiments/runners.py
# _bp_config, _osd_config): convert.py drops the TPU selectors and refuses
# what would change the numerics, for a spec as for a JAX config.
def _bp_config(spec: ExperimentSpec, max_iter=None, alpha=None) -> BPConfig:
    return bp_config_from_reference(dict(
        max_iter=max_iter if max_iter is not None else spec.bp_max_iter,
        method=spec.bp_method,
        alpha=alpha if alpha is not None else spec.alpha,
        offset=spec.offset,
        damping=spec.damping,
        clip_llr=spec.clip_llr,
        chunk_size=spec.bp_chunk_size,
        schedule=spec.bp_schedule,
        n_layers=spec.bp_layers,
        backend=spec.bp_backend,
        batch_tile=spec.bp_batch_tile,
        stream_dtype=spec.bp_stream_dtype,
        mm_dtype=spec.bp_mm_dtype,
    ))


def _osd_config(spec: ExperimentSpec, order=None) -> OSDConfig | None:
    order = order if order is not None else spec.osd_order
    if order is None:
        return None
    return osd_config_from_reference(dict(
        order=order, max_combinations=spec.osd_max_combinations, backend=spec.osd_backend,
    ))


def build_engine(
    spec: ExperimentSpec, code_name: str, device="cuda", max_iter=None,
    alpha=None, osd_order=None, timer: PhaseTimer | None = None, mesh: Mesh | None = None,
) -> MonteCarloEngine:
    device = engine_device(device)
    code = get_code(code_name)
    if spec.channel == "circuit-level":
        # studyComplete.py:72-109 in-repo: a parametric memory-experiment
        # DEM (Z basis, rounds = distance like the reference) decoded by
        # DEMEngine; its priors are a function of p, so one engine serves
        # the code's whole rate grid
        timer = timer or PhaseTimer()
        with timer.phase("dem-build"):
            pdem = parametric_memory_dem(
                code, basis="z", rounds=spec.n_rounds or code.distance
            )
        return DEMEngine(
            pdem,
            DEMEngineConfig(
                bp=_bp_config(spec, max_iter=max_iter, alpha=alpha),
                osd=_osd_config(spec, order=osd_order),
                batch_size=spec.batch_size,
                osd_fraction=spec.osd_fraction,
            ),
            device=device,
            name=code_name,
            mesh=mesh,
        )
    return MonteCarloEngine(
        code,
        EngineConfig(
            bp=_bp_config(spec, max_iter=max_iter, alpha=alpha),
            osd=_osd_config(spec, order=osd_order),
            channel=spec.channel,
            n_rounds=spec.n_rounds,
            syndrome_flip_rate=spec.syndrome_flip_rate,
            batch_size=spec.batch_size,
            osd_fraction=spec.osd_fraction,
        ),
        device=device,
        mesh=mesh,
    )


def _llr_histograms(
    spec: ExperimentSpec, code_name: str, p: float, max_iter, alpha,
    seed: int = 0, batch: int = 2048, bins: int = 80, lim: float = 40.0,
    device="cuda",
):
    """Histogram posterior LLRs by true bit value (BP_per_Iteration.py's
    violin source data, binned): the errors are ``jax.random.bernoulli``'s
    under ``key(seed + 999)``, float32 as JAX draws them by default."""
    device = engine_device(device)
    code = get_code(code_name)
    H = code.Hx
    n = code.n
    dec = BPDecoder(H, _bp_config(spec, max_iter=max_iter, alpha=alpha)).to(device)
    errors = rng.bernoulli(rng.key(seed + 999), p, (batch, n), device=device)
    Hf = torch.tensor(np.asarray(H) % 2, dtype=torch.float32, device=device)
    syn = torch.remainder(errors.to(torch.float32) @ Hf.T, 2.0).to(torch.int8)
    prior = torch.full((n,), float(np.log((1 - p) / p)), dtype=torch.float32,
                       device=device)
    res = dec(syn, prior)
    llrs = res.llrs.cpu().numpy().ravel()
    bit = errors.cpu().numpy().ravel()
    edges = np.linspace(-lim, lim, bins + 1)
    h0, _ = np.histogram(np.clip(llrs[bit == 0], -lim, lim), bins=edges)
    h1, _ = np.histogram(np.clip(llrs[bit == 1], -lim, lim), bins=edges)
    return {"edges": edges, "true_0": h0, "true_1": h1}


def run_experiment(
    spec: ExperimentSpec, device="cuda", verbose: bool = True,
    checkpoint: bool = True, mesh: Mesh | None = None,
) -> dict:
    """Run a sweep and write <output_dir>/<name>.npz + plots.

    Returns the results dict: {code_name: {p: metrics_dict}} plus sweep
    metadata under "_meta". ``device`` is this process's one device (the
    card by default, or "cpu"); a list of devices raises. ``mesh`` (default
    ``parallel.make_mesh()``) shards every batch over its processes, as the
    JAX runner's ``mesh`` does; only its process 0 prints and writes.
    """
    device = engine_device(device)
    mesh = mesh if mesh is not None else make_mesh()
    lead = mesh.rank == 0
    verbose = verbose and lead
    spec = check_spec(spec, warn=lead)
    out = Path(spec.output_dir)
    if lead:
        out.mkdir(parents=True, exist_ok=True)
    ckpt = CheckpointManager(out / f"{spec.name}_ckpt") if checkpoint else None
    timer = PhaseTimer()

    results: dict = {}
    t0 = time.time()
    total_trials = 0
    for code_name in spec.codes:
        rates = [float(p) for p in spec.rates_for(code_name)]
        results[code_name] = {}
        iter_grid = spec.max_iter_grid or [None]
        order_grid = spec.osd_order_grid or [None]
        for max_iter in iter_grid:
          for osd_order in order_grid:
            # p and a fitted alpha enter per call, so one engine serves the
            # code's rate grid
            eng = None
            for i, p in enumerate(rates):
                alpha = None
                if spec.estimate_alpha:
                    with timer.phase("alpha-estimation"):
                        alpha = estimate_alpha(
                            get_code(code_name).Hx, p, method=spec.bp_method,
                            seed=spec.seed + 17 * i, device=device,
                        )
                if eng is None:
                    with timer.phase("engine-build"):
                        eng = build_engine(
                            spec, code_name, device=device, max_iter=max_iter,
                            osd_order=osd_order, timer=timer, mesh=mesh,
                        )
                with timer.phase("sweep"):
                    if ckpt is not None:
                        counters = ckpt.run_rate(eng, p, spec.trials, spec.seed + i,
                                                 alpha=alpha)
                    else:
                        counters = eng.run_rate(p, spec.trials, seed=spec.seed + i,
                                                alpha=alpha)
                d = counters_to_dict(counters)
                if alpha is not None:
                    d["alpha"] = alpha
                if spec.osd_order_grid:
                    key = (max_iter, osd_order, p)
                elif max_iter is not None:
                    key = (max_iter, p)
                else:
                    key = p
                if spec.max_iter_grid and not spec.osd_order_grid:
                    # LLR-distribution diagnostics (the violin data of
                    # BP_per_Iteration.py): posterior LLRs of one batch,
                    # split by the true bit value, as fixed-bin histograms
                    d["llr_hist"] = _llr_histograms(
                        spec, code_name, p, max_iter, alpha, seed=spec.seed,
                        device=device,
                    )
                results[code_name][key] = d
                total_trials += d["trials"]
                if verbose:
                    extra = f" it={max_iter}" if max_iter is not None else ""
                    print(
                        f"[{spec.name}] {code_name}{extra} p={p:.5g}: "
                        f"ler={d['ler']:.5g} osd={d['osd']:.4g} "
                        f"avg_iters={d['average_iterations']:.2f}",
                        flush=True,
                    )

    wall = time.time() - t0
    results["_meta"] = {
        "spec": json.loads(spec.to_json()),
        "wall_time_s": wall,
        "throughput_trials_per_s": total_trials / max(wall, 1e-9),
    }
    if lead:
        _save_and_plot(spec, results, out, verbose)
    if verbose:
        print(timer.report())
        print(f"[{spec.name}] total {total_trials} trials in {wall:.1f}s "
              f"({total_trials/max(wall,1e-9):.0f}/s)")
    return results


def _save_and_plot(spec: ExperimentSpec, results: dict, out: Path, verbose: bool) -> None:
    np.savez(
        out / f"{spec.name}.npz",
        results=np.array(results, dtype=object),
        allow_pickle=True,
    )
    _save_reference_format(spec, results, out)
    if importlib.util.find_spec("matplotlib") is None:
        if verbose:
            print(f"[{spec.name}] matplotlib is not installed: no plots", flush=True)
        return
    _plot_results(spec, results, out)


def _save_reference_format(spec: ExperimentSpec, results: dict, out: Path) -> None:
    """Also emit the reference's archive schema (studies/study.py:105):
    ``physicalErrorRates`` + ``results`` = {code: {ler, BPs_fault,
    BPs_miscorrected, incorrectable, degeneracies}} so reference analysis
    scripts (loadResults.py style) consume our output unchanged.

    Only applies to common-grid, single-max_iter sweeps (the schema has no
    room for iteration grids or per-code rate grids); other specs still get
    the native npz + plots from :func:`_plot_results`."""
    codes = [c for c in results if c != "_meta"]
    if not codes or spec.max_iter_grid or spec.osd_order_grid:
        return
    rates0 = sorted(results[codes[0]])
    if not all(sorted(results[c]) == rates0 for c in codes):
        return  # per-code grids don't fit the common-grid schema
    ref = {}
    for c in codes:
        ref[c] = {
            "ler": [results[c][p]["ler"] for p in rates0],
            "BPs_fault": [results[c][p]["BPs_fault"] for p in rates0],
            "BPs_miscorrected": [results[c][p]["BPs_miscorrected"] for p in rates0],
            "incorrectable": [results[c][p]["incorrectable"] for p in rates0],
            "degeneracies": [results[c][p]["degeneracy_count"] for p in rates0],
        }
    np.savez(
        out / f"{spec.name}_reference_format.npz",
        physicalErrorRates=np.array(rates0),
        results=np.array(ref, dtype=object),
    )


def _plot_results(spec: ExperimentSpec, results: dict, out: Path) -> None:
    codes = [c for c in results if c != "_meta"]
    if not codes:
        return
    if spec.osd_order_grid:
        # (bp_iter x osd_order) configuration panels, one per (code, config)
        # (rework/main_different_orders.py's comparison plot)
        panels = {}
        for c in codes:
            for (mi, w, p), d in sorted(results[c].items()):
                panels.setdefault(f"{c} BP{mi}·OSD{w}", {})[p] = d
        plotting.plot_rework_panels(
            panels, path=out / f"{spec.name}_panels.png", title=spec.name
        )
        return
    if spec.max_iter_grid:
        # LER vs max_iter (BP_per_Iteration plot)
        import collections

        curves = {}
        for c in codes:
            by_iter = collections.defaultdict(list)
            for (mi, p), d in results[c].items():
                by_iter[mi].append(d["ler"])
            curves[c] = np.array([np.mean(by_iter[mi]) for mi in spec.max_iter_grid])
        plotting.plot_ler_curves(
            curves, spec.max_iter_grid, path=out / f"{spec.name}_ler_vs_iters.png",
            title=f"{spec.name}: LER vs BP iterations",
        )
        return

    rates = {c: sorted(results[c]) for c in codes}
    lers = {c: np.array([results[c][p]["ler"] for p in rates[c]]) for c in codes}
    # per-code rate grids can differ; plot on each code's own grid
    first = codes[0]
    if all(rates[c] == rates[first] for c in codes):
        plotting.plot_ler_curves(
            lers, rates[first], path=out / f"{spec.name}_ler.png", title=spec.name
        )
        per_code = {
            c: {
                k: np.array([results[c][p][k] for p in rates[c]])
                for k in ("BPs_fault", "BPs_miscorrected", "incorrectable")
            }
            for c in codes
        }
        plotting.plot_failure_decomposition(
            per_code, rates[first], path=out / f"{spec.name}_failures.png"
        )
        deg = {
            c: np.array([results[c][p]["degeneracy_count"] for p in rates[c]])
            for c in codes
        }
        plotting.plot_degeneracies(
            deg, rates[first], path=out / f"{spec.name}_degeneracies.png"
        )
    else:
        rework_style = {
            c: {p: results[c][p] for p in rates[c]} for c in codes
        }
        plotting.plot_rework_panels(
            rework_style, path=out / f"{spec.name}_panels.png", title=spec.name
        )
    # weight histograms (spectrum / rework plots)
    dists = {c: get_code(c).distance for c in codes}
    for key, suffix in [("weights_found_BP", "BP"), ("weights_found_OSD", "OSD")]:
        hists = {
            c: np.sum([results[c][p][key] for p in rates[c]], axis=0) for c in codes
        }
        if any(h.sum() for h in hists.values()):
            plotting.plot_weight_histograms(
                hists, dists, path=out / f"{spec.name}_weights_{suffix}.png",
                suffix=f"({suffix})",
            )
