"""One run of one cell: set-up, the measured window, the traced passes, the
check against the reference, and the result line.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json``, its configuration's file, its traffic in
``benchmark/workloads/<traffic>.json``, the limits of its check in
``benchmark/limits/<cell>.json``, and each metric's reader in
``benchmark/metrics/<metric>.py``.

The window drives the engine's public ``run_rate`` as a closed loop of
batches: each batch starts when the one before it has brought its counters
to the host, and the window closes at the first batch that ends
``seconds`` after it opened. The benchmark's ``on_batch`` takes a
timestamp and keeps the running counters. Around the engine's stage calls
it keeps the outputs of the checked batches; with ``--trace 1`` it also
times the stages (each ending in a synchronize, inside a
``record_function`` span) and profiles whole batches.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import resource
import sys
import tempfile
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from benchmark import check, trace
from benchmark.reference import bp as ref_bp

ROOT = Path(__file__).resolve().parent.parent
STAGES = ("sample", "bp", "osd", "classify")
FORBIDDEN = ("jax", "jaxlib", "flax", "qldpc_tpu")


class WindowClosed(Exception):
    """Raised from ``on_batch`` to end ``run_rate`` when the window closes."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files and the
    metrics it reports (a metric with ``workloads`` lists its cells; one
    without it is reported in every cell)."""
    bench = _json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(work)}")
    w = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    mine = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    return Cell(name=name, chips=int(w["chips"]), config=_json(root / cfg["file"]),
                traffic=_json(root / "benchmark" / "workloads" / f"{w['traffic']}.json"),
                limits=_json(root / "benchmark" / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=mine)


def reader(metric: str, root: Path = ROOT):
    """The ``read(run) -> float | None`` of ``benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


# ---------------------------------------------------------------- program
def program_spec(config: dict, control: bool = False):
    """The experiment spec the CLI would run: the configuration's preset,
    its code, its settings and, for the control, its lower precision's
    spec fields."""
    from qldpc_tpu_torch.experiments.configs import get_preset

    spec = dict(config["spec"])
    if control:
        spec.update({k: v for k, v in config["control"].items() if k != "bp"})
    return get_preset(config["preset"]).replace(codes=[config["code"]["name"]], **spec)


def build_engine(config: dict, device, control: bool = False, p: float | None = None):
    """The engine as the CLI builds it (``runners.build_engine``). For a
    control that names ``bp``, the reference's BP at that precision takes
    the place of the engine's BP decoders (``ReferenceBP``; its graph is
    the configuration's decoding problem at ``p``)."""
    from qldpc_tpu_torch.experiments.runners import build_engine as build

    engine = build(program_spec(config, control), config["code"]["name"], device=device)
    if control and "bp" in config["control"]:
        if config["control"]["bp"] != "bfloat16":
            raise ValueError(f"the control's bp {config['control']['bp']!r} is not bfloat16")
        ref = check.Reference(config, p)
        graph = ref_bp.Graph(ref.H, engine.device)
        engine.bp = ReferenceBP(graph, ref.max_iter, ref.tanh_clip)
        if engine.bp_short is not None:
            engine.bp_short = ReferenceBP(graph, engine.config.rescue_iters, ref.tanh_clip)
    return engine


class ReferenceBP:
    """The control of a BP path that has no lower precision of its own
    (K6): the reference's BP with its messages kept in bfloat16, called as
    the engine calls its BP decoder, on the program's syndromes and
    priors."""

    def __init__(self, graph, max_iter: int, tanh_clip: float):
        self.graph, self.max_iter, self.tanh_clip = graph, max_iter, tanh_clip

    def __call__(self, syndromes, priors, alpha=None):
        from qldpc_tpu_torch.decoders.bp import BPResult

        post, conv, iters, hard = ref_bp.decode(self.graph, syndromes, priors, self.max_iter,
                                                self.tanh_clip, messages=torch.bfloat16)
        return BPResult(hard=hard, converged=conv, llrs=post, iterations=iters)


def load_kernels() -> int:
    """Build (first run of a checkout) and load every kernel library the
    program's imported modules hold, so that none loads inside the window.
    Returns how many."""
    from concurrent.futures import ThreadPoolExecutor

    from qldpc_tpu_torch._build import KernelLibrary

    libs = {id(v): v for mod in list(sys.modules.values())
            if getattr(mod, "__name__", "").startswith("qldpc_tpu_torch.")
            for v in vars(mod).values() if isinstance(v, KernelLibrary)}
    with ThreadPoolExecutor(max(1, len(libs))) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    for lib in libs.values():
        lib.lib
    return len(libs)


class Capture:
    """Wraps the engine's stage calls: keeps the outputs of the batches in
    ``keep`` and of the batch running when the window closes, and with
    ``spans`` puts each stage in a ``record_function`` span."""

    NAMES = {"_sample": "sample", "_decode": "bp", "_post_process": "osd",
             "_classify": "classify"}

    def __init__(self, engine, keep=(), spans: bool = False):
        self.engine, self.keep, self.spans = engine, set(keep), spans
        self.batch, self.current, self.kept = -1, {}, {}
        for name in self.NAMES:
            setattr(engine, name, self._wrap(name, getattr(engine, name)))

    def _wrap(self, name, call):
        def staged(*args, **kwargs):
            if name == "_sample":
                self.batch += 1
                self.current = {}
            if self.spans:
                with torch.profiler.record_function(f"bench.{self.NAMES[name]}"):
                    out = call(*args, **kwargs)
            else:
                out = call(*args, **kwargs)
            self._record(name, out)
            return out
        return staged

    def _record(self, name, out):
        if name == "_sample":
            self.current.update(errors=out[0], syn=out[1])
        elif name == "_decode":
            self.current.update(hard=out.hard, llrs=out.llrs, converged=out.converged,
                                iterations=out.iterations)
        elif name == "_post_process":
            self.current.update(final=out[0])

    def batch_done(self, closing: bool) -> None:
        if self.batch in self.keep or closing:
            self.kept[self.batch] = self.current
        self.current = {}

    def remove(self) -> None:
        for name in self.NAMES:
            self.engine.__dict__.pop(name, None)
        self.engine = None


def host_load() -> dict:
    """Readings in which a stall of the host shows: this process's CPU
    seconds (short of the window's length where the machine stood still)
    and the interpreter's full garbage collections."""
    use = resource.getrusage(resource.RUSAGE_SELF)
    return {"proc_cpu": use.ru_utime + use.ru_stime, "full_gcs": gc.get_stats()[2]["collections"]}


def window(engine, p: float, seed: int, seconds: float, capture: Capture | None,
           max_batches: int | None = None) -> dict:
    """Run batches of the seed's stream at ``p`` until ``seconds`` have
    passed (or ``max_batches`` have run): (t0, each batch's end, the running
    counters after the batches that the capture keeps, the closing one and
    the batch before each)."""
    stamps, totals, last = [], {}, [None]
    needed = {b - d for b in capture.keep for d in (0, 1)} if capture is not None else set()
    B = engine.config.batch_size
    sync = torch.cuda.synchronize if engine.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()

    def on_batch(b, n_batches, total):
        now = time.perf_counter()
        stamps.append(now)
        i = len(stamps) - 1
        closing = now - t0 >= seconds or len(stamps) == max_batches
        if i in needed or closing:
            totals[i] = total
        if closing and i:
            totals[i - 1] = last[0]
        last[0] = total
        if capture is not None:
            capture.batch_done(closing)
        if closing:
            raise WindowClosed

    load0 = host_load()
    try:
        engine.run_rate(p, B * 10**9, seed=seed, on_batch=on_batch)
    except WindowClosed:
        pass
    load1 = host_load()
    return {"t0": t0, "stamps": stamps, "totals": totals, "batch": B,
            "host": {k: load1[k] - load0[k] for k in load1}}


def batch_counters(totals: dict, b: int) -> dict:
    """Batch b's own counters, from the running totals after b and b - 1."""
    now = totals[b]._asdict()
    before = totals[b - 1]._asdict() if b else None
    return {k: (v - before[k] if before else v).numpy() for k, v in now.items()}


@contextmanager
def profiled(device):
    """A torch.profiler session; yields a dict that gets the trace's events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = {}
    with torch.profiler.profile(activities=acts) as prof:
        yield out
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        out["events"] = trace.load(path)
    finally:
        os.unlink(path)


def stage_pass(engine, p: float, seed: int, reps: int) -> dict:
    """The engine's four stages on ``reps`` batches of the seed's stream,
    each ending in a synchronize inside a span of its own (the arithmetic
    of ``MonteCarloEngine.stage_times``): each stage's host ms per batch,
    BP's work, and the trace."""
    from qldpc_tpu_torch.utils import rng

    sync = torch.cuda.synchronize if engine.device.type == "cuda" else (lambda: None)
    a32 = float(np.float32(engine.config.bp.alpha))
    kp = rng.fold_in(rng.key(seed), hash(p) % (2**31))
    valid = torch.ones(engine.local_batch, dtype=torch.bool, device=engine.device)
    ms = {s: [] for s in STAGES}
    work = []
    with profiled(engine.device) as prof:
        for b in range(reps):
            t = [time.perf_counter()]
            with torch.profiler.record_function("bench.sample"):
                errors, syn, priors = engine._sample(rng.fold_in(kp, b), p)
                sync()
            t.append(time.perf_counter())
            with torch.profiler.record_function("bench.bp"):
                res = engine._decode(syn, priors, a32)
                sync()
            t.append(time.perf_counter())
            with torch.profiler.record_function("bench.osd"):
                final = engine._post_process(syn, res)[0]
                sync()
            t.append(time.perf_counter())
            with torch.profiler.record_function("bench.classify"):
                engine._classify(errors, final, syn, res, valid)
                sync()
            t.append(time.perf_counter())
            for s, d in zip(STAGES, np.diff(t) * 1e3):
                ms[s].append(float(d))
            work.append({"batch": int(syn.shape[0]),
                         "iterations_run": int((res.iterations.to(torch.int64) + 1).sum()),
                         "syndrome_bytes": syn.numel() * syn.element_size(),
                         "prior_bytes": priors.shape[-1] * priors.element_size()})
    return {"ms": ms, "bp_work": work, "events": prof["events"]}


def idle_pass(engine, p: float, seed: int, batches: int) -> dict:
    """``batches`` whole batches of ``run_rate`` under the profiler, each
    stage in a span: the trace and the traced window."""
    capture = Capture(engine, spans=True)
    try:
        with profiled(engine.device) as prof:
            with torch.profiler.record_function("bench.window"):
                engine.run_rate(p, batches * engine.config.batch_size, seed=seed,
                                on_batch=lambda *_: None)
    finally:
        capture.remove()
    events = prof["events"]
    lo, hi = trace.spans(events, "bench.window")[0]
    return {"events": events, "lo": lo, "hi": hi}


# -------------------------------------------------------------------- run
def draw_checked(seed: int, traffic: dict) -> list[int]:
    """The batches whose outputs the check compares, drawn from the seed
    among the window's first ``within_first`` (the batch running when the
    window closes is checked too)."""
    c = traffic["check"]
    rs = np.random.default_rng(seed)
    return sorted(int(b) for b in rs.choice(c["within_first"], size=c["drawn"], replace=False))


def run(cell: Cell, seed: int, seconds: float, traced: bool, device="cuda",
        t_start: float | None = None, control: bool = False, log=print) -> dict:
    """One run; returns the result object (``correct``, ``metrics``, ...)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    on_card = device.type == "cuda"
    p = float(cell.traffic["p"])
    t = [time.perf_counter()]
    engine = build_engine(cell.config, device, control=control, p=p)
    t.append(time.perf_counter())
    if on_card:
        load_kernels()
    t.append(time.perf_counter())
    engine.run_rate(p, engine.config.batch_size, seed=seed)  # warm-up: one batch
    t.append(time.perf_counter())
    log(f"set-up: to the engine build {t[0] - t_start:.3f} s, engine {t[1] - t[0]:.3f} s, "
        f"kernel libraries {t[2] - t[1]:.3f} s, warm batch {t[3] - t[2]:.3f} s")
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    checked = draw_checked(seed, cell.traffic)
    capture = Capture(engine, keep=checked)
    run_info: dict = {"p": p, "device": device.type}
    try:
        win = window(engine, p, seed, seconds, capture)
    finally:
        capture.remove()
    run_info["setup_s"] = win["t0"] - t_start
    run_info["window"] = win
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    run_info["peak_window_bytes"] = window_peak if on_card else None
    memory_peak = max(setup_peak, window_peak)

    t_ref = time.perf_counter()
    ref = check.Reference(cell.config, p)
    run_info["graph"] = {"m": ref.m, "n": ref.n, "edges": ref.edges}
    if traced:
        try:
            run_info["stages"] = stage_pass(engine, p, seed, int(cell.traffic["stage_reps"]))
        except AttributeError as err:  # the engine no longer has a stage
            log(f"stage pass skipped: {err}")
            run_info["stages"] = None
        run_info["idle"] = idle_pass(engine, p, seed, int(cell.traffic["idle_batches"]))
    trials = win["batch"] * len(win["stamps"])

    del engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref.place(device)
    kept = capture.kept
    counters = {b: batch_counters(win["totals"], b) for b in kept}
    ref_s: dict = {}
    numbers = check.compare(ref, seed, kept, counters, ref_s)
    ends = np.array(win["stamps"]) - win["t0"]
    quarters = [int(((ends > q * ends[-1] / 4) & (ends <= (q + 1) * ends[-1] / 4)).sum())
                for q in range(4)]
    gaps = np.diff(np.concatenate([[0.0], ends]))
    host = win["host"]
    log(f"window quarters: batches {quarters}; batch gaps: median {np.median(gaps) * 1e3:.2f} ms, "
        f"longest {gaps.max() * 1e3:.2f} ms, over twice the median {int((gaps > 2 * np.median(gaps)).sum())}")
    log(f"window host: this process's CPU {host['proc_cpu']:.3f} s, {host['full_gcs']} full "
        f"collections; {len(os.sched_getaffinity(0))} CPUs, {torch.get_num_threads()} torch threads")
    log(f"window {win['stamps'][-1] - win['t0']:.3f} s, {len(win['stamps'])} batches; "
        f"reference and check {time.perf_counter() - t_ref:.3f} s (traced passes included; "
        f"by stage {', '.join(f'{k} {v:.3f}' for k, v in ref_s.items())})")
    limits = cell.limits["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NUMBERS}
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(m["name"])(run_info)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": trials, "failed": 0, "metrics": metrics,
              "device": device_info(device, memory_peak, run_info if traced else None)}
    if traced:
        result["breakdown"] = breakdown(run_info["idle"])
    result["checked_batches"] = sorted(kept)
    result["checks"] = checks
    return result


def device_info(device, memory_peak: int, run_info: dict | None) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": int(memory_peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if run_info is not None:
        idle = run_info["idle"]
        ops = trace.device_ops(idle["events"])
        info["busy_s"] = trace.busy(ops, idle["lo"], idle["hi"]) * 1e-6
        info["window_s"] = (idle["hi"] - idle["lo"]) * 1e-6
    return info


def breakdown(idle: dict) -> dict:
    """The traced window's ten costliest device operations by name and its
    ten longest idle gaps, named by what the host was doing."""
    events, lo, hi = idle["events"], idle["lo"], idle["hi"]
    ops = trace.device_ops(events)
    gaps = trace.gaps(ops, lo, hi)[:10]
    return {"device_ops": [[n, s] for n, s in trace.by_name(ops, lo, hi)[:10]],
            "idle_gaps": [[trace.host_at(events, (a + b) / 2), (b - a) * 1e-6] for a, b in gaps]}

