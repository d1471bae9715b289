"""The port's LER validation campaign: five presets on the card, held to the
references the repo holds.

    python3 scripts/validate_port.py [--out DIR] [--presets NAME ...]
                                     [--device cuda] [--codes ...] [--trials N]

Runs the presets ``study``, ``paper``, ``phenomenological``, ``space-time``
and ``complete-bposd`` (float32 streams: the port has no bf16 streams)
through ``qldpc_tpu_torch.experiments.run_experiment``, at their codes,
rates and trials, and holds every cell the repo has a reference for within
binomial bars (4 sigma of the two-sample difference plus 2 / min(trials), the
floor of scripts/validate_baseline.py's bars for cells with no event):

  * ``study`` (BP(50) + OSD-0, code capacity): BASELINE.md section 1, the
    cells of grid indices 5-7 (scripts/validate_baseline.py:46-52, 1,000
    trials);
  * ``complete-bposd``: the float32 tables of docs/circuit_ler.md:39-81 for
    [[72]] to [[144]] (obs-err and OSD rate, 10,000 trials); [[288]] in a run
    of its own at p = 0.0015 and 0.003, 10,000 trials, against the float32
    pair 0.0001 / 0.0384 (docs/circuit_ler.md:34), obs-err only;
  * ``phenomenological``: the preset (OSD-0) is recorded; a second run with
    BP alone (the CLI's ``--bp-only``) is held to BASELINE.md section 6
    (BP-only, 100 trials, scripts/validate_baseline.py PH_REF);
  * ``space-time``: the JAX engine's counters at the same seeds for [[72]] to
    [[144]] (``python3 scripts/jax_reference_counters.py --only
    space-time``, LER and OSD rate); [[288]] at T = 18 is recorded;
  * ``paper`` (the doubled channel with OSD-0): recorded, no reference.

A gated cell whose reference LER r is above 0 gets at least 25 / r trials
(at most 100,000): a run of its own at a seed of its own tops up the
preset's trials, and the two samples are pooled. Writes DIR/<preset>/ (the
run's npz archives) and DIR/validate_port.json: every cell's counts, its
reference and bar where it has one, each run's wall time and peak device
memory, and the card's name and power limit. Exits 1 if a gated cell is
outside its bar. ``--codes`` and ``--trials`` cut the campaign down for a
rehearsal (no top-ups then); ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from qldpc_tpu_torch.experiments import get_preset, run_experiment  # noqa: E402
from qldpc_tpu_torch.experiments.configs import LOGSPACE_GRID  # noqa: E402
from qldpc_tpu_torch.mc.engine import engine_device  # noqa: E402

C72, C90, C108, C144, C288 = ("[[72, 12, 6]]", "[[90, 8, 10]]", "[[108, 8, 10]]",
                              "[[144, 12, 12]]", "[[288, 12, 18]]")

# BASELINE.md section 1: BP(50)+OSD-0 LER, 1,000 trials, at grid indices 5-7
STUDY_REF = {
    C72: {5: 0.004, 6: 0.026, 7: 0.183},
    C90: {5: 0.002, 6: 0.005, 7: 0.053},
    C108: {5: 0.000, 6: 0.007, 7: 0.057},
    C144: {5: 0.000, 6: 0.003, 7: 0.048},
    C288: {5: 0.000, 6: 0.002, 7: 0.021},
}
STUDY_REF_TRIALS = 1000

# BASELINE.md section 6: phenomenological BP-only LER, 100 trials, the 8
# grid points
PH_REF = {
    C72: [0.01, 0.03, 0.09, 0.13, 0.19, 0.4, 0.54, 0.87],
    C90: [0.02, 0.04, 0.12, 0.19, 0.25, 0.6, 0.7, 0.94],
    C108: [0.03, 0.07, 0.1, 0.2, 0.27, 0.57, 0.77, 0.91],
    C144: [0.08, 0.07, 0.1, 0.31, 0.35, 0.69, 0.89, 1.0],
    C288: [0.12, 0.22, 0.35, 0.51, 0.71, 0.93, 0.99, 1.0],
}
PH_REF_TRIALS = 100

# docs/circuit_ler.md, float32 streams, 10,000 trials: p -> (obs-err, OSD rate)
CIRCUIT_REF = {
    C72: {0.0005: (0.0015, 0.232), 0.001: (0.0102, 0.424), 0.002: (0.0689, 0.700),
          0.003: (0.1675, 0.860)},
    C90: {0.0005: (0.0004, 0.448), 0.001: (0.0049, 0.694), 0.002: (0.0514, 0.928),
          0.003: (0.1742, 0.982)},
    C108: {0.0005: (0.0, 0.502), 0.001: (0.0025, 0.749), 0.002: (0.0280, 0.954),
           0.003: (0.1137, 0.992)},
    C144: {0.0005: (0.0003, 0.669), 0.001: (0.0009, 0.894), 0.002: (0.0264, 0.993),
           0.003: (0.1232, 0.999)},
}
CIRCUIT_REF_TRIALS = 10_000
# docs/circuit_ler.md:34, the float32 [[288]] pair (obs-err only)
CIRCUIT_288_REF = {0.0015: 0.0001, 0.003: 0.0384}
CIRCUIT_288_TRIALS = 10_000

# The JAX engine's space-time preset cells (T = distance, BP(100)
# sum-product + OSD-0, batch 512, 1,000 trials, seed = rate index):
# p -> (LER, OSD rate), from scripts/jax_reference_counters.py --only space-time
ST_REF = {
    C72: {0.001: (0.0, 0.0), 0.002: (0.0, 0.0), 0.004: (0.003, 0.008), 0.008: (0.01, 0.023)},
    C90: {0.001: (0.001, 0.002), 0.002: (0.0, 0.001), 0.004: (0.001, 0.006),
          0.008: (0.013, 0.031)},
    C108: {0.001: (0.0, 0.0), 0.002: (0.0, 0.001), 0.004: (0.004, 0.01), 0.008: (0.013, 0.034)},
    C144: {0.001: (0.001, 0.001), 0.002: (0.0, 0.004), 0.004: (0.005, 0.009),
           0.008: (0.017, 0.048)},
}
ST_REF_TRIALS = 1000

MIN_EVENTS = 25
MAX_TRIALS = 100_000


def bar(ref: float, n_ref: int, got: float, n_got: int) -> float:
    """4 sigma of the difference of two binomial rates, plus 2 / min(n)."""
    var = ref * (1 - ref) / n_ref + got * (1 - got) / n_got
    return 4 * math.sqrt(var) + 2.0 / min(n_ref, n_got)


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


class Campaign:
    def __init__(self, out: Path, device, codes=None, trials=None):
        self.out, self.device = out, device
        self.codes, self.trials = codes, trials
        self.runs: list[dict] = []
        self.cells: list[dict] = []

    def run(self, spec, label: str) -> dict:
        """One run_experiment call; returns {code: {p: counters dict}}."""
        if self.codes:
            spec = spec.replace(codes=[c for c in spec.codes if c in self.codes])
        if self.trials:
            spec = spec.replace(trials=self.trials)
        spec = spec.replace(output_dir=str(self.out / label))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run_experiment(spec, device=self.device, checkpoint=False)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if self.device.type == "cuda" else None
        trials = sum(d["trials"] for c in spec.codes for d in res[c].values())
        self.runs.append(dict(label=label, codes=spec.codes, trials=trials, wall_s=wall,
                              trials_per_s=trials / wall, peak_bytes=peak))
        print(f"[validate_port] {label}: {trials} trials in {wall:.1f} s, peak "
              f"{peak if peak is None else f'{peak / 2**30:.2f} GiB'}", flush=True)
        return {c: res[c] for c in spec.codes}

    def top_up(self, spec, label: str, code: str, i: int, p: float, have: int,
               ref: float) -> list[dict]:
        """Extra trials for a low-LER cell, at a seed of its own."""
        need = min(MAX_TRIALS, math.ceil(MIN_EVENTS / ref)) if ref > 0 else 0
        if self.trials or need <= have:
            return []
        extra = spec.replace(codes=[code], error_rates=[p], per_code_rates=None,
                             trials=need - have, seed=spec.seed + 1000 + i,
                             name=f"{spec.name}-top-up")
        return [self.run(extra, f"{label}-top-up-{code[2:code.index(',')]}-{p:g}")[code][p]]

    def gate(self, preset: str, code: str, p: float, parts: list[dict], metric: str,
             ref, n_ref: int) -> None:
        n = sum(d["trials"] for d in parts)
        hits = sum(round(d[metric] * d["trials"]) for d in parts)
        got = hits / n
        row = dict(preset=preset, code=code, p=p, metric=metric, got=got, count=hits,
                   trials=n)
        if ref is not None:
            tol = bar(ref, n_ref, got, n)
            row.update(ref=ref, ref_trials=n_ref, tol=tol, ok=abs(got - ref) <= tol)
        self.cells.append(row)
        status = "recorded" if ref is None else ("OK" if row["ok"] else "OUTSIDE")
        print(f"  {preset:24s} {code:16s} p={p:<9.6g} {metric:4s} {got:.5f} ({hits}/{n})"
              + ("" if ref is None else f" ref {ref} +-{row['tol']:.5f}") + f" {status}",
              flush=True)


def study(c: Campaign) -> None:
    spec = get_preset("study")
    res = c.run(spec, "study")
    for code, cells in res.items():
        rates = spec.rates_for(code)
        for i, p in enumerate(rates):
            ref = STUDY_REF.get(code, {}).get(LOGSPACE_GRID.index(p)) if p in LOGSPACE_GRID else None
            parts = [cells[p]]
            if ref is not None:
                parts += c.top_up(spec, "study", code, i, p, cells[p]["trials"], ref)
            c.gate("study", code, p, parts, "ler", ref, STUDY_REF_TRIALS)


def paper(c: Campaign) -> None:
    res = c.run(get_preset("paper"), "paper")
    for code, cells in res.items():
        for p, d in cells.items():
            c.gate("paper", code, p, [d], "ler", None, 0)


def phenomenological(c: Campaign) -> None:
    spec = get_preset("phenomenological")
    for code, cells in c.run(spec, "phenomenological").items():
        for p, d in cells.items():
            c.gate("phenomenological", code, p, [d], "ler", None, 0)
    bp_only = spec.replace(name="phenomenological-bp-only", osd_order=None)
    for code, cells in c.run(bp_only, "phenomenological-bp-only").items():
        for i, p in enumerate(spec.rates_for(code)):
            c.gate("phenomenological-bp-only", code, p, [cells[p]], "ler",
                   PH_REF[code][i], PH_REF_TRIALS)


def space_time(c: Campaign) -> None:
    res = c.run(get_preset("space-time"), "space-time")
    for code, cells in res.items():
        for p, d in cells.items():
            ref = ST_REF.get(code, {}).get(p)
            for k, metric in enumerate(("ler", "osd")):
                c.gate("space-time", code, p, [d], metric,
                       None if ref is None else ref[k], ST_REF_TRIALS)


def complete_bposd(c: Campaign) -> None:
    spec = get_preset("complete-bposd").replace(bp_stream_dtype="float32")
    res = c.run(spec, "complete-bposd")
    for code, cells in res.items():
        for i, p in enumerate(spec.rates_for(code)):
            ref = CIRCUIT_REF.get(code, {}).get(p)
            parts = [cells[p]]
            if ref is not None:
                parts += c.top_up(spec, "complete-bposd", code, i, p, cells[p]["trials"], ref[0])
            for k, metric in enumerate(("ler", "osd")):
                c.gate("complete-bposd", code, p, parts, metric,
                       None if ref is None else ref[k], CIRCUIT_REF_TRIALS)
    if c.codes and C288 not in c.codes:
        return
    gate288 = spec.replace(name="complete-bposd-288", codes=[C288],
                           error_rates=list(CIRCUIT_288_REF), trials=CIRCUIT_288_TRIALS)
    for p, d in c.run(gate288, "complete-bposd-288")[C288].items():
        c.gate("complete-bposd-288", C288, p, [d], "ler", CIRCUIT_288_REF[p],
               CIRCUIT_288_TRIALS)
        c.gate("complete-bposd-288", C288, p, [d], "osd", None, 0)


PRESETS = {"study": study, "paper": paper, "phenomenological": phenomenological,
           "space-time": space_time, "complete-bposd": complete_bposd}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/validate_port")
    ap.add_argument("--presets", nargs="+", choices=list(PRESETS), default=list(PRESETS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--codes", nargs="+", default=None, help="cut every preset to these codes")
    ap.add_argument("--trials", type=int, default=None, help="cut every run to these trials")
    args = ap.parse_args()
    device = engine_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    card_line = card()
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[validate_port] {kind}; nvidia-smi: {card_line}", flush=True)
    c = Campaign(out, device, args.codes, args.trials)
    t0 = time.perf_counter()
    for name in args.presets:
        PRESETS[name](c)
    gated = [r for r in c.cells if "ok" in r]
    failed = [r for r in gated if not r["ok"]]
    summary = dict(device=kind, card=card_line, torch=torch.__version__,
                   wall_s=time.perf_counter() - t0, gated=len(gated), within_bars=len(gated) - len(failed),
                   recorded=len(c.cells) - len(gated), runs=c.runs, cells=c.cells)
    (out / "validate_port.json").write_text(json.dumps(summary, indent=1, default=float))
    print(f"[validate_port] {len(gated) - len(failed)}/{len(gated)} gated cells within bars, "
          f"{summary['recorded']} recorded, {summary['wall_s']:.1f} s -> {out}/validate_port.json",
          flush=True)
    for r in failed:
        print(f"[validate_port] OUTSIDE: {json.dumps(r, default=float)}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
