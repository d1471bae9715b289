"""Counters of the JAX package that chip_smoke.py and scripts/validate_port.py
hold the port to.

    python3 scripts/jax_reference_counters.py [--only NAME ...] [--out FILE]

Runs the JAX package on the CPU (XLA, a one-device mesh) for the
configurations below and prints one JSON object per configuration: its
settings, the CPU seconds it took, and every counter of
``counters_to_dict``, the histograms as {weight: count} of their nonzero
bins (an ``alpha-`` entry holds the fitted alpha instead). chip_smoke.py and
scripts/validate_port.py keep these numbers as constants beside this
command. The times are wall seconds on an 8-core CPU shared with other
work:

  * ``st144-min-sum``: the space-time channel on [[144,12,12]] at T = 12,
    BP(100) min-sum + OSD-0, batch 512, p = 0.008, 4,096 trials, seed 1
    (the seed chip_smoke.py's space-time sweep gives p = 0.008). BP and the
    RNG are bit-exact in both packages, so the port must count the same;
  * ``st144-sum-product``: the same with the ``space-time`` preset's BP(100)
    sum-product, held at LER and OSD-rate level (the transcendentals of
    XLA's CPU backend differ from the card's in the last ulp);
  * ``layered144``: code capacity on [[144,12,12]], BP(50) layered
    sum-product + OSD-0, batch 65,536, p = 0.050119, 65,536 trials, seed 0;
  * ``space-time-<n>-<p>``: the ``space-time`` preset's cells on the codes
    [[72]] to [[144]] (T = distance, BP(100) sum-product + OSD-0, batch 512,
    1,000 trials, seed = the rate's index), which scripts/validate_port.py
    holds the port's run of that preset to (``--only`` takes ``space-time``
    for all 16; about 25 minutes, [[144]] 100-310 s a cell);
  * ``st288-min-sum``: [[288,12,18]] space-time at T = 18, BP(100) min-sum +
    OSD-0, batch 32, p = 0.008, 128 trials, seed 1, OSD on the BP failures
    compacted to 4, 8 or 16 lanes (``osd_tiers``, which changes no counter):
    chip_smoke.py phase 24 holds the card to it. The slow stage is OSD: H_st
    (2,592 x 7,776) is narrow, so the JAX decoder runs its lanes row
    elimination, about 150 s a call on 8 lanes (BP(100) on them: 0.26 s); a
    batch of 256 did not finish in 18 minutes, one of 32 with every lane
    eliminated took 619 s;
  * ``ph144-osde7``: the phenomenological channel on [[144,12,12]], BP(50)
    min-sum + OSD-e(7), batch 512, p = 0.03, 512 trials, seed 0: about 98%
    of the syndromes leave H's image, so the OSD-e search runs on almost
    every sample (chip_smoke.py phase 26); 5.6 s;
  * ``alpha-<n>-<p>``: ``estimate_alpha`` min-sum (float32 draws, as the
    CLI makes them) at the first two ``rework-minsum`` rates of [[72]] and
    [[144]], seed 17 * i for rate i, as the runner seeds it; 2.4-4.6 s each;
  * ``rework-minsum-<n>-<p>``: those rates' ``rework-minsum`` cells at
    1,024 trials (one batch, seed i) with the fitted alpha; 4.3-7.2 s each;
  * ``complete-72-<p>``: the ``complete`` preset's decoder (BP(100)
    sum-product alone on the Z-memory DEM, the XLA slot path) on [[72,12,6]]
    at its eight rates, batch 128, 128 trials, seed i; 130-200 s each;
  * ``spectrum-<n>``: the ``spectrum`` preset (BP(50) sum-product + OSD-0
    at p = 0.005, batch 4,096) on each code, 4,096 trials, seed 0;
    2.9-9.6 s each.

The ``--only`` groups ``space-time``, ``alpha``, ``rework-minsum``,
``complete`` and ``spectrum`` take every entry of their prefix. This script
imports jax; the port never does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from qldpc_tpu.codes import get_code  # noqa: E402
from qldpc_tpu.decoders import BPConfig  # noqa: E402
from qldpc_tpu.decoders.alvarado import estimate_alpha  # noqa: E402
from qldpc_tpu.decoders.osd import OSDConfig  # noqa: E402
from qldpc_tpu.mc import DEMEngine, DEMEngineConfig  # noqa: E402
from qldpc_tpu.mc import EngineConfig, MonteCarloEngine, counters_to_dict  # noqa: E402
from qldpc_tpu.noise.circuit import parametric_memory_dem  # noqa: E402
from qldpc_tpu.parallel import make_mesh  # noqa: E402

CODE = "[[144, 12, 12]]"
ST_PRESET_CODES = ("[[72, 12, 6]]", "[[90, 8, 10]]", "[[108, 8, 10]]", "[[144, 12, 12]]")
ST_PRESET_RATES = (0.001, 0.002, 0.004, 0.008)
REWORK_MINSUM = {"[[72, 12, 6]]": (0.1, 0.06), "[[144, 12, 12]]": (0.1, 0.06)}
LOGSPACE_GRID = [float(p) for p in np.logspace(-3.2, -1.3, 8)]
CODES = ("[[72, 12, 6]]", "[[90, 8, 10]]", "[[108, 8, 10]]", "[[144, 12, 12]]",
         "[[288, 12, 18]]")
# the rework-minsum preset's decoder (qldpc_tpu/experiments/configs.py)
RM_BP = dict(max_iter=50, method="min-sum", damping=0.7, clip_llr=25.0)


def _short(code: str) -> str:
    return code[2:code.index(",")]


CONFIGS = {
    "st144-min-sum": dict(
        p=0.008, trials=4096, seed=1,
        config=dict(bp=BPConfig(max_iter=100, method="min-sum"), channel="space-time",
                    n_rounds=12, batch_size=512),
    ),
    "st144-sum-product": dict(
        p=0.008, trials=4096, seed=1,
        config=dict(bp=BPConfig(max_iter=100), channel="space-time", n_rounds=12,
                    batch_size=512),
    ),
    "layered144": dict(
        p=0.050119, trials=65536, seed=0,
        config=dict(bp=BPConfig(max_iter=50, schedule="layered"), batch_size=65536),
    ),
    **{
        f"space-time-{_short(code)}-{p}": dict(
            code=code, p=p, trials=1000, seed=i,
            config=dict(bp=BPConfig(max_iter=100), channel="space-time", batch_size=512),
        )
        for code in ST_PRESET_CODES for i, p in enumerate(ST_PRESET_RATES)
    },
    "st288-min-sum": dict(
        code="[[288, 12, 18]]", p=0.008, trials=128, seed=1,
        config=dict(bp=BPConfig(max_iter=100, method="min-sum"), channel="space-time",
                    n_rounds=18, batch_size=32, osd_tiers=(4, 8, 16)),
    ),
    "ph144-osde7": dict(
        p=0.03, trials=512, seed=0, osd=OSDConfig(order=7),
        config=dict(bp=BPConfig(max_iter=50, method="min-sum"), channel="phenomenological",
                    batch_size=512),
    ),
    **{
        f"alpha-{_short(code)}-{p}": dict(kind="alpha", code=code, p=p, seed=17 * i)
        for code, rates in REWORK_MINSUM.items() for i, p in enumerate(rates)
    },
    **{
        f"rework-minsum-{_short(code)}-{p}": dict(
            kind="rework-minsum", code=code, p=p, trials=1024, seed=i, alpha_seed=17 * i,
            config=dict(bp=BPConfig(**RM_BP), batch_size=1024),
        )
        for code, rates in REWORK_MINSUM.items() for i, p in enumerate(rates)
    },
    **{
        f"complete-72-{p:.6g}": dict(
            kind="dem", code="[[72, 12, 6]]", p=p, trials=128, seed=i, osd=None,
            config=dict(bp=BPConfig(max_iter=100), batch_size=128),
        )
        for i, p in enumerate(LOGSPACE_GRID)
    },
    **{
        f"spectrum-{_short(code)}": dict(
            code=code, p=0.005, trials=4096, seed=0,
            config=dict(bp=BPConfig(max_iter=50), batch_size=4096),
        )
        for code in CODES
    },
}
GROUPS = ("space-time", "alpha", "rework-minsum", "complete", "spectrum")


def _counters(d: dict) -> dict:
    counters = {}
    for k, v in d.items():
        if isinstance(v, np.ndarray) or getattr(v, "ndim", 0):
            v = np.asarray(v)
            counters[k] = {int(i): int(v[i]) for i in np.nonzero(v)[0]}
        else:
            counters[k] = v.item() if hasattr(v, "item") else v
    return counters


def record(name: str) -> dict:
    spec = CONFIGS[name]
    kind = spec.get("kind", "engine")
    code = spec.get("code", CODE)
    row = dict(name=name, code=code, p=spec["p"], seed=spec["seed"])
    t0 = time.perf_counter()
    if kind == "alpha":
        row["alpha"] = estimate_alpha(get_code(code).Hx, spec["p"], method="min-sum",
                                      seed=spec["seed"])
        row["seconds"] = round(time.perf_counter() - t0, 1)
        return row
    alpha = None
    if kind == "rework-minsum":
        alpha = estimate_alpha(get_code(code).Hx, spec["p"], method="min-sum",
                               seed=spec["alpha_seed"])
        row["alpha"] = alpha
    if kind == "dem":
        c = get_code(code)
        eng = DEMEngine(parametric_memory_dem(c, basis="z", rounds=c.distance),
                        DEMEngineConfig(osd=spec["osd"], **spec["config"]),
                        mesh=make_mesh(1), name=code)
    else:
        cfg = EngineConfig(osd=spec.get("osd", OSDConfig(order=0)), **spec["config"])
        eng = MonteCarloEngine(get_code(code), cfg, mesh=make_mesh(1))
    d = counters_to_dict(eng.run_rate(spec["p"], spec["trials"], seed=spec["seed"],
                                      alpha=alpha))
    row.update(trials=spec["trials"], seconds=round(time.perf_counter() - t0, 1),
               counters=_counters(d))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=[*CONFIGS, *GROUPS],
                    default=list(CONFIGS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    names = [n for o in args.only
             for n in ([k for k in CONFIGS if k.startswith(f"{o}-")]
                       if o in GROUPS else [o])]
    rows = []
    for name in names:
        row = record(name)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
