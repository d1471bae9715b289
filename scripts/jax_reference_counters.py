"""Counters of the JAX engine that chip_smoke.py holds the port's engine to.

    python3 scripts/jax_reference_counters.py [--only NAME ...] [--out FILE]

Runs the JAX package's ``MonteCarloEngine`` on the CPU (XLA, a one-device
mesh) for the configurations below and prints one JSON object per
configuration: its settings and every counter of ``counters_to_dict``, the
histograms as {weight: count} of their nonzero bins. chip_smoke.py keeps
these numbers as constants beside this command:

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
    for all 16; about 25 minutes, [[144]] 100-310 s a cell).

This script imports jax; the port never does. Each space-time configuration
takes several minutes of CPU.
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
from qldpc_tpu.decoders.osd import OSDConfig  # noqa: E402
from qldpc_tpu.mc import EngineConfig, MonteCarloEngine, counters_to_dict  # noqa: E402
from qldpc_tpu.parallel import make_mesh  # noqa: E402

CODE = "[[144, 12, 12]]"
ST_PRESET_CODES = ("[[72, 12, 6]]", "[[90, 8, 10]]", "[[108, 8, 10]]", "[[144, 12, 12]]")
ST_PRESET_RATES = (0.001, 0.002, 0.004, 0.008)
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
        f"space-time-{code[2:code.index(',')]}-{p}": dict(
            code=code, p=p, trials=1000, seed=i,
            config=dict(bp=BPConfig(max_iter=100), channel="space-time", batch_size=512),
        )
        for code in ST_PRESET_CODES for i, p in enumerate(ST_PRESET_RATES)
    },
}


def record(name: str) -> dict:
    spec = CONFIGS[name]
    cfg = EngineConfig(osd=OSDConfig(order=0), **spec["config"])
    code = spec.get("code", CODE)
    eng = MonteCarloEngine(get_code(code), cfg, mesh=make_mesh(1))
    t0 = time.perf_counter()
    d = counters_to_dict(eng.run_rate(spec["p"], spec["trials"], seed=spec["seed"]))
    secs = time.perf_counter() - t0
    counters = {}
    for k, v in d.items():
        if isinstance(v, np.ndarray) or getattr(v, "ndim", 0):
            v = np.asarray(v)
            counters[k] = {int(i): int(v[i]) for i in np.nonzero(v)[0]}
        else:
            counters[k] = v.item() if hasattr(v, "item") else v
    return dict(name=name, code=code, p=spec["p"], trials=spec["trials"],
                seed=spec["seed"], seconds=round(secs, 1), counters=counters)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=[*CONFIGS, "space-time"],
                    default=list(CONFIGS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    names = [n for o in args.only
             for n in ([k for k in CONFIGS if k.startswith("space-time-")]
                       if o == "space-time" else [o])]
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
