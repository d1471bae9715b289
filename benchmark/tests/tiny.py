"""Small cells for the CPU tests: the benchmark's cells with the
[[72,12,6]] code in place of the gross code, small batches and, for the
DEM, two rounds; their limits are the real cells'."""

from __future__ import annotations

import copy

from benchmark import harness

CODE72 = {"name": "[[72, 12, 6]]", "l": 6, "m": 6, "a": [[3, 0], [0, 1], [0, 2]],
          "b": [[0, 3], [1, 0], [2, 0]], "n": 72, "k": 12, "d": 6}
SEED = 2**33 + 12345


def cell(kind: str, p: float | None = None) -> harness.Cell:
    c = harness.load_cell({"cc": "cc144_p050", "dem": "dem144_p001"}[kind])
    c.config = copy.deepcopy(c.config)
    c.config["code"] = dict(CODE72)
    if kind == "dem":
        c.config.update(rounds=2, detectors=144, mechanisms=3921)
        c.config["spec"].update(n_rounds=2, batch_size=64)
        p = 0.003 if p is None else p
    else:
        c.config["spec"]["batch_size"] = 512
        p = 0.06 if p is None else p
    c.traffic = dict(c.traffic, p=p, check={"drawn": 1, "within_first": 2}, stage_reps=2,
                     idle_batches=2)
    return c


def run(kind: str, traced: bool = False, control: bool = False, seed: int = SEED) -> dict:
    return harness.run(cell(kind), seed, 0.3, traced, device="cpu", control=control,
                       log=lambda msg: None)
