"""Small cells for the CPU tests: the benchmark's cells with the
[[72,12,6]] code in place of the gross code, small batches and, for the
DEM, two rounds; their limits are the real cells'. The space-time cell
("st", four rounds) is a configuration of the shape a space-time cell's
file has (``st_config``), with the code-capacity cell's traffic and limits."""

from __future__ import annotations

import copy

from benchmark import harness

CODE72 = {"name": "[[72, 12, 6]]", "l": 6, "m": 6, "a": [[3, 0], [0, 1], [0, 2]],
          "b": [[0, 3], [1, 0], [2, 0]], "n": 72, "k": 12, "d": 6}
SEED = 2**33 + 12345


def st_config(code: dict = CODE72, rounds: int = 4, batch: int = 256) -> dict:
    """A space-time configuration: the CLI's ``space-time`` preset (BP(100)
    sum-product + OSD-0) on ``rounds`` rounds; its control the reference's
    BP with bfloat16 messages in the place of K6, which has no lower
    precision of its own."""
    return {
        "name": f"bb{code['n']}_st_bposd",
        "source": f"Bravyi et al., arXiv:2308.07915: {code['name']} under phenomenological "
                  "noise over T rounds, decoded on the space-time matrix by BP+OSD-0",
        "code": dict(code),
        "channel": "space-time",
        "basis": "x",
        "preset": "space-time",
        "spec": {"bp_method": "sum-product", "bp_max_iter": 100, "osd_order": 0,
                 "osd_fraction": 1.0, "batch_size": batch, "bp_backend": "xla",
                 "bp_mm_dtype": "float32", "bp_stream_dtype": "float32", "alpha": 1.0,
                 "damping": 1.0, "clip_llr": None, "n_rounds": rounds,
                 "syndrome_flip_rate": None},
        "dtype": "float32",
        "tanh_clip": 0.9999999,
        "control": {"bp": "bfloat16"},
        "assumed": [],
        "reduced": [],
        "guarantees": "every sample is decoded by BP(100) sum-product on H_st and, where BP "
                      "does not converge, by OSD-0 on H_st; the counters are exact per seed",
    }


def cell(kind: str, p: float | None = None) -> harness.Cell:
    c = harness.load_cell({"cc": "cc144_p050", "dem": "dem144_p001", "st": "cc144_p050"}[kind])
    c.config = copy.deepcopy(c.config)
    c.config["code"] = dict(CODE72)
    if kind == "st":
        c.config = st_config()
        p = 0.03 if p is None else p
    elif kind == "dem":
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
