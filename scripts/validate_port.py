"""The port's LER validation campaign: fifteen presets on the card, held to
the references the repo holds.

    python3 scripts/validate_port.py [--out DIR] [--presets NAME ...]
                                     [--device cuda] [--codes ...] [--trials N]

Runs every preset of the experiments layer through
``qldpc_tpu_torch.experiments.run_experiment`` at its codes, rates and trials
(``complete-bposd`` as shipped, with bf16 streams, and again with float32
streams), and holds every cell the repo has a reference for within binomial
bars (4 sigma
of the two-sample difference plus 2 / min(trials), the floor of
scripts/validate_baseline.py's bars for cells with no event, plus the
workload's relative slack ``rel`` of scripts/validate_baseline.py's
WORKLOADS where it has one):

  * ``study`` (BP(50) + OSD-0, code capacity): BASELINE.md section 1, the
    cells of grid indices 5-7 (scripts/validate_baseline.py:46-52, 1,000
    trials);
  * ``complete-bposd`` as shipped (bf16 streams): p = 0.001 and 0.002 of
    [[72]] to [[144]] against the bf16 cells of results/circuit_bf16_val and
    results/circuit_bf16_val_r5 (docs/circuit_ler.md:25-34, obs-err and OSD
    rate, 10,000 trials), its other rates recorded; [[288]] in a run of its
    own at p = 0.0015 and 0.003, 10,000 trials, with ``osd_backend=factored``
    (the TPU's route, which returns the samples past its column budget
    unsolved), against the bf16 pair 0.0001 / 0.0381 (docs/circuit_ler.md:34),
    obs-err only; beside it the same cells as shipped (those samples solved
    through the transform, as the JAX lanes path solves them) are recorded
    with their sigma and the samples past the budget;
  * ``complete-bposd`` with ``bp_stream_dtype=float32``: the float32 tables
    of docs/circuit_ler.md:39-81 for [[72]] to [[144]] (obs-err and OSD
    rate, 10,000 trials); [[288]] as above against the float32 pair 0.0001 /
    0.0384;
  * ``study-mm-bf16``: ``study`` (BP(50) + OSD-0, code capacity) with bf16
    operands in K1 (``bp_backend=pallas``, ``bp_mm_dtype=bfloat16``), 10,000
    trials at grid indices 5-7, against the JAX package's TPU run with the
    same mode (results/validation_r5_bf16mxu/validation.md, its "ours"
    column, 10,000 trials);
  * ``phenomenological``: the preset (OSD-0) is recorded; a second run with
    BP alone (the CLI's ``--bp-only``) is held to BASELINE.md section 6
    (BP-only, 100 trials, scripts/validate_baseline.py PH_REF);
  * ``space-time``: the JAX engine's counters at the same seeds for [[72]] to
    [[144]] (``python3 scripts/jax_reference_counters.py --only
    space-time``, LER and OSD rate); [[288]] at T = 18 is recorded;
  * ``paper`` (the doubled channel with OSD-0): recorded, no reference;
  * ``paper-gpu`` (BP(150) + OSD-e(7), doubled), ``rework`` (BP(100) +
    OSD-e(7)) and ``different-orders`` ({50, 100} x {OSD-0, OSD-e(7)}) are
    recorded at their own settings; beside them run the validate_baseline
    workloads of OSD-e(7) on the same presets with its decoder:
    ``doubled+osde7`` (paper-gpu at BP(200) on [0.01 .. 0.004], against
    data/3-BPOSD.npz), ``cc+osde7-200`` (rework at BP(200), same rates,
    against data/2-BPOSD.npz, 50,000 trials) and ``rework+osde7`` (rework at
    BP(50) on [0.04 .. 0.1], BASELINE.md section 5, rel 0.05);
  * ``cc-50k`` (BP alone, 50,000 trials): ``bp-only``, BASELINE.md section 2,
    rel 0.15; ``notebook-bp`` and ``notebook-bposd`` (10,000 trials):
    ``notebooks-bp`` (the notebook's additive ``ler_notebook``, rel 0.15) and
    ``notebooks-bposd``, BASELINE.md section 3;
  * seven cells where the JAX package's own campaign
    (results/validation_r3/validation.json, 10,000 trials) lies outside the
    archive's bar (VERDICT.md "weak" #4: ``bp-only`` [[288]] p = 0.01436,
    ``rework+osde7`` [[108]] p = 0.1, [[144]] 0.06 and 0.1, [[288]] 0.04,
    0.06 and 0.1) are held to the JAX package's value instead, with the
    archive's recorded beside it;
  * a ``bp-only`` or ``notebooks-bp`` cell below its archive by more than
    its bar passes only where it lies within the bar of the JAX package's
    own campaign at that cell (``JAX_CONFIRM``): scripts/validate_baseline
    .py's BETTER rule, with that campaign in place of its numpy oracle;
  * ``bp-iteration`` (p = 0.01, max_iter 10 .. 90): [[72]] 0.0017 and
    [[144]] 0.0011 at every max_iter (results/bp_iteration_r5,
    docs/bp_iteration.md, 10,000 trials), no top-ups (the nine cells of a
    code decode the same samples). That archive is flat in max_iter; the
    JAX package's CLI today is not (its OSD rate on [[72]] falls from
    0.0018 at BP(10) to 0.0009 at BP(90)), so flatness is not gated;
  * ``complete``, ``spectrum`` and ``rework-minsum``, which have no archive:
    recorded at their own settings, and held to the JAX engine at equal
    seeds on small runs (``scripts/jax_reference_counters.py --only complete
    spectrum alpha rework-minsum``): ``complete`` on the [[72]] DEM (batch
    and trials 128 a rate, obs-err), ``spectrum`` (4,096 trials a code, LER and OSD
    rate), ``rework-minsum`` at the first two rates of [[72]] and [[144]]
    (1,024 trials): the fitted alpha, BP's failures and mean iterations
    equal, the LER within its bar (the alpha reorders OSD near-ties,
    ROADMAP.md Queue 3).

A gated cell whose reference LER r is above 0 gets at least 25 / r trials
(at most 100,000): a run of its own at a seed of its own tops up the
preset's trials, and the two samples are pooled. Writes DIR/<preset>/ (the
run's npz archives) and DIR/validate_port.json: every cell's counts, its
reference and bar where it has one, each run's wall time and peak device
memory, and the card's name and power limit. Exits 1 if a gated cell is
outside its bar. ``--codes`` and ``--trials`` cut the campaign down for a
rehearsal (batches of at most that many trials, and no top-ups; the runs
held to the JAX engine keep their trials); ``--device cpu`` runs the plain
versions.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

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
# the JAX package's bf16-stream cells, 10,000 trials: p -> (obs-err, OSD
# rate) from results/circuit_bf16_val ([[72]], [[144]]) and
# results/circuit_bf16_val_r5 ([[90]], [[108]]); [[288]]'s bf16 pair from
# results/circuit_f32_val_288 (docs/circuit_ler.md:34, obs-err only)
CIRCUIT_BF16_REF = {
    C72: {0.001: (0.0102, 0.4318), 0.002: (0.0643, 0.7117)},
    C90: {0.001: (0.004, 0.6942), 0.002: (0.0472, 0.9225)},
    C108: {0.001: (0.0018, 0.7533), 0.002: (0.0263, 0.9529)},
    C144: {0.001: (0.0014, 0.8994), 0.002: (0.022, 0.9945)},
}
CIRCUIT_288_BF16_REF = {0.0015: 0.0001, 0.003: 0.0381}

# results/validation_r5_bf16mxu/validation.md: the JAX package's BP(50) +
# OSD-0 code-capacity LER with bf16 MXU operands on the TPU ("ours"), 10,000
# trials, at grid indices 5-7
MM_BF16_REF = {
    C72: {5: 0.0048, 6: 0.0311, 7: 0.1675},
    C90: {5: 0.0006, 6: 0.0054, 7: 0.074},
    C108: {5: 0.0004, 6: 0.0041, 7: 0.0536},
    C144: {5: 0.0006, 6: 0.0048, 7: 0.0442},
    C288: {5: 0.0006, 6: 0.0017, 7: 0.0209},
}
MM_BF16_TRIALS = 10_000

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

# Copied from scripts/validate_baseline.py (which imports the JAX package):
# the archive tables of its WORKLOADS and their relative slack
GRID_B = [0.01, 0.006, 0.005, 0.004]
DOUBLED_REF = {  # data/3-BPOSD.npz, doubled channel, 10k trials
    C72: {0: 0.0125, 1: 0.0024, 2: 0.0015, 3: 0.0008},
    C90: {0: 0.0014, 1: 0.0001, 2: 0.0, 3: 0.0},
    C108: {0: 0.002, 1: 0.0, 2: 0.0001, 3: 0.0},
    C144: {0: 0.0009, 1: 0.0001, 2: 0.0003, 3: 0.0},
    C288: {0: 0.0009, 1: 0.0002, 2: 0.0001, 3: 0.0},
}
CC_BPOSD_REF = {  # data/2-BPOSD.npz, plain code capacity, 50k trials
    C72: {0: 1.54e-3, 1: 4.4e-4, 2: 1e-4, 3: 4e-5},
    C90: {0: 1.4e-4, 1: 2e-5, 2: 2e-5, 3: 0.0},
    C108: {0: 2.6e-4, 1: 2e-5, 2: 2e-5, 3: 0.0},
    C144: {0: 1.8e-4, 1: 4e-5, 2: 6e-5, 3: 2e-5},
    C288: {0: 2.2e-4, 1: 2e-5, 2: 0.0, 3: 0.0},
}
REWORK_GRID = [0.04, 0.05, 0.06, 0.1]
REWORK_REF = {  # BASELINE.md section 5, 10k trials, BP cap ~50
    C72: {0: 0.0813, 1: 0.1525, 2: 0.2539, 3: 0.6637},
    C90: {0: 0.0243, 1: 0.0670, 2: 0.1358, 3: 0.5929},
    C108: {0: 0.0162, 1: 0.0538, 2: 0.1276, 3: 0.6130},
    C144: {0: 0.0157, 1: 0.0583, 2: 0.1432, 3: 0.7235},
    C288: {0: 0.0022, 1: 0.0216, 2: 0.1042, 3: 0.8329},
}
BP_REF = {  # BASELINE.md section 2, BP alone, 50k trials (grid indices 2-7)
    C72: {2: 2e-05, 3: 1.8e-04, 4: 9.2e-04, 5: 5.26e-03, 6: 3.496e-02, 7: 0.18312},
    C90: {2: 0.0, 3: 8e-05, 4: 2.4e-04, 5: 1.50e-03, 6: 1.298e-02, 7: 0.11326},
    C108: {2: 2e-05, 3: 8e-05, 4: 3.2e-04, 5: 2.10e-03, 6: 1.088e-02, 7: 0.10140},
    C144: {2: 0.0, 3: 6e-05, 4: 6.2e-04, 5: 2.46e-03, 6: 1.306e-02, 7: 0.09014},
    C288: {2: 4e-05, 3: 1.2e-04, 4: 1.02e-03, 5: 5.48e-03, 6: 1.906e-02, 7: 0.09442},
}
NB_BP_REF = {  # BASELINE.md section 3, notebooks/data/BP.npz, 10k trials
    C72: {2: 0.0001, 3: 0.0003, 4: 0.0012, 5: 0.0084, 6: 0.05, 7: 0.2712},
    C90: {2: 0.0, 3: 0.0, 4: 0.0002, 5: 0.002, 6: 0.0191, 7: 0.1877},
    C108: {2: 0.0, 3: 0.0, 4: 0.0007, 5: 0.0015, 6: 0.0137, 7: 0.17},
    C144: {2: 0.0, 3: 0.0, 4: 0.0002, 5: 0.001, 6: 0.014, 7: 0.1465},
    C288: {2: 0.0, 3: 0.0002, 4: 0.0009, 5: 0.0031, 6: 0.0164, 7: 0.1281},
}
NB_BPOSD_REF = {  # notebooks/data/BPOSD.npz, 10k trials
    C72: {2: 0.0001, 3: 0.0003, 4: 0.0006, 5: 0.0057, 6: 0.0263, 7: 0.1629},
    C90: {2: 0.0, 3: 0.0, 4: 0.0, 5: 0.0006, 6: 0.0056, 7: 0.0687},
    C108: {2: 0.0, 3: 0.0001, 4: 0.0, 5: 0.0006, 6: 0.0034, 7: 0.0544},
    C144: {2: 0.0, 3: 0.0, 4: 0.0, 5: 0.0008, 6: 0.0031, 7: 0.0499},
    C288: {2: 0.0, 3: 0.0, 4: 0.0002, 5: 0.0003, 6: 0.0021, 7: 0.0225},
}
# workload -> (archive, its trials, grid, rel, metric)
WORKLOADS = {
    "doubled+osde7": (DOUBLED_REF, 10_000, GRID_B, 0.0, "ler"),
    "cc+osde7-200": (CC_BPOSD_REF, 50_000, GRID_B, 0.0, "ler"),
    "rework+osde7": (REWORK_REF, 10_000, REWORK_GRID, 0.05, "ler"),
    "bp-only": (BP_REF, 50_000, LOGSPACE_GRID, 0.15, "ler"),
    "notebooks-bp": (NB_BP_REF, 10_000, LOGSPACE_GRID, 0.15, "ler_notebook"),
    "notebooks-bposd": (NB_BPOSD_REF, 10_000, LOGSPACE_GRID, 0.0, "ler"),
}
# The cells where the JAX package's full campaign lies outside the archive's
# bar (results/validation_r3/validation.md:49,103-111; VERDICT.md "weak"
# #4): (workload, code, p) -> the JAX package's LER there, 10k trials
# (results/validation_r3/validation.json), which the port is held to
JAX_HELD = {
    ("bp-only", C288, LOGSPACE_GRID[5]): 0.0017,
    ("rework+osde7", C108, 0.1): 0.5578,
    ("rework+osde7", C144, 0.06): 0.113,
    ("rework+osde7", C144, 0.1): 0.6341,
    ("rework+osde7", C288, 0.04): 0.0075,
    ("rework+osde7", C288, 0.06): 0.0626,
    ("rework+osde7", C288, 0.1): 0.6934,
}
JAX_HELD_TRIALS = 10_000
# scripts/validate_baseline.py's BETTER rule: a BP-only code-capacity cell
# (rel > 0) below its archive by more than the bar counts only where an
# independent run confirms its level (there a float64 numpy oracle). Here
# that run is the JAX package's own campaign at the cell, 10k trials
# (grid indices 2-7): bp-only from results/validation_r3/validation.json,
# notebooks-bp from results/validation_r4_notebooks/validation.json
JAX_CONFIRM = {
    "bp-only": {
        C72: [0.0001, 0.0002, 0.0008, 0.0053, 0.0353, 0.1814],
        C90: [0.0, 0.0, 0.0003, 0.0011, 0.0098, 0.1075],
        C108: [0.0, 0.0, 0.0, 0.0015, 0.0083, 0.0869],
        C144: [0.0, 0.0, 0.0001, 0.0014, 0.0086, 0.0706],
        C288: [0.0, 0.0001, 0.0002, 0.0017, 0.0127, 0.0653],
    },
    "notebooks-bp": {
        C72: [0.0001, 0.0004, 0.001, 0.0072, 0.0496, 0.2676],
        C90: [0.0, 0.0, 0.0006, 0.0021, 0.018, 0.2025],
        C108: [0.0, 0.0, 0.0, 0.0028, 0.0152, 0.1655],
        C144: [0.0, 0.0, 0.0002, 0.0025, 0.0156, 0.1317],
        C288: [0.0, 0.0002, 0.0004, 0.003, 0.0211, 0.1218],
    },
}

# results/bp_iteration_r5 and docs/bp_iteration.md: BP(10..90) + OSD-0 at
# p = 0.01, flat in max_iter, 10k trials
BP_ITER_REF = {C72: 0.0017, C144: 0.0011}
BP_ITER_REF_TRIALS = 10_000

# The JAX engine at equal seeds (python3 scripts/jax_reference_counters.py
# --only complete spectrum alpha rework-minsum, CPU): the complete preset
# on the [[72]] DEM, batch 128, 128 trials at rate i with seed i: p ->
# obs-err
COMPLETE72_TRIALS = 128
COMPLETE72_REF = dict(zip(LOGSPACE_GRID, [0.21875, 0.4140625, 0.65625, 0.921875, 0.9921875,
                                          1.0, 1.0, 1.0]))
# the spectrum preset, 4,096 trials, seed 0: code -> (LER, OSD rate)
SPECTRUM_TRIALS = 4096
SPECTRUM_REF = {
    C72: (0.0, 0.0),
    C90: (0.0, 0.0),
    C108: (0.0, 0.0),
    C144: (0.0, 0.000244140625),
    C288: (0.0, 0.0),
}
# rework-minsum at its first two rates, 1,024 trials at seed i, alpha
# fitted at seed 17 i: code -> {p: (alpha, BP failures, mean BP
# iterations, LER)}
RM_TRIALS = 1024
RM_REF = {
    C72: {0.1: (0.3116699665695026, 975, 46.8212890625, 0.6904296875),
          0.06: (0.4325147956047871, 434, 22.7177734375, 0.2548828125)},
    C144: {0.1: (0.3156756390689138, 1021, 48.8642578125, 0.740234375),
           0.06: (0.43056946895133225, 651, 33.474609375, 0.1640625)},
}

MIN_EVENTS = 25
MAX_TRIALS = 100_000


def bar(ref: float, n_ref: int, got: float, n_got: int, rel: float = 0.0) -> float:
    """4 sigma of the difference of two binomial rates, plus 2 / min(n),
    plus ``rel`` times the reference."""
    var = ref * (1 - ref) / n_ref + got * (1 - got) / n_got
    return 4 * math.sqrt(var) + 2.0 / min(n_ref, n_got) + rel * ref


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

    def run(self, spec, label: str, fixed: bool = False) -> dict:
        """One run_experiment call; returns {code: {p: counters dict}}.
        ``fixed`` keeps the spec's trials (a run held to the JAX package's
        counters at equal seeds) when the campaign is cut down."""
        if self.codes:
            spec = spec.replace(codes=[c for c in spec.codes if c in self.codes])
        if self.trials and not fixed:
            spec = spec.replace(trials=self.trials,
                                batch_size=min(spec.batch_size, self.trials))
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
             ref, n_ref: int, rel: float = 0.0, confirm=None, **note) -> None:
        """A cell within ``bar`` of ``ref``, or recorded where ref is None.
        ``confirm``, the JAX package's value at the cell, applies the BETTER
        rule (JAX_CONFIRM) to a cell below ``ref`` by more than its bar."""
        n = sum(d["trials"] for d in parts)
        hits = sum(round(d[metric] * d["trials"]) for d in parts)
        got = hits / n
        row = dict(preset=preset, code=code, p=p, metric=metric, got=got, count=hits,
                   trials=n, **note)
        status = "recorded"
        if ref is not None:
            tol = bar(ref, n_ref, got, n, rel)
            row.update(ref=ref, ref_trials=n_ref, rel=rel, tol=tol, ok=abs(got - ref) <= tol)
            status = "OK" if row["ok"] else "OUTSIDE"
            if not row["ok"] and confirm is not None and got < ref:
                ctol = bar(confirm, JAX_HELD_TRIALS, got, n, rel)
                row.update(better=True, confirm=confirm, confirm_tol=ctol,
                           ok=abs(got - confirm) <= ctol)
                status = (f"BETTER, {'confirmed' if row['ok'] else 'UNCONFIRMED'} by the "
                          f"JAX package's {confirm} +-{ctol:.5f}")
        self.cells.append(row)
        print(f"  {preset:24s} {code:16s} p={p:<9.6g} {metric:4s} {got:.5f} ({hits}/{n})"
              + ("" if ref is None else f" ref {ref} +-{row['tol']:.5f}") + f" {status}",
              flush=True)

    def same(self, preset: str, code: str, p: float, metric: str, got, ref) -> None:
        """A cell held equal to the JAX package's value."""
        ok = got == ref
        self.cells.append(dict(preset=preset, code=code, p=p, metric=metric, got=got,
                               ref=ref, tol=0.0, ok=ok))
        print(f"  {preset:24s} {code:16s} p={p:<9.6g} {metric:4s} {got!r} ref {ref!r} "
              f"{'OK' if ok else 'OUTSIDE'}", flush=True)


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


@contextlib.contextmanager
def transform_samples():
    """Counts the samples OSD sends through the transform elimination past
    K4's block (OSD-0: those past the factored column budget) while open:
    yields a one-item list that holds the count."""
    from qldpc_tpu_torch.decoders.osd import OSDDecoder

    count = [0]
    transform = OSDDecoder._transform_osd

    def counted(self, order, *a):
        count[0] += order.shape[0]
        return transform(self, order, *a)

    with mock.patch.object(OSDDecoder, "_transform_osd", counted):
        yield count


def complete_bposd(c: Campaign) -> None:
    """The preset as shipped (bf16 streams), then with float32 streams, each
    held to the JAX package's cells of its stream dtype."""
    shipped = get_preset("complete-bposd")
    for streams, refs, refs288 in (("bfloat16", CIRCUIT_BF16_REF, CIRCUIT_288_BF16_REF),
                                   ("float32", CIRCUIT_REF, CIRCUIT_288_REF)):
        label = "complete-bposd" + ("" if streams == "bfloat16" else "-f32")
        spec = shipped.replace(name=label, bp_stream_dtype=streams)
        res = c.run(spec, label)
        for code, cells in res.items():
            for i, p in enumerate(spec.rates_for(code)):
                ref = refs.get(code, {}).get(p)
                parts = [cells[p]]
                if ref is not None:
                    parts += c.top_up(spec, label, code, i, p, cells[p]["trials"], ref[0])
                for k, metric in enumerate(("ler", "osd")):
                    c.gate(label, code, p, parts, metric, None if ref is None else ref[k],
                           CIRCUIT_REF_TRIALS)
        if c.codes and C288 not in c.codes:
            continue
        # the archive pair came from the TPU's factored route, which returns
        # the samples past its column budget unsolved: held to a run of that
        # route; the preset as shipped (those samples through the transform,
        # as the JAX lanes path solves them) recorded beside it
        gate288 = spec.replace(name=f"{label}-288-factored", codes=[C288],
                               error_rates=list(refs288), trials=CIRCUIT_288_TRIALS,
                               osd_backend="factored")
        for p, d in c.run(gate288, f"{label}-288-factored")[C288].items():
            c.gate(f"{label}-288-factored", C288, p, [d], "ler", refs288[p], CIRCUIT_288_TRIALS)
            c.gate(f"{label}-288-factored", C288, p, [d], "osd", None, 0)
        for p in refs288:
            shipped288 = gate288.replace(name=f"{label}-288", error_rates=[p], osd_backend="auto")
            with transform_samples() as solved:
                d = c.run(shipped288, f"{label}-288-{p:g}")[C288][p]
            sigma = math.sqrt(d["ler"] * (1 - d["ler"]) / d["trials"])
            c.gate(f"{label}-288", C288, p, [d], "ler", None, 0, sigma=sigma,
                   past_budget_solved=solved[0], archive=refs288[p])


def study_mm_bf16(c: Campaign) -> None:
    idx = (5, 6, 7)
    spec = get_preset("study").replace(
        name="study-mm-bf16", bp_backend="pallas", bp_mm_dtype="bfloat16",
        trials=MM_BF16_TRIALS, error_rates=[float(LOGSPACE_GRID[i]) for i in idx],
        per_code_rates=None)
    for code, cells in c.run(spec, "study-mm-bf16").items():
        for i in idx:
            p = float(LOGSPACE_GRID[i])
            c.gate("study-mm-bf16", code, p, [cells[p]], "ler", MM_BF16_REF[code][i],
                   MM_BF16_TRIALS)


def workload(c: Campaign, name: str, spec) -> None:
    """A validate_baseline workload: ``spec`` (a preset with that workload's
    decoder) on the archive's rates, each cell held to the archive, or to
    the JAX package's campaign where that lies outside the archive's bar."""
    ref, n_ref, grid, rel, metric = WORKLOADS[name]
    idx = sorted(next(iter(ref.values())))
    spec = spec.replace(name=name, error_rates=[float(grid[i]) for i in idx],
                        per_code_rates=None)
    res = c.run(spec, name)
    for code, cells in res.items():
        for i, k in enumerate(idx):
            p = float(grid[k])
            held = JAX_HELD.get((name, code, p))
            target, n_target = (ref[code][k], n_ref) if held is None else (held, JAX_HELD_TRIALS)
            parts = [cells[p]] + c.top_up(spec, name, code, i, p, cells[p]["trials"], target)
            note = {} if held is None else dict(held_to="jax r3", archive=ref[code][k])
            confirm = JAX_CONFIRM.get(name, {}).get(code, [None] * 8)[k - 2]
            c.gate(name, code, p, parts, metric, target, n_target, rel,
                   confirm=None if held is not None else confirm, **note)


def recorded(c: Campaign, spec, label: str) -> None:
    """A preset at its own settings, every cell recorded."""
    res = c.run(spec, label)
    for code, cells in res.items():
        for key, d in cells.items():
            if isinstance(key, tuple):  # (max_iter, [osd_order,] p)
                c.gate(label, code, key[-1], [d], "ler", None, 0, config=list(key[:-1]))
            else:
                c.gate(label, code, key, [d], "ler", None, 0)


def paper_gpu(c: Campaign) -> None:
    spec = get_preset("paper-gpu")
    recorded(c, spec, "paper-gpu")
    workload(c, "doubled+osde7", spec.replace(bp_max_iter=200))


def rework(c: Campaign) -> None:
    spec = get_preset("rework")
    recorded(c, spec, "rework")
    workload(c, "rework+osde7", spec.replace(bp_max_iter=50))
    workload(c, "cc+osde7-200", spec.replace(bp_max_iter=200))


def different_orders(c: Campaign) -> None:
    recorded(c, get_preset("different-orders"), "different-orders")


def cc_50k(c: Campaign) -> None:
    workload(c, "bp-only", get_preset("cc-50k").replace(trials=50_000))


def notebooks(c: Campaign, name: str, preset: str) -> None:
    workload(c, name, get_preset(preset))


def bp_iteration(c: Campaign) -> None:
    spec = get_preset("bp-iteration")
    res = c.run(spec, "bp-iteration")
    for code, cells in res.items():
        for (max_iter, p), d in sorted(cells.items()):
            c.gate("bp-iteration", code, p, [d], "ler", BP_ITER_REF.get(code),
                   BP_ITER_REF_TRIALS, max_iter=max_iter)


def complete(c: Campaign) -> None:
    spec = get_preset("complete")
    recorded(c, spec, "complete")
    if c.codes and C72 not in c.codes:
        return
    small = spec.replace(name="complete-72", codes=[C72], trials=COMPLETE72_TRIALS,
                         batch_size=COMPLETE72_TRIALS)
    for p, d in c.run(small, "complete-72", fixed=True)[C72].items():
        c.gate("complete-72", C72, p, [d], "ler", COMPLETE72_REF.get(p), COMPLETE72_TRIALS)


def spectrum(c: Campaign) -> None:
    spec = get_preset("spectrum")
    recorded(c, spec, "spectrum")
    small = spec.replace(name="spectrum-small", trials=SPECTRUM_TRIALS)
    for code, cells in c.run(small, "spectrum-small", fixed=True).items():
        for p, d in cells.items():
            for k, metric in enumerate(("ler", "osd")):
                ref = SPECTRUM_REF.get(code)
                c.gate("spectrum-small", code, p, [d], metric,
                       None if ref is None else ref[k], SPECTRUM_TRIALS)


def rework_minsum(c: Campaign) -> None:
    spec = get_preset("rework-minsum")
    recorded(c, spec, "rework-minsum")
    small = spec.replace(name="rework-minsum-small", trials=RM_TRIALS, codes=list(RM_REF),
                         per_code_rates={code: list(r) for code, r in RM_REF.items()})
    for code, cells in c.run(small, "rework-minsum-small", fixed=True).items():
        for p, d in cells.items():
            alpha, faults, iters, ler = RM_REF[code][p]
            c.same("rework-minsum-small", code, p, "alpha", d["alpha"], alpha)
            c.same("rework-minsum-small", code, p, "BPs_fault", d["BPs_fault"], faults)
            c.same("rework-minsum-small", code, p, "average_iterations",
                   d["average_iterations"], iters)
            c.gate("rework-minsum-small", code, p, [d], "ler", ler, RM_TRIALS)


PRESETS = {"study": study, "study-mm-bf16": study_mm_bf16, "paper": paper,
           "phenomenological": phenomenological,
           "space-time": space_time, "complete-bposd": complete_bposd,
           "paper-gpu": paper_gpu, "rework": rework, "different-orders": different_orders,
           "rework-minsum": rework_minsum, "cc-50k": cc_50k,
           "notebook-bp": lambda c: notebooks(c, "notebooks-bp", "notebook-bp"),
           "notebook-bposd": lambda c: notebooks(c, "notebooks-bposd", "notebook-bposd"),
           "bp-iteration": bp_iteration, "complete": complete, "spectrum": spectrum}


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
