"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. toolchain: torch, CUDA, the card, its power limit, nvcc, triton;
  2. build the kernels K1 (fused BP), K2 (GF(2) elimination), K3 (DEM BP),
     K4 and K4g (transform GF(2) elimination, T in shared or global
     memory), K5a-d (factored GF(2) elimination), K6 (structured space-time
     BP), K7 (layered BP), K8 (the sampler's threefry2x32 counter
     stream) and K9 (classification) with nvcc from qldpc_tpu_torch/ops/csrc/, one nvcc per source,
     all at once;
  2b. K8 against the plain int64 counter stream at the benchmark's shapes
     (1,024 x 66,981, the [[144]] DEM; 65,536 x 144, code capacity), the
     counter wrapping past 2^32: bit for bit, its device ms, the plain
     version's ms and the bound (integer operations, bytes written);
  code capacity, [[144,12,12]]:
  3. K1 (one warp a sample, samples from a work counter; warps a block and
     grid logged) against its plain torch version;
  4. K2 against its plain torch version on the BP failures of phase 3: its
     packed-rows entry and its ordered loader (H's packed columns in each
     sample's order, the OSD decoder's path), each timed;
  5. the Monte-Carlo engine's sweep on the card, with the kernel launch
     counts of that sweep, its LER held against the reference archive, and
     its counters held against the CPU engine on a small input;
  6. BP(50) throughput of K1 and of the plain torch version, at the
     engine's batch of 65,536 syndromes and at 262,144, p = 0.01, and at
     65,536 at p = 0.050119, where samples iterate (6.9 on average);
  6b. K1's bf16-operand instances (``mm_dtype="bfloat16"``) against the
     plain version in bf16 at 65,536 syndromes (K1's standard), timed in
     turns against the float32 instance at p = 0.01; then the experiments
     CLI's ``study`` with ``bp_mm_dtype=bfloat16`` on [[144]] at p =
     0.050119 (every K1 launch a bf16 one; LER within 4 sigma of the JAX
     package's TPU run with bf16 operands);
  circuit level, the [[72,12,6]] memory-experiment DEM (432 x 15765):
  7. K3 against its plain torch version, B = 1024, sum-product and min-sum,
     and its summary path (no stored R) against its message path: bit for
     bit, both timed in turns, their peak memory, the summary path's device
     time per iteration by pass and the bytes each streams per iteration;
  8. K4 against its plain torch version on the BP failures of phase 7
     (threads a block, blocks an SM and panels of 32 columns walked logged);
  9. the DEM engine's sweep at p = 0.001 and 0.002, with the kernel launch
     counts of that sweep, its observable error and OSD invocation rates
     held against docs/circuit_ler.md, and its counters held against the
     CPU DEM engine on a small input, with the transform and with the
     factored elimination;
  10. steady-state trials/s of the DEM engine, with the kernels and with
      their plain versions;
  circuit level, the [[144,12,12]] memory-experiment DEM (1728 x 66981):
  11. K3 as in phase 7, B = 1024, sum-product, p = 0.002;
  12. K5a-d against their plain versions on the BP failures of phase 11:
      the whole elimination on 128 of them, and each kernel at every block
      of one OSD call on all of them (K5a's and K5c's running samples,
      columns before the block and µs logged per block); the factored OSD-0
      solutions against the plain transform elimination's on 32;
  12b. K9 (classification) against the plain ``_classify`` on one batch of
      each benchmark cell's shape (65,536 x 144, code capacity; 16,384 x
      2,592, the [[144]] space time at T = 12; 1,024 x 66,981, phase 11's
      DEM engine): every counter identical, its ms, device ms, the plain
      version's ms on the card and the bound (the bytes it reads once);
  13. the DEM engine's sweep at p = 0.001 and 0.002 (launches K3 and K5a-d,
      never K4), held against docs/circuit_ler.md, and its counters held
      against the CPU DEM engine on 16 trials;
  14b. K3's bf16-stream instances (``stream_dtype="bfloat16"``) on the
      batch of phase 11, sum-product and min-sum, against the plain version
      in bf16 (K3's standard) and summary path against message path bit for
      bit; the four instances (float32 and bf16, summary and message paths)
      timed in turns, their device ms per pass and bytes per iteration; the
      DEM engine's trials/s at p = 0.001 with float32 and with bf16 streams,
      in turns;
  14c. OSD-e(7) past K4's block (the route "factored+transform") on 128
      BP failures of phase 11's engine at p = 0.002, each with a detector
      flipped that a dependency of H's rows involves (outside H's image):
      K4g (a cluster of blocks a sample, pivot-first panels; its cluster
      width and where T lives logged) against its plain version, T, b, rank
      and piv bit for bit, every lane at rank(H), both timed; the OSD-e stage
      through the decoder (K5a-d, K4g, the search), its ms, K4g's launches
      (the kernels line's) and peak memory; no cost above the transform's
      OSD-0; after those timings, the card's solutions against the CPU
      decoder's on 32 of the lanes; K4g's bound from the work this input
      needs (the plain run's row operations; in a panel without a pivot
      only the rows at or below the rank);
  14d. the experiments CLI's ``complete-bposd`` on the [[144]] DEM, one
      batch of 1,024 at p = 0.002, with ``--set osd_order=7`` and with 0 at
      the same seed: equal counters (in-image syndromes: OSD-e is OSD-0
      after the consistency test; K5a-d launch, and K4g as often under both
      orders, on samples past the factored column budget);
  space-time, [[144,12,12]] at T = 12 (H_st 864 x 2592), the space-time
  preset's BP(100) + OSD-0 at batch 512:
  15. K6 (one sample over a cluster of blocks) against its plain torch
      version, sum-product and min-sum, p = 0.008, and K6 timed on the batch,
      on its non-converging lanes alone and on one of them alone (the ms per
      iteration of one sample);
  16. K4 against its plain version on the BP failures of phase 15, timed
      there (its geometry logged), and the OSD-0 solutions against the
      plain row elimination's;
  17. the space-time engine's sweep at p = 0.004 and 0.008 (launches K6 and
      K4, never K2), its counters held against the CPU engine on small
      inputs and against the JAX engine's recorded ones (min-sum identical,
      sum-product LER and OSD rate within 4 sigma);
  layered schedule, code capacity [[144,12,12]], BP(50) + OSD-0:
  19. K7 (one warp a sample, samples from a work counter) against its plain
      torch version, B = 65,536, p = 0.050119, and both per-call times;
  20. the layered engine at p = 0.050119 (launches K7 and K2), its LER held
      against the JAX layered engine's and its counters against the CPU
      engine on a small input;
  the experiments CLI and the rest of the circuit-level family:
  21. ``python -m qldpc_tpu_torch.experiments.cli run complete-bposd`` on the
      [[90,8,10]] and [[108,8,10]] DEMs at p = 0.001 and 0.002, 10,240
      trials, the preset unchanged: bf16 streams (launches K3's bf16
      instances and K4, never K5), read back from its npz: obs-err and OSD
      rate within 4 sigma of the JAX package's bf16 cells
      (results/circuit_bf16_val_r5, docs/circuit_ler.md:25-34);
      then K4 against its plain version on each DEM's BP failures, with and
      without the b-exit (900 and 1,080 rows); each code's K4 geometry and
      trials/s logged;
  22. checkpointed runs on the card: the [[144]] code-capacity engine and the
      [[72]] DEM engine interrupted after 2 batches and resumed, equal to an
      uninterrupted run and to the same rate run through the CLI;
  23. the [[288,12,18]] DEM (5,184 x 204,765): one batch of 1,024 at p =
      0.003 through run_experiment with the preset's OSD-0 (float32
      streams): K5a-d on every BP failure, K4g on those past the factored
      column budget, which the JAX lanes path (no budget) solves too (obs-err
      and logical errors, OSD rate, K4g's launches and lanes, peak memory;
      K4g's launches there are the kernels line's); K3 against its plain
      version on 256 samples of a batch (sum-product and min-sum), K5a-d
      against their plain versions at blocks 0 and 1 of one OSD call; on a
      second batch's BP failures, those past the budget counted, K4g on
      them against its plain version (T, b, rank, piv bit for bit) and
      timed, the decoder's solutions on them equal to the plain transform's
      OSD-0 and each satisfying its syndrome (``osd0_288`` in K4g's row); K5's device ms over a whole OSD
      call and K5a's and K5b's products as float16 ``torch.bmm`` over the
      same blocks (``at_288`` in K5's rows of the kernels line);
  23b. OSD-e(7) past K4's block on 4 BP failures of phase 23's engine, as
      in 14c without the CPU decoder: K4g against its plain version (the
      lanes walk up to 95,481 columns: the plain version's loop takes about
      a minute) and the OSD-e stage;
  23c. K4g past 9,312 rows (its spilled layout) on synthetic wide systems of
      9,313, 12,288 and 20,736 rows, a lane each outside H's image, walking
      to rank(H), built packed (``synthetic_wide``): T, b, rank and piv bit
      for bit against the plain version, device ms and the bound of each
      size (``past_9312`` in K4g's row);
  24. [[288,12,18]] space-time at T = 18 (H_st 2,592 x 7,776): the card
      engine's min-sum counters against the CPU engine's on 16 trials, K5a-d
      at blocks 0 and 1 on H_st, the OSD-0 solutions against the plain row
      elimination's, and the LER and OSD rate at p = 0.004 and 0.008 on
      1,024 trials each (K6 and K5); the card engine's min-sum counters
      against the JAX engine's recorded ones (batch 32, 128 trials),
      identical; then K4g against its plain version on 8 of the batch's BP
      failures at p = 0.008 without the b-exit (H_st's rows are
      independent: every lane walks to rank(H)), bit for bit
      (scripts/probe_k4g.py times it), and OSD-e(7) through the decoder on
      the same lanes, no solution costing more than the transform's OSD-0;
  25. rescue_iters = 10 on the [[144]] code-capacity engine: counters equal
      to a single BP(50) run's, both timed;
  OSD-e and the Alvarado alpha:
  26. OSD-e(7) on the rows path: a [[144]] phenomenological batch (B = 4,096,
      p = 0.03, BP(50) min-sum), whose flipped syndrome bits leave H's image:
      K2's packed-rows loader on the inconsistent BP failures against its
      plain version (A, b, piv) and the ordered loader's (b, piv), the card's
      OSD-e solutions against the CPU's on 512, every cost at most OSD-0's,
      the search's and the OSD-e stage's ms and peak memory; then the
      engine's counters on 512 trials against the JAX engine's (K1 and both
      K2 loaders launch);
  27. OSD-e(7) on the transform path: the [[72]] DEM's BP failures at
      p = 0.002 with a detector flipped each: K4 (b-exit on) against its
      plain version on 128 inconsistent lanes, every inconsistent lane at
      rank(H), the solutions against the CPU's on 16, costs at most OSD-0's;
  28. estimate_alpha min-sum on [[144]] at p = 0.1 on the card, equal to the
      CPU's and to the JAX package's recorded value;
  several processes (``qldpc_tpu_torch.parallel``, gloo; a process a rank):
  29. ``parallel.smoke``'s workers, 2 ranks sharing cuda:0, on [[144]] code
      capacity BP(50) + OSD-0 (batch 65,536, 32,768 a rank, 262,144 trials at
      p = 0.050119, and 1,310,720 for the trials/s; K1, K2), [[144]]
      space-time T = 12 (batch 512, 10,240 trials at p = 0.008; K6, K4) and
      the [[72]] DEM (batch 1,024, 4 batches at p = 0.002; K3, K4), then 4
      ranks on a (rate 2, mc 2) mesh over [[144]] code capacity at three
      rates, and on a host of two or more cards a rank a card: every counter
      identical to this process's run at the same seed, each rank's kernel
      launches counted, trials/s at 1 and at N ranks logged;
  30. the experiments CLI under ``torchrun --standalone --nproc-per-node 2``
      (``study`` on [[144]], checkpoints on): its npz equal to the
      one-process CLI's, the same files written once, one rank printing.
Before the last it prints the card's name and power limit and the kernels'
JSON record (each kernel's launches on its path; its time between CUDA
events around its calls, ``ms``, which holds the host's launch work where a
call is short, and on the device alone, ``device_ms``, the events queued
behind a spin kernel; its plain version's time; and its bound: the larger
of the bytes it must move over 3.35 TB/s and the operations it must do
over 67 T/s, the card's non-tensor 32-bit peak, which also bounds its
integer issue rate); the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1 and
prints no result. K1's row in the kernels line also holds its record at
p = 0.050119, K2's (its ordered loader's, the path's) its packed-rows
entry's and the packed-rows loader's launches and device ms on the OSD-e
path (phase 26), K4's its record on the space-time failures and its
launches on the OSD-e path (phase 27), and K5a-d's their device ms over one
OSD call at the [[288]] DEM (phase 23). The row ``gf2_transform_elim_global``
is K4g, which computes the JAX package's XLA transform elimination
(qldpc_tpu/decoders/osd.py:492), not a Pallas kernel: its launches are
OSD-0's in phase 23's run (``osd0_288``: its lanes there and K4g's times
on a second batch's samples past the budget), its times phase 14c's
(``osde_launches``: the OSD-e stage's there) and, under ``at_288`` and
``past_9312``, phase 23b's and 23c's.
K5a's and K5b's rows hold ``library_ms``: the same GF(2) products as
``torch.bmm`` of the unpacked 0/1 operands in float16, accumulated in
float32, summed over one OSD call (phase 12; at the [[288]] DEM under
``at_288``, phase 23).
The rows ``bp_flooding_bf16`` and
``dem_bp_bf16`` are K1's and K3's bf16 instances: their launches are those of
the CLI runs of phases 6b and 21, their times those of phases 6b and 14b
(beside the float32 instance's device ms in turns, and for K3 its message
path's).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from benchmark.roofline import HBM_BYTES_PER_S, PEAK_F32_OPS_PER_S

CODE = "[[144, 12, 12]]"
# BP(50)+OSD-0 LER of [[144,12,12]] at p = 0.050119 in the reference's
# notebooks/data/BPOSD.npz, 10,000 trials (BASELINE.md table 3).
REF_LER, REF_TRIALS, REF_P = 0.0499, 10_000, 0.050119
DECISION_TOL = 1e-4  # share of lanes allowed to differ in decision (K1)
VALUE_TOL = 1e-5  # rtol = atol on the posteriors of agreeing lanes (K1)
K1_BATCH = 65536  # syndromes per K1 comparison
ENGINE_BATCH, ENGINE_TRIALS = 65536, 262144  # per error rate
THROUGHPUT_BATCH = 262144

DEM_CODE, DEM_ROUNDS = "[[72, 12, 6]]", 6
# BP(50)+OSD-0 on the Z-memory DEMs with float32 streams, 10,000 trials per
# rate (docs/circuit_ler.md:39-48 and :72-81): p -> (observable error rate,
# OSD invocation rate, mean BP iterations)
DEM_REF = {0.001: (0.0102, 0.424, 26.5), 0.002: (0.0689, 0.700, 38.8)}
DEM144_CODE, DEM144_ROUNDS = "[[144, 12, 12]]", 12
DEM144_REF = {0.001: (0.0009, 0.894, 46.5), 0.002: (0.0264, 0.993, 48.9)}
DEM_REF_TRIALS = 10_000
DEM_BATCH, DEM_TRIALS = 1024, 10_240  # per error rate
K3_DECISION_TOL = 1  # lanes in 1024 allowed to differ in decision (K3)
# trials on which the card's DEM engines are held to the CPU's, bit for bit
# (cut from 256 and 32 to make room for OSD-e past K4's block)
DEM_CPU_TRIALS, DEM144_CPU_TRIALS = 128, 16
# BP(50)+OSD-0 LER of [[144,12,12]] at p = 0.05012 from the JAX package's
# TPU run with bf16 matmul operands, 10,000 trials
# (results/validation_r5_bf16mxu/validation.md)
MM_REF_LER, MM_REF_TRIALS = 0.0442, 10_000
K5_CHECK_LANES, SOLUTION_LANES = 128, 32
K4_NO_EXIT_LANES = 128  # BP failures K4 is held on without the b-exit

# the space-time preset (qldpc_tpu/experiments/configs.py:184-188) at its
# central code, rounds = distance
ST_CODE, ST_ROUNDS, ST_BATCH, ST_ITERS = "[[144, 12, 12]]", 12, 512, 100
ST_RATES, ST_TRIALS, ST_SEED = (0.004, 0.008), 10_240, 0  # sweep: rate i, seed + i
ST_CPU_CHECKS = (("[[144, 12, 12]]", 12, 32), ("[[72, 12, 6]]", 6, 512))  # code, T, trials
# The JAX engine's counters at [[144,12,12]], T = 12, batch 512, p = 0.008,
# 4,096 trials, seed 1 (the sweep's seed at p = 0.008), recorded on the CPU
# (XLA) with `python3 scripts/jax_reference_counters.py --only st144-min-sum
# st144-sum-product`: BP(100) min-sum + OSD-0 (every counter, histograms as
# {weight: count}) and the preset's BP(100) sum-product + OSD-0.
JAX_ST_P, JAX_ST_TRIALS, JAX_ST_SEED = 0.008, 4096, 1
JAX_ST_MIN_SUM = {
    "trials": 4096, "residual_logicals": 62, "BPs_fault": 445, "BPs_miscorrected": 2,
    "incorrectable": 60, "degeneracy_count": 134, "bp_converged": 3651, "osd_overflow": 0,
    "logical": 0.01513671875, "osd": 0.108642578125, "degeneracies": 0.03271484375,
    "OSD_invocation_AND_logicalError": 0.014892578125, "average_iterations": 15.26611328125,
    "ler": 0.01513671875, "ler_notebook": 0.123779296875,
    "weights_found_BP": {0: 40, 6: 13},
    "weights_found_OSD": {0: 15, 1: 59, 2: 3, 3: 2, 6: 2},
    "weights_found_BP_error": {1: 1},
    "weights_found_OSD_error": {1: 49, 2: 9, 3: 2, 8: 1},
}
JAX_ST_SUM_PRODUCT = {"ler": 0.013916015625, "osd": 0.04443359375,
                      "average_iterations": 6.307373046875}
# The JAX engine's counters at [[288,12,18]] space-time, T = 18, BP(100) min-sum
# + OSD-0, batch 32, p = 0.008, 128 trials, seed 1, recorded on the CPU (XLA,
# 651 s) with `python3 scripts/jax_reference_counters.py --only st288-min-sum`
# (results/jax_counters_st288_min_sum.jsonl). The JAX decoder solves every BP
# failure (its lanes path has no column budget), as the port's route does.
JAX_ST288_P, JAX_ST288_TRIALS, JAX_ST288_SEED, JAX_ST288_BATCH = 0.008, 128, 1, 32
JAX_ST288 = {
    "trials": 128, "logical": 0.0234375, "osd": 0.2265625, "degeneracies": 0.046875,
    "OSD_invocation_AND_logicalError": 0.0234375, "average_iterations": 30.140625,
    "ler": 0.0234375, "residual_logicals": 3, "ler_notebook": 0.25, "BPs_fault": 29,
    "BPs_miscorrected": 0, "incorrectable": 3, "degeneracy_count": 6, "bp_converged": 99,
    "osd_overflow": 0,
    "weights_found_BP": {},
    "weights_found_OSD": {0: 4, 1: 2},
    "weights_found_BP_error": {},
    "weights_found_OSD_error": {1: 3},
}
# The JAX layered engine (BP(50) sum-product, L = 4, + OSD-0) at [[144,12,12]]
# code capacity, batch 65,536, p = 0.050119, 65,536 trials, seed 0, recorded
# with `python3 scripts/jax_reference_counters.py --only layered144`.
LAYERED_BATCH, LAYERED_SEED = 65536, 0
JAX_LAYERED = {"trials": 65536, "ler": 0.0420684814453125, "osd": 0.0476531982421875,
               "average_iterations": 4.8182220458984375}

# OSD-e on the phenomenological channel of [[144,12,12]] (flipped syndrome
# bits decoded on H: about 98% of the syndromes leave H's image, so the
# pattern search runs on almost every BP failure), BP(50) min-sum + OSD-e(7)
PH_CODE, PH_P, PH_BATCH, PH_ORDER = "[[144, 12, 12]]", 0.03, 4096, 7
OSDE_CPU_LANES = 512  # of the batch's failures, decoded again on the CPU
OSDE_DEM_CPU_LANES = 16  # of the [[72]] DEM's flipped failures, on the CPU
# OSD-e past K4's block: BP failures whose syndromes leave H's image, K4g
# held on them (all of them at [[144]], 4 at [[288]]), 32 decoded on the CPU
OSDE_WIDE_P, OSDE_WIDE_LANES, OSDE_288_LANES, OSDE_WIDE_CPU_LANES = 0.002, 128, 4, 32
# The JAX engine's counters there at batch 512, 512 trials, seed 0 (every
# counter, histograms as {weight: count}), recorded on the CPU (XLA, 5.6 s)
# with `python3 scripts/jax_reference_counters.py --only ph144-osde7`.
JAX_PH_OSDE7_TRIALS, JAX_PH_OSDE7_SEED = 512, 0
JAX_PH_OSDE7 = {
    "trials": 512, "logical": 0.861328125, "osd": 0.900390625, "degeneracies": 0.00390625,
    "OSD_invocation_AND_logicalError": 0.861328125, "average_iterations": 44.849609375,
    "ler": 0.861328125, "residual_logicals": 441, "ler_notebook": 1.76171875, "BPs_fault": 461,
    "BPs_miscorrected": 324, "incorrectable": 117, "degeneracy_count": 12, "bp_converged": 51,
    "osd_overflow": 0,
    "weights_found_BP": {6: 1},
    "weights_found_OSD": {1: 1, 2: 1, 4: 1, 5: 2, 6: 4, 7: 1, 19: 1},
    "weights_found_BP_error": {},
    "weights_found_OSD_error": {
        1: 3, 2: 1, 3: 3, 4: 1, 5: 5, 6: 13, 7: 9, 8: 10, 9: 23, 10: 23, 11: 23, 12: 24,
        13: 35, 14: 34, 15: 30, 16: 21, 17: 31, 18: 22, 19: 31, 20: 19, 21: 8, 22: 3, 23: 4,
        24: 3, 25: 8, 26: 8, 27: 5, 28: 6, 29: 6, 30: 5, 31: 7, 32: 5, 33: 2, 34: 1, 36: 2,
        37: 3, 38: 2, 41: 1, 45: 1},
}
# estimate_alpha min-sum on [[144,12,12]] at p = 0.1, seed 0 (5,120 samples,
# float32 draws), recorded with `python3 scripts/jax_reference_counters.py
# --only alpha-144-0.1` (4.6 s of CPU)
ALPHA_CODE, ALPHA_P, ALPHA_SEED, JAX_ALPHA = "[[144, 12, 12]]", 0.1, 0, 0.3156756390689138

# Phases 29-30: the full-width cases that several processes run, each against
# this process alone at the same seed (parallel.smoke's case format), and the
# kernels each must launch on every rank.
MESH_CASES = [
    dict(name="cc144", code=CODE, channel="code-capacity", batch=ENGINE_BATCH, max_iter=50,
         rates=[REF_P], trials=ENGINE_TRIALS, seed=1, warm=True),
    dict(name="cc144-long", code=CODE, channel="code-capacity", batch=ENGINE_BATCH,
         max_iter=50, rates=[REF_P], trials=20 * ENGINE_BATCH, seed=2),
    dict(name="st144", code=ST_CODE, channel="space-time", n_rounds=ST_ROUNDS, batch=ST_BATCH,
         max_iter=ST_ITERS, rates=[0.008], trials=ST_TRIALS, seed=1, warm=True),
    dict(name="dem72", code=DEM_CODE, channel="dem", rounds=DEM_ROUNDS, batch=DEM_BATCH,
         max_iter=50, rates=[0.002], trials=4 * DEM_BATCH, seed=1, warm=True),
]
MESH_RATE_CASE = dict(name="cc144-rate-sharded", code=CODE, channel="code-capacity",
                      batch=ENGINE_BATCH, max_iter=50, rates=[0.01, 0.03, REF_P],
                      trials=ENGINE_TRIALS, seed=0, rate_shards=2, warm=True)
CC_KERNELS = ("bp_flooding_cuda", "eliminate_ordered_cuda")
MESH_KERNELS = {"cc144": CC_KERNELS, "cc144-long": CC_KERNELS, "cc144-rate-sharded": CC_KERNELS,
                "st144": ("st_bp_cuda", "eliminate_transform_cuda"),
                "dem72": ("dem_bp_cuda", "eliminate_transform_cuda")}
MESH_TIMEOUT = 300  # seconds, for one multi-process launch
MESH_CLI_ARGS = ["run", "study", "--codes", CODE, "--trials", str(2 * ENGINE_BATCH),
                 "--batch-size", str(ENGINE_BATCH), "--error-rates", "0.03", str(REF_P)]

# the H100 SXM's 32-bit integer rate: 64 INT32 lanes an SM, 132 SMs, at its
# 1,980 MHz boost clock
INT_OPS_PER_S = 64 * 132 * 1.98e9
# K8's integer operations a counter pair: threefry2x32's 72 (two key adds,
# 20 rounds of an add, a rotate and a XOR, five injections of two adds),
# the counter's add and two conversions of a shift, a convert and a multiply
K8_OPS_PER_PAIR = 78
# K8 at the benchmark's shapes: (samples, uniforms a sample)
K8_SHAPES = {"dem": (1024, 66981), "code_capacity": (65536, 144)}
# K9 at the benchmark's cells (phase 12b): the code-capacity batch at
# p = 0.014360, the space-time batch at p = q = 0.004, the [[144]] DEM's at
# p = 0.001
K9_CC = dict(batch=65536, p=0.014360)
K9_ST = dict(batch=16384, rounds=12, p=0.004, max_iter=100)
K9_DEM_P = 0.001
# float32 operations per real edge and BP iteration: the check rule (tanh,
# the leave-one-out products or log/exp sums, clamp, atanh, scaling) and the
# variable side (one add into the posterior, one subtraction per message)
BP_OPS_PER_EDGE = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


SPIN_CYCLES = 4_000_000  # about 2 ms of the card's clock: longer than a launch's host work


def launch_ms(fn) -> tuple[float, object]:
    """Device ms of the launches ``fn()`` makes, and its result: CUDA events
    around it, with the card held busy by a spin kernel until the host has
    queued them, so that the host's launch work falls inside the spin and
    not between the events (after a synchronize, one small launch spends
    longer on the host than on the card)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    ev[0].record()
    out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]), out


def device_ms(fn, reps: int) -> float:
    """Mean device ms of one ``fn()`` over ``reps`` calls after one warm-up,
    each call timed by ``launch_ms``."""
    fn()
    return sum(launch_ms(fn)[0] for _ in range(reps)) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def popcount(words: torch.Tensor) -> int:
    """Set bits of int32 words holding uint32 patterns."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return int((((v * 0x01010101) & 0xFFFFFFFF) >> 24).sum())


def bound(moved: float, ops: float, peak: float = PEAK_F32_OPS_PER_S) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate, whichever is larger."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def bp_bound(syn, priors, tables, iters, edges: int) -> dict:
    """A BP call reads the syndromes, priors and tables once and writes the
    posteriors, convergence flags and iterations; it runs each sample's
    iterations over every real edge."""
    B, n = syn.shape[0], priors.shape[-1]
    moved = nbytes(syn, priors, *[getattr(tables, f) for f in tables.__dataclass_fields__])
    moved += B * n * 4 + B + B * 4
    return bound(moved, float((iters.to(torch.int64) + 1).sum()) * edges * BP_OPS_PER_EDGE)


def phase_toolchain(card_line: str) -> None:
    from qldpc_tpu_torch._build import nvcc_path

    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {card_line}")
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    log(f"nvcc: {nvcc.splitlines()[-1]}")
    try:
        import triton  # noqa: F401  (a probe for later work, not a path)

        log(f"triton {triton.__version__} importable")
    except ImportError:
        log("triton not importable")


def phase_build() -> None:
    from qldpc_tpu_torch.ops import (
        bp_cuda,
        bp_layered_cuda,
        dem_bp_cuda,
        osd_cuda,
        osd_factored_cuda,
        osd_transform_cuda,
        classify_cuda,
        spacetime_bp_cuda,
        threefry_cuda,
    )

    libs = [m._LIB for m in (bp_cuda, osd_cuda, dem_bp_cuda, osd_transform_cuda,
                             osd_factored_cuda, spacetime_bp_cuda, bp_layered_cuda,
                             threefry_cuda, classify_cuda)]
    libs.append(osd_transform_cuda._GLOBAL_LIB)

    def build(lib):
        t0 = time.perf_counter()
        path = lib.build()
        return path, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        built = list(pool.map(build, libs))
    for lib, (path, secs) in zip(libs, built):
        log(f"built {lib.source.name} -> {path.name} in {secs:.2f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
        lib.lib  # load it and bind the entry points
    log(f"all kernels built in {time.perf_counter() - t0:.2f} s")


def phase_k8(card_line: str) -> dict:
    """K8 against the plain int64 counter stream at the benchmark's DEM and
    code-capacity shapes, the counter wrapping past 2^32 inside the batch:
    bit for bit; its ms, device ms, the plain version's ms on the card and
    the bound (operations at the integer rate, bytes written)."""
    from qldpc_tpu_torch.ops.threefry_cuda import counter_uniform_cuda, launch_shape
    from qldpc_tpu_torch.utils import rng

    dev = torch.device("cuda:0")
    k = rng.fold_in(rng.fold_in(rng.key(2024), 11), 3)
    recs = {}
    for label, (B, stride) in K8_SHAPES.items():
        P = (stride + 1) // 2
        first = 2**32 // P - B // 2

        def kernel():
            return counter_uniform_cuda(k, first, B, stride, dev)

        def plain():
            return rng.counter_uniform_plain(k, first, B, stride, device=dev)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"K8 {label}: the uniforms differ from the plain version")
        del got, want
        ms = cuda_ms(kernel, reps=20)
        dev_ms = device_ms(kernel, reps=20)
        plain_ms = cuda_ms(plain, reps=3)
        ops, moved = B * P * K8_OPS_PER_PAIR, B * stride * 4
        b = bound(moved, ops, INT_OPS_PER_S)
        log(f"K8 {label} {B} x {stride}: bit for bit; geometry (bx, gy, grid) "
            f"{launch_shape(B, P)}; {ms:.4f} ms ({dev_ms:.4f} on the device, "
            f"{ops / dev_ms * 1e-9:.2f} T integer operations/s, "
            f"{moved / dev_ms * 1e-9:.3f} TB/s written); plain {plain_ms:.3f} ms; "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}: {ops:.4g} operations, "
            f"{moved:.4g} bytes) on {card_line}")
        recs[label] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, shape=[B, stride], **b)
    return dict(recs["dem"], max_abs_err=0.0, code_capacity=recs["code_capacity"])


def phase_k9(dev, card_line: str, dem_eng) -> dict:
    """K9 against the plain ``_classify`` on one batch of each benchmark
    cell's shape (its stages' outputs at the cell's p): every counter field
    identical; its ms, device ms, the plain version's ms on the card and the
    bound (errors, correction, syndrome and the per-sample bytes read once,
    the counters written once)."""
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig
    from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine
    from qldpc_tpu_torch.ops.classify_cuda import launch_shape
    from qldpc_tpu_torch.utils import rng

    code = get_code(CODE)
    engines = {
        "code_capacity": (MonteCarloEngine(code, EngineConfig(
            bp=BPConfig(max_iter=50), batch_size=K9_CC["batch"]), device=dev), K9_CC["p"]),
        "space_time": (MonteCarloEngine(code, EngineConfig(
            bp=BPConfig(max_iter=K9_ST["max_iter"]), channel="space-time",
            n_rounds=K9_ST["rounds"], batch_size=K9_ST["batch"]), device=dev), K9_ST["p"]),
        "dem": (dem_eng, K9_DEM_P),
    }
    recs = {}
    for label, (eng, p) in engines.items():
        errors, syn, priors = eng._sample(rng.fold_in(rng.key(2024), 9), p)
        res = eng._decode(syn, priors, float(np.float32(eng.config.bp.alpha)))
        final = eng._post_process(syn, res)[0]
        B = errors.shape[0]
        valid = torch.ones(B, dtype=torch.bool, device=dev)

        def kernel():
            return eng._classify(errors, final, syn, res, valid)

        def plain():
            return eng._classify_plain(errors, final, syn, res, valid)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        for name, g, w in zip(got._fields, got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"K9 {label}: {name} differs from the plain version")
        ms = cuda_ms(kernel, reps=20)
        dev_ms = device_ms(kernel, reps=20)
        plain_ms = cuda_ms(plain, reps=5)
        moved = nbytes(errors, final, syn, res.converged, res.iterations, valid) + nbytes(*got)
        b = bound(moved, 0.0)
        warps, unroll = launch_shape(eng.n_vars)
        log(f"K9 {label} {B} x {eng.n_vars} (m {eng.m_checks}, T {eng._k9.T}): every "
            f"counter identical ({int(got.logical_errors)} logical errors, "
            f"{int(got.degeneracies)} degeneracies); {warps} warp(s) a sample, {unroll} word(s) a "
            f"thread a step; "
            f"{ms:.4f} ms ({dev_ms:.4f} on the device, {moved / dev_ms * 1e-9:.3f} TB/s read); "
            f"plain {plain_ms:.3f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
            f"{moved:.4g} bytes) on {card_line}")
        recs[label] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                           shape=[B, eng.n_vars], **b)
        del errors, syn, priors, res, final, got, want
    del engines
    torch.cuda.empty_cache()
    return dict(recs["code_capacity"], max_abs_err=0.0, space_time=recs["space_time"],
                dem=recs["dem"])


def sample(H: np.ndarray, p: float, B: int, seed: int):
    rng = np.random.default_rng(seed)
    errors = (rng.random((B, H.shape[1])) < p).astype(np.uint8)
    return errors, ((errors.astype(np.int64) @ H.T) % 2).astype(np.uint8)


def phase_k1(H: np.ndarray, dev) -> tuple[float, dict]:
    """K1 against the plain version; returns (max_abs_err, BP failures at p=0.05)."""
    from qldpc_tpu_torch.decoders import BPConfig, BPDecoder
    from qldpc_tpu_torch.ops.bp_cuda import bp_flooding_cuda, bp_flooding_plain, launch_grid

    B = K1_BATCH
    cases = [
        ("sum-product p=0.01", BPConfig(max_iter=50), 0.01),
        ("sum-product p=0.05", BPConfig(max_iter=50), 0.05),
        ("min-sum a=0.8 o=0.1 p=0.05",
         BPConfig(max_iter=50, method="min-sum", alpha=0.8, offset=0.1), 0.05),
    ]
    worst = 0.0
    failures = None
    for name, cfg, p in cases:
        dec = BPDecoder(H, cfg).to(dev)
        _, syn_np = sample(H, p, B, seed=0)
        syn = torch.from_numpy(syn_np).to(dev)
        prior = torch.full((H.shape[1],), math.log((1 - p) / p), dtype=torch.float32, device=dev)
        k = bp_flooding_cuda(syn, prior, dec.tables(), cfg)
        torch.cuda.synchronize()
        r = bp_flooding_plain(syn, prior, dec.tables(), cfg)
        torch.cuda.synchronize()
        kv, kc, ki, kh = k
        rv, rc, ri, rh = r
        differ = (kc != rc) | (ki != ri) | (kh != rh).any(1)
        n_diff = int(differ.sum())
        agree = ~differ
        err = float((kv[agree] - rv[agree]).abs().max()) if bool(agree.any()) else 0.0
        close = torch.allclose(kv[agree], rv[agree], rtol=VALUE_TOL, atol=VALUE_TOL)
        s_hat = (kh.float() @ torch.from_numpy(H.astype(np.float32)).to(dev).T).remainder(2)
        reproduces = bool((s_hat[kc] == syn[kc].float()).all())
        if name == "sum-product p=0.01":
            warps, blocks = launch_grid(B, dec.tables(), shared_priors=True)
            log(f"K1 geometry: one warp a sample, {warps} warps a block, a persistent grid of "
                f"{blocks} blocks ({warps * blocks} warps) taking samples from a work counter")
        log(f"K1 {name}: B={B} converged {int(kc.sum())} lanes differing in decision "
            f"{n_diff} (limit {DECISION_TOL * B:.1f}) max |dvalues| {err:.3g} "
            f"mean iterations {ki.float().mean().item():.3f}")
        if n_diff > DECISION_TOL * B:
            raise AssertionError(f"K1 {name}: {n_diff} lanes differ in decision")
        if not close:
            raise AssertionError(f"K1 {name}: posteriors differ beyond {VALUE_TOL}")
        if not reproduces:
            raise AssertionError(f"K1 {name}: a converged lane misses its syndrome")
        worst = max(worst, err)
        if name == "sum-product p=0.05":
            fail = ~kc
            failures = dict(syn=syn[fail], llrs=kv[fail], hard=kh[fail])
    return worst, failures


def phase_k2(H: np.ndarray, dev, failures: dict) -> dict:
    """K2 against its plain version on the BP failures, bit-identical: its
    packed-rows entry (A, b and piv_col) and its ordered loader (b and
    piv_col, from H's packed columns in each sample's order: the OSD
    decoder's path), each timed. Returns the ordered loader's kernel record
    with the packed-rows entry's under ``rows``."""
    from qldpc_tpu_torch.decoders import OSDDecoder
    from qldpc_tpu_torch.ops.osd_cuda import (
        eliminate_ordered_cuda,
        eliminate_ordered_plain,
        eliminate_rows_cuda,
        eliminate_rows_plain,
        launch_instance,
        pack_rows,
    )

    osd = OSDDecoder(H).to(dev)
    hard = failures["hard"].to(torch.int32)
    resid = (failures["syn"].to(torch.int32)
             + torch.remainder(hard.float() @ osd.Hf.T, 2.0).to(torch.int32)) % 2
    order = torch.argsort(failures["llrs"].abs(), dim=1, stable=True)
    A = pack_rows(torch.from_numpy(H).to(dev)[:, order].permute(1, 0, 2))
    n, m, lanes, nw = osd.n, osd.m, A.shape[0], A.shape[2]
    ka, kb, kp = eliminate_rows_cuda(A, resid, n, osd.h_rank)
    torch.cuda.synchronize()
    ra, rb, rp = eliminate_rows_plain(A, resid, n, osd.h_rank)
    torch.cuda.synchronize()
    same = torch.equal(ka, ra) and torch.equal(kb, rb) and torch.equal(kp, rp)
    ob, op = eliminate_ordered_cuda(order, resid, osd.Hc, osd.h_rank)
    torch.cuda.synchronize()
    pb, pp = eliminate_ordered_plain(order, resid, osd.Hc, osd.h_rank)
    same_ordered = (torch.equal(ob, rb) and torch.equal(op, rp) and torch.equal(pb, rb)
                    and torch.equal(pp, rp))
    log(f"K2 on {lanes} BP failures (m={m}, n={n}, {nw} words, rank {osd.h_rank}, register "
        f"instance {launch_instance(m, nw)}): packed rows bit-identical {same}; ordered "
        f"loader (b, piv) bit-identical to the plain versions' {same_ordered}")
    if not (same and same_ordered):
        raise AssertionError("K2 disagrees with its plain version")
    # the dense count: a word operation per row, word and pivot
    ops = int((kp >= 0).sum()) * m * nw
    recs = {}
    for name, kernel, plain, args, moved in (
            ("rows", eliminate_rows_cuda, eliminate_rows_plain, (A, resid, n, osd.h_rank),
             2 * nbytes(A, resid) + nbytes(kp)),
            # reads H's packed columns once, order and resid; writes b and piv
            ("ordered", eliminate_ordered_cuda, eliminate_ordered_plain,
             (order, resid, osd.Hc, osd.h_rank),
             nbytes(osd.Hc, order.to(torch.int32), resid, ob, op))):
        ms = cuda_ms(lambda: kernel(*args), reps=5)
        dev_ms = device_ms(lambda: kernel(*args), reps=5)
        plain_ms = cuda_ms(lambda: plain(*args), reps=1)
        recs[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, max_abs_err=0.0,
                          **bound(moved, ops))
        log(f"K2 {name}: {ms:.4f} ms ({dev_ms:.4f} ms on the device), plain {plain_ms:.4f} ms, "
            f"bound {recs[name]['bound_ms']:.5f} ms ({recs[name]['bound_by']}; {lanes} lanes)")
    return dict(recs["ordered"], rows=recs["rows"])


def phase_engine(dev, card_line: str) -> dict:
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
    from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine
    from qldpc_tpu_torch.ops import bp_cuda, classify_cuda, osd_cuda, threefry_cuda

    trials = ENGINE_TRIALS
    eng = MonteCarloEngine(
        get_code(CODE),
        EngineConfig(bp=BPConfig(max_iter=50), osd=OSDConfig(order=0),
                     batch_size=ENGINE_BATCH),
        device=dev,
    )
    rates = [0.01, REF_P]
    torch.cuda.synchronize()
    bp_cuda.bp_flooding_cuda.launches = 0
    osd_cuda.eliminate_ordered_cuda.launches = 0
    threefry_cuda.counter_uniform_cuda.launches = 0
    classify_cuda.classify_cuda.launches = 0
    res = eng.sweep(rates, trials=trials)
    torch.cuda.synchronize()
    launches = {
        "bp_flooding": bp_cuda.bp_flooding_cuda.launches,
        "gf2_elim": osd_cuda.eliminate_ordered_cuda.launches,
        "threefry_uniform": threefry_cuda.counter_uniform_cuda.launches,
        "classify": classify_cuda.classify_cuda.launches,
    }
    for p, d in zip(rates, res.per_rate):
        scalars = {k: v for k, v in d.items() if not isinstance(v, np.ndarray)}
        hists = {k: {int(i): int(v[i]) for i in np.nonzero(v)[0]}
                 for k, v in d.items() if isinstance(v, np.ndarray)}
        log(f"engine p={p}: {json.dumps(scalars)}")
        log(f"engine p={p} histograms (weight: count): {json.dumps(hists)}")
    log(f"engine sweep {CODE} BP(50)+OSD-0, {trials} trials per rate, batch {ENGINE_BATCH}: "
        f"wall {res.wall_time_s:.3f} s, {res.throughput:.1f} trials/s on {card_line}")
    log(f"engine kernel launches in the sweep: {json.dumps(launches)}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"the engine's sweep never launched {name}")
    ler = res.per_rate[1]["ler"]
    sigma = math.sqrt(ler * (1 - ler) / trials + REF_LER * (1 - REF_LER) / REF_TRIALS)
    log(f"LER at p={REF_P}: {ler:.5f} against the archive's {REF_LER} "
        f"(limit +-{4 * sigma:.5f})")
    if abs(ler - REF_LER) > 4 * sigma:
        raise AssertionError(f"LER {ler} is outside 4 sigma of {REF_LER}")
    for d in res.per_rate:
        if d["trials"] != trials or d["BPs_fault"] != round(d["osd"] * trials):
            raise AssertionError("engine counters are inconsistent")
    return launches


def phase_engine_vs_cpu(dev) -> None:
    """Small input: the card's engine (K1, K2) against the CPU engine (plain
    versions). Min-sum without alpha is exact arithmetic in both, so the
    counters must be identical."""
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
    from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine, counters_to_dict

    cfg = EngineConfig(bp=BPConfig(max_iter=50, method="min-sum"),
                       osd=OSDConfig(order=0), batch_size=2048)
    code = get_code(CODE)
    got = counters_to_dict(MonteCarloEngine(code, cfg, device=dev).run_rate(0.02, 4096, seed=1))
    ref = counters_to_dict(MonteCarloEngine(code, cfg, device="cpu").run_rate(0.02, 4096, seed=1))
    same = all(np.array_equal(got[k], ref[k]) for k in ref)
    log(f"engine on the card vs the CPU engine, {CODE} min-sum p=0.02, 4096 trials: "
        f"identical {same} (ler {got['ler']:.5f}, BP faults {got['BPs_fault']})")
    if not same:
        raise AssertionError("the card's engine disagrees with the CPU engine")


def phase_throughput(H: np.ndarray, dev, card_line: str) -> dict:
    """K1 and its plain version at the engine's batch and at
    THROUGHPUT_BATCH, p = 0.01, and at the engine's batch at p = 0.050119;
    returns the record at the engine's batch, p = 0.01, with the one at p =
    0.050119 under ``at_p_0_050119``."""
    from qldpc_tpu_torch.decoders import BPConfig, BPDecoder
    from qldpc_tpu_torch.ops.bp_cuda import bp_flooding_cuda, bp_flooding_plain

    cfg = BPConfig(max_iter=50)
    dec = BPDecoder(H, cfg).to(dev)
    recs = {}
    for p, B in ((0.01, ENGINE_BATCH), (0.01, THROUGHPUT_BATCH), (REF_P, ENGINE_BATCH)):
        prior = torch.full((H.shape[1],), math.log((1 - p) / p), dtype=torch.float32,
                           device=dev)
        _, syn_np = sample(H, p, B, seed=2)
        syn = torch.from_numpy(syn_np).to(dev)
        args = (syn, prior, dec.tables(), cfg)
        ms = cuda_ms(lambda: bp_flooding_cuda(*args), reps=5)
        dev_ms = device_ms(lambda: bp_flooding_cuda(*args), reps=5)
        plain_ms = cuda_ms(lambda: bp_flooding_plain(*args), reps=2)
        iters = bp_flooding_cuda(*args)[2]
        b = bp_bound(syn, prior, dec.tables(), iters, int(H.sum()))
        log(f"BP(50) {CODE} p={p} B={B}: K1 {ms:.3f} ms = {B / ms * 1e3:.0f} syndromes/s "
            f"({dev_ms:.3f} ms on the device); plain torch {plain_ms:.3f} ms = "
            f"{B / plain_ms * 1e3:.0f} syndromes/s; bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}); mean iterations {iters.float().mean().item():.3f} on "
            f"{card_line}")
        recs.setdefault(p, dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, **b))
    return dict(recs[0.01], at_p_0_050119=dict(
        recs[REF_P], syndromes=ENGINE_BATCH, p=REF_P))


def phase_k1_bf16(H: np.ndarray, dev, card_line: str, out_dir: str) -> tuple[dict, int]:
    """K1's bf16 instances against the plain version in bf16, timed in turns
    against the float32 instance; then the CLI's study preset with bf16
    operands (phase 6b). Returns the record and the bf16 launches of the CLI
    run."""
    from qldpc_tpu_torch.decoders import BPConfig, BPDecoder
    from qldpc_tpu_torch.experiments.cli import main as cli_main
    from qldpc_tpu_torch.experiments.results_io import load_results
    from qldpc_tpu_torch.ops.bp_cuda import bp_flooding_cuda, bp_flooding_plain

    B = K1_BATCH
    Hf = torch.from_numpy(H.astype(np.float32)).to(dev)
    worst = 0.0
    for name, cfg, p in (
        ("sum-product p=0.01", BPConfig(max_iter=50), 0.01),
        ("sum-product p=0.05", BPConfig(max_iter=50), 0.05),
        ("min-sum a=0.8 o=0.1 p=0.05",
         BPConfig(max_iter=50, method="min-sum", alpha=0.8, offset=0.1), 0.05),
    ):
        cfg = dataclasses.replace(cfg, mm_dtype="bfloat16")
        tables = BPDecoder(H, cfg).to(dev).tables()
        _, syn_np = sample(H, p, B, seed=0)
        syn = torch.from_numpy(syn_np).to(dev)
        prior = torch.full((H.shape[1],), math.log((1 - p) / p), dtype=torch.float32, device=dev)
        kv, kc, ki, kh = bp_flooding_cuda(syn, prior, tables, cfg)
        torch.cuda.synchronize()
        rv, rc, ri, rh = bp_flooding_plain(syn, prior, tables, cfg)
        torch.cuda.synchronize()
        differ = (kc != rc) | (ki != ri) | (kh != rh).any(1)
        n_diff, agree = int(differ.sum()), ~differ
        err = float((kv[agree] - rv[agree]).abs().max()) if bool(agree.any()) else 0.0
        close = torch.allclose(kv[agree], rv[agree], rtol=VALUE_TOL, atol=VALUE_TOL)
        reproduces = bool(((kh.float() @ Hf.T).remainder(2)[kc] == syn[kc].float()).all())
        log(f"K1 bf16 operands {name}: B={B} converged {int(kc.sum())} lanes differing in "
            f"decision {n_diff} (limit {DECISION_TOL * B:.1f}) max |dvalues| {err:.3g} mean "
            f"iterations {ki.float().mean().item():.3f}")
        if n_diff > DECISION_TOL * B or not close or not reproduces:
            raise AssertionError(f"K1 bf16 operands {name} disagrees with its plain version")
        worst = max(worst, err)

    p = 0.01
    cfg32 = BPConfig(max_iter=50)
    cfg16 = dataclasses.replace(cfg32, mm_dtype="bfloat16")
    tables = BPDecoder(H, cfg32).to(dev).tables()
    prior = torch.full((H.shape[1],), math.log((1 - p) / p), dtype=torch.float32, device=dev)
    syn = torch.from_numpy(sample(H, p, B, seed=2)[1]).to(dev)
    a32, a16 = (syn, prior, tables, cfg32), (syn, prior, tables, cfg16)
    f32a, b16a, b16b, f32b = (device_ms(lambda a=a: bp_flooding_cuda(*a), reps=5)
                              for a in (a32, a16, a16, a32))
    ms = cuda_ms(lambda: bp_flooding_cuda(*a16), reps=5)
    plain_ms = cuda_ms(lambda: bp_flooding_plain(*a16), reps=2)
    iters = bp_flooding_cuda(*a16)[2]
    b = bp_bound(syn, prior, tables, iters, int(H.sum()))
    log(f"K1 {CODE} BP(50) p={p} B={B} device ms in turns: float32 {f32a:.4f}, bf16 operands "
        f"{b16a:.4f}, {b16b:.4f}, float32 {f32b:.4f}; bf16 {ms:.4f} ms per call, plain (bf16) "
        f"{plain_ms:.3f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}), mean iterations "
        f"{iters.float().mean().item():.3f} on {card_line}")

    torch.cuda.synchronize()
    bp_flooding_cuda.launches = bp_flooding_cuda.bf16_launches = 0
    t0 = time.perf_counter()
    code = cli_main(["run", "study", "--codes", CODE, "--error-rates", str(REF_P),
                     "--trials", str(ENGINE_TRIALS), "--batch-size", str(ENGINE_BATCH),
                     "--set", "bp_backend=pallas", "--set", "bp_mm_dtype=bfloat16",
                     "--out", out_dir, "--no-checkpoint", "--quiet"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bp_flooding_cuda.bf16_launches
    d = load_results(f"{out_dir}/study.npz")[CODE][REF_P]
    lim = binomial_limit(d["ler"], d["trials"], MM_REF_LER, MM_REF_TRIALS)
    log(f"CLI study bp_mm_dtype=bfloat16 {CODE} p={REF_P}, {d['trials']} trials: exit {code}, "
        f"{wall:.1f} s, K1 launches {bp_flooding_cuda.launches} (bf16 {launches}); LER "
        f"{d['ler']:.5f} against the JAX package's bf16 {MM_REF_LER} (limit +-{lim:.5f}), "
        f"OSD rate {d['osd']:.5f}, mean iterations {d['average_iterations']:.3f}")
    if code != 0 or launches < 1 or launches != bp_flooding_cuda.launches:
        raise AssertionError("the bf16 CLI run did not launch K1's bf16 instance alone")
    if abs(d["ler"] - MM_REF_LER) > lim or d["trials"] != ENGINE_TRIALS:
        raise AssertionError(f"bf16 operands: LER {d['ler']} is outside 4 sigma of {MM_REF_LER}")
    return dict(ms=ms, device_ms=b16a, f32_device_ms=f32a, plain_ms=plain_ms,
                max_abs_err=worst, **b), launches


def binomial_limit(x: float, n: int, ref: float, n_ref: int) -> float:
    """4 sigma of the difference of two binomial rates."""
    return 4 * math.sqrt(x * (1 - x) / n + ref * (1 - ref) / n_ref)


def dem_engine(dev, cfg_bp=None, batch: int = DEM_BATCH, code: str = DEM_CODE,
               rounds: int = DEM_ROUNDS, osd=None):
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
    from qldpc_tpu_torch.mc import DEMEngine, DEMEngineConfig
    from qldpc_tpu_torch.noise.circuit import parametric_memory_dem

    dem = parametric_memory_dem(get_code(code), basis="z", rounds=rounds)
    cfg = DEMEngineConfig(bp=cfg_bp or BPConfig(max_iter=50), osd=osd or OSDConfig(order=0),
                          batch_size=batch)
    return DEMEngine(dem, cfg, device=dev, name=f"{code} DEM, rounds {rounds}")


def kernel_device_ms(fn, prefixes: tuple[str, ...]) -> dict:
    """Device milliseconds of one ``fn()`` under torch.profiler, summed by
    kernel name (a template kernel's name starts with "void ")."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(prefixes, 0.0)
    for e in prof.key_averages():
        name = e.key.removeprefix("void ")
        for prefix in prefixes:
            if e.device_type == DeviceType.CUDA and name.startswith(prefix):
                out[prefix] += e.self_device_time_total / 1e3
    return out


def peak_bytes(fn) -> int:
    """Device memory ``fn()`` allocates at its peak, beyond what was live."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


K3_SPLIT = ("dem_summary_kernel", "dem_word_var_kernel", "dem_syndrome_kernel",
            "dem_freeze_kernel", "dem_init")


def k3_paths(name: str, args, cfg, tables, B: int) -> dict:
    """K3's summary path against its message path on the same inputs: bit
    for bit, then both timed in turns, their peak memory, the summary path's
    device time per iteration by pass and the bytes each path streams per
    iteration with every sample running."""
    from qldpc_tpu_torch.ops.dem_bp_cuda import dem_bp_cuda, summary_path

    if not summary_path(tables, cfg):
        raise AssertionError(f"K3 {name}: the summary path does not apply")
    got = dem_bp_cuda(*args)
    msg = dem_bp_cuda(*args, _store_r=True)
    torch.cuda.synchronize()
    differ = (got[1] != msg[1]) | (got[2] != msg[2]) | (got[3] != msg[3]).any(1) | \
        (got[0].view(torch.int32) != msg[0].view(torch.int32)).any(1)
    n_diff = int(differ.sum())
    log(f"K3 {name}: summary path against the message path: {n_diff} of {B} lanes "
        f"differ (bits of posteriors, decisions, iterations)")
    if n_diff:
        raise AssertionError(f"K3 {name}: the summary path differs from the message path")
    summ = lambda: dem_bp_cuda(*args)
    mesg = lambda: dem_bp_cuda(*args, _store_r=True)
    ms = [cuda_ms(summ, reps=2), cuda_ms(mesg, reps=2), cuda_ms(mesg, reps=2),
          cuda_ms(summ, reps=2)]
    peak = peak_bytes(summ), peak_bytes(mesg)
    E, m, n = int(tables.check_deg.sum()), tables.m, tables.n
    S = m * tables.dc
    log(f"K3 {name}: summary path {ms[0]:.3f} / {ms[3]:.3f} ms, message path {ms[1]:.3f} / "
        f"{ms[2]:.3f} ms per call (in turns); peak memory {peak[0] / 1e9:.3f} GB against "
        f"{peak[1] / 1e9:.3f} GB (R is {S * B * 4 / 1e9:.3f} GB)")
    if peak[1] - peak[0] < 0.9 * S * B * 4:  # the allocator rounds to 2 MB blocks
        raise AssertionError(f"K3 {name}: the summary path allocates an R-sized array")
    iters = int(got[2].max()) + 1
    split = kernel_device_ms(summ, K3_SPLIT)
    log(f"K3 {name}: summary path device ms per iteration ({iters} iterations run): "
        + ", ".join(f"{k} {v / iters:.4f}" for k, v in split.items()))
    # device-memory bytes per iteration, every sample running: the summary
    # path reads each real slot's word twice and writes it once, writes the
    # summaries, the posteriors and the decisions; the message path reads Q
    # twice and writes R (check), reads R and writes Q (variable); both read
    # the syndromes. The gathers of summaries (8 B a slot) and decisions (1 B
    # a slot) are served by the L2 and counted apart.
    words = 3 * E * B * 4 + 2 * m * B * 4 + n * B * 5 + m * B
    message = 5 * E * B * 4 + n * B * 5 + 2 * m * B
    log(f"K3 {name}: bytes streamed per iteration {words / 1e9:.3f} GB (summary path) "
        f"against {message / 1e9:.3f} GB (message path); L2 gathers {E * B * 9 / 1e9:.3f} "
        f"and {E * B / 1e9:.3f} GB")
    return dict(ms=ms[0], message_ms=ms[1], device_ms=device_ms(summ, reps=2))


def k3_held(eng, syn, llr, cfg, label: str):
    """K3 against its plain version on the same syndromes and priors:
    min-sum bit for bit; sum-product with at most K3_DECISION_TOL lanes in
    1,024 differing in decision (converged flag, iterations or hard
    decision) and the agreeing lanes' posteriors within VALUE_TOL. Returns
    K3's outputs and the largest posterior difference."""
    from qldpc_tpu_torch.ops.dem_bp_cuda import dem_bp_cuda, dem_bp_plain

    B, tables = syn.shape[0], eng.bp.tables()
    kv, kc, ki, kh = dem_bp_cuda(syn, llr, tables, cfg)
    torch.cuda.synchronize()
    rv, rc, ri, rh = dem_bp_plain(syn, llr, tables, cfg)
    torch.cuda.synchronize()
    differ = (kc != rc) | (ki != ri) | (kh != rh).any(1)
    n_diff, agree = int(differ.sum()), ~differ
    err = float((kv[agree] - rv[agree]).abs().max()) if bool(agree.any()) else 0.0
    exact = all(torch.equal(a, b) for a, b in ((kv, rv), (kc, rc), (ki, ri), (kh, rh)))
    log(f"K3 {label} {cfg.method}: B={B} converged {int(kc.sum())} mean "
        f"iterations {ki.float().mean().item():.3f} lanes differing in decision "
        f"{n_diff} max |dvalues| {err:.3g} bit-identical {exact}")
    if cfg.method == "min-sum" and not exact:
        raise AssertionError(f"K3 {label} min-sum is not bit-identical to the plain version")
    if n_diff > K3_DECISION_TOL * B / 1024:
        raise AssertionError(f"K3 {label} {cfg.method}: {n_diff} lanes differ in decision")
    if not torch.allclose(kv[agree], rv[agree], rtol=VALUE_TOL, atol=VALUE_TOL):
        raise AssertionError(f"K3 {label} {cfg.method}: posteriors differ beyond {VALUE_TOL}")
    s_hat = eng._syndrome(kh)
    if not bool((s_hat[kc] == syn[kc]).all()):
        raise AssertionError(f"K3 {label} {cfg.method}: a converged lane misses its syndrome")
    return (kv, kc, ki, kh), err


def phase_k3(eng, dev, rates=tuple(DEM_REF), methods=("sum-product", "min-sum")):
    """K3 against the plain version on one DEM, and its summary path against
    its message path. Returns its record at the first rate, sum-product
    (max_abs_err over every case, ms, plain ms, the bound) and the BP
    failures at p = 0.002, sum-product."""
    from qldpc_tpu_torch.decoders import BPConfig
    from qldpc_tpu_torch.ops.dem_bp_cuda import dem_bp_plain

    B, tables = DEM_BATCH, eng.bp.tables()
    worst, failures, rec = 0.0, None, None
    for p in rates:
        prob, llr = eng.priors(p)
        rng = np.random.default_rng(3)
        mech = rng.random((B, eng.n_vars)) < prob.cpu().numpy()
        syn = eng._syndrome(torch.from_numpy(mech.astype(np.int8)).to(dev))
        for method in methods:
            cfg = BPConfig(max_iter=50, method=method)
            (kv, kc, ki, kh), err = k3_held(eng, syn, llr, cfg, f"{eng.code.name} p={p}")
            worst = max(worst, err)
            args = (syn, llr, tables, cfg)
            paths = k3_paths(f"{eng.code.name} BP(50) {method} p={p} B={B}", args, cfg, tables, B)
            if method == "sum-product" and p == 0.002:
                fail = ~kc
                failures = dict(syn=syn[fail], llrs=kv[fail], hard=kh[fail])
            if method == "sum-product" and rec is None:
                rec = dict(ms=paths["ms"], device_ms=paths["device_ms"],
                           plain_ms=cuda_ms(lambda: dem_bp_plain(*args), reps=1),
                           **bp_bound(syn, llr, tables, ki, int(tables.check_deg.sum())))
                log(f"K3 {eng.code.name} BP(50) sum-product p={p} B={B}: {rec['ms']:.3f} ms "
                    f"per call ({rec['device_ms']:.3f} ms on the device), plain "
                    f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    rec["max_abs_err"] = worst
    return rec, failures


def k4_geometry(m: int, piv: torch.Tensor) -> str:
    """K4's launch geometry for these samples, and the panels of 32 columns
    each walked (a sample leaves at the boundary after its last pivot)."""
    from qldpc_tpu_torch.ops import osd_transform_cuda as otc

    B = piv.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, per_sm, waves = otc.launch_shape(m, B, sms)
    last = piv.max(dim=1).values.to(torch.int64)
    panels = torch.where(last >= 0, last // 32 + 1, 0).float()
    return (f"a block a sample of {threads} threads ({otc.smem_bytes(m)} B of shared memory), "
            f"{per_sm} blocks an SM, {waves} wave(s) on {sms} SMs; panels walked "
            f"{panels.mean().item():.2f} mean, {int(panels.max())} max")


def k4_held(osd, syn, llrs, hard, label: str):
    """K4 against its plain version on BP failures (syndromes, posterior
    LLRs, hard decisions), with and without the b-exit, bit for bit; the
    OSD decoder's residual and stable column order are its inputs. Returns
    (order, resid)."""
    from qldpc_tpu_torch.ops.osd_transform_cuda import (
        eliminate_transform_cuda,
        eliminate_transform_plain,
    )

    resid = osd._residual(syn, hard.to(torch.int32))
    order = torch.argsort(llrs.abs(), dim=1, stable=True)
    lanes = order.shape[0]
    for b_exit in (True, False):
        # without the b-exit every sample runs to rank(H): the plain version
        # takes seconds per hundred samples there, so it checks the first
        # K4_NO_EXIT_LANES
        keep = lanes if b_exit else K4_NO_EXIT_LANES
        args = (order[:keep], resid[:keep], osd.Hc, osd.h_rank, b_exit)
        got = eliminate_transform_cuda(*args)
        torch.cuda.synchronize()
        ref = eliminate_transform_plain(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        log(f"K4 {label} b_exit={b_exit} on {min(keep, lanes)} BP failures (m={osd.m}, "
            f"n={osd.n}, {osd.m_words} words, rank {osd.h_rank}): mean rank reached "
            f"{got[2].float().mean().item():.1f}, bit-identical {same}")
        if not same:
            raise AssertionError(f"K4 {label} (b_exit={b_exit}) disagrees with its plain version")
    return order, resid


def phase_k4(eng, failures: dict) -> dict:
    """K4 against the plain version on the BP failures, with and without
    the b-exit; bit-identical. Returns its record with the b-exit, as OSD-0
    runs it."""
    from qldpc_tpu_torch.ops.osd_transform_cuda import (
        eliminate_transform_cuda,
        eliminate_transform_plain,
    )

    osd = eng.osd
    order, resid = k4_held(osd, failures["syn"], failures["llrs"], failures["hard"],
                           eng.code.name)
    lanes = order.shape[0]
    args = (order, resid, osd.Hc, osd.h_rank, True)
    ms = cuda_ms(lambda: eliminate_transform_cuda(*args), reps=5)
    dev_ms = device_ms(lambda: eliminate_transform_cuda(*args), reps=5)
    plain_ms = cuda_ms(lambda: eliminate_transform_plain(*args), reps=1)
    log(f"K4 time {ms:.4f} ms ({dev_ms:.4f} ms on the device), plain {plain_ms:.4f} ms "
        f"({lanes} lanes, b-exit on)")
    T, b, rank, piv = eliminate_transform_cuda(*args)
    log(f"K4 geometry: {k4_geometry(osd.m, piv)}")
    # reads order, resid and the packed columns, writes T, b, rank, piv; for
    # each column up to a sample's last pivot, one AND and one XOR per word
    # of every row of T
    cols = float((piv.max(dim=1).values.to(torch.int64) + 1).sum())
    moved = nbytes(order.to(torch.int32), resid, osd.Hc, T, b, rank, piv)
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, max_abs_err=0.0,
                **bound(moved, cols * osd.m * osd.m_words * 2))


def phase_dem_engine(eng, card_line: str, refs: dict, kernels: dict, absent: dict) -> dict:
    """The DEM engine's sweep on ``refs``' rates; every kernel of
    ``kernels`` (name -> wrapper) must launch and none of ``absent``."""
    rates = list(refs)
    torch.cuda.synchronize()
    for fn in (*kernels.values(), *absent.values()):
        fn.launches = 0
    res = eng.sweep(rates, trials=DEM_TRIALS)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in {**kernels, **absent}.items()}
    log(f"DEM engine sweep {eng.code.name} BP(50)+OSD-0, {DEM_TRIALS} trials per rate, "
        f"batch {DEM_BATCH}: wall {res.wall_time_s:.3f} s, {res.throughput:.1f} trials/s "
        f"(first use included) on {card_line}")
    log(f"DEM engine kernel launches in the sweep: {json.dumps(launches)}")
    for name in kernels:
        if launches[name] < 1:
            raise AssertionError(f"the DEM engine's sweep never launched {name}")
    for name in absent:
        if launches[name]:
            raise AssertionError(f"the DEM engine's sweep launched {name}")
    for p, d in zip(rates, res.per_rate):
        ref_err, ref_osd, ref_iters = refs[p]
        scalars = {k: v for k, v in d.items() if not isinstance(v, np.ndarray)}
        log(f"DEM engine p={p}: {json.dumps(scalars)}")
        for name, got, ref in (("obs-err", d["ler"], ref_err), ("OSD rate", d["osd"], ref_osd)):
            lim = binomial_limit(got, d["trials"], ref, DEM_REF_TRIALS)
            log(f"  {name} {got:.5f} against {ref} (limit +-{lim:.5f})")
            if abs(got - ref) > lim:
                raise AssertionError(f"DEM {name} at p={p}: {got} is outside 4 sigma of {ref}")
        log(f"  mean BP iterations {d['average_iterations']:.3f} against {ref_iters}")
        if d["trials"] != DEM_TRIALS or d["BPs_fault"] != round(d["osd"] * DEM_TRIALS):
            raise AssertionError("DEM engine counters are inconsistent")
    return launches


def phase_dem_engine_vs_cpu(dev, trials: int, code: str = DEM_CODE, rounds: int = DEM_ROUNDS,
                            backend: str = "auto") -> None:
    """Small input: the card's DEM engine (K3 and K4 or K5) against the CPU
    DEM engine (plain versions). Min-sum without alpha is exact arithmetic,
    the priors are computed on the CPU for both and both pick the
    elimination from H's shape, so the counters must be identical."""
    from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
    from qldpc_tpu_torch.mc import counters_to_dict

    ms, osd = BPConfig(max_iter=50, method="min-sum"), OSDConfig(backend=backend)
    p = 0.001
    card_eng = dem_engine(dev, ms, batch=trials, code=code, rounds=rounds, osd=osd)
    cpu_eng = dem_engine("cpu", ms, batch=trials, code=code, rounds=rounds, osd=osd)
    if card_eng.osd.elimination != cpu_eng.osd.elimination:
        raise AssertionError("the card and the CPU picked different eliminations")
    got = counters_to_dict(card_eng.run_rate(p, trials, seed=1))
    ref = counters_to_dict(cpu_eng.run_rate(p, trials, seed=1))
    same = all(np.array_equal(got[k], ref[k]) for k in ref)
    log(f"DEM engine on the card vs the CPU DEM engine, {code} rounds {rounds}, "
        f"{card_eng.osd.elimination} elimination, min-sum p={p}, {trials} trials: "
        f"identical {same} (obs-err {got['ler']:.5f}, BP faults {got['BPs_fault']})")
    if not same:
        raise AssertionError("the card's DEM engine disagrees with the CPU DEM engine")


def steady_rate(eng, p: float, trials: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run_rate(p, trials, seed=7)
    torch.cuda.synchronize()
    return trials / (time.perf_counter() - t0)


def phase_dem_throughput(eng, card_line: str) -> None:
    """Steady-state trials/s of the warm DEM engine, four batches per rate,
    and of the same engine on the card with the plain torch versions in
    place of K3 and K4, one batch per rate."""
    from qldpc_tpu_torch.decoders import bp, osd
    from qldpc_tpu_torch.ops.dem_bp_cuda import dem_bp_plain
    from qldpc_tpu_torch.ops.osd_transform_cuda import eliminate_transform_plain

    for p in DEM_REF:
        kernels = steady_rate(eng, p, 4 * DEM_BATCH)
        with mock.patch.object(bp, "dem_bp", dem_bp_plain), \
                mock.patch.object(osd, "eliminate_transform", eliminate_transform_plain):
            plain = steady_rate(eng, p, DEM_BATCH)
        log(f"DEM engine steady state {eng.code.name} p={p}: {kernels:.1f} trials/s with K3 "
            f"and K4, {plain:.1f} trials/s with their plain versions, on {card_line}")


K5_NAMES = ("factored_y", "factored_w", "factored_panel_elim", "factored_resolve")
K5_LANES_ARG = {"factored_y": 1, "factored_w": 1, "factored_panel_elim": 4, "factored_resolve": 2}


def _k5_cost(name: str, args) -> tuple[int, float]:
    """(bytes moved, operations) of one K5 launch, from its arguments after
    the launch: every input read once, every output written once; the
    GF(2) products counted as the word operations these inputs need."""
    from qldpc_tpu_torch.ops.osd_factored_cuda import BLOCK_COLS as K

    kw = K // 32
    if name == "factored_y":
        P, lanes, ids, Hc, scur = args
        A, mw = lanes.shape[0], P.shape[2]
        # P rows, the block's packed columns, Y; H is sparse, so one bit
        # extract and one XOR per row s and set bit of a block column (the
        # dense count, one AND and one XOR per word, is k5_dense_ops)
        support = popcount(Hc[ids.long()])
        return 4 * A * (scur * mw + K * mw + K + scur * kw), 2.0 * scur * support
    if name == "factored_w":
        C, lanes, ids, Hc, Y, scur = args
        A, m_pad = lanes.shape[0], C.shape[2]
        coeff = popcount(C[lanes.long(), : scur // 32])
        # C's coefficient words, the block's columns, Y, W; one XOR of Y's
        # words per set coefficient bit
        return 4 * A * (m_pad * scur // 32 + K * Hc.shape[1] + scur * kw + m_pad * kw), coeff * kw
    if name == "factored_panel_elim":
        W, b, piv, C, lanes, ids, n, blk = args
        A, m_pad = W.shape[0], W.shape[1]
        cnew = popcount(C[lanes.long(), blk * kw: (blk + 1) * kw])
        # W, b and piv in and out, C's block words and prow out; one
        # candidate test per row and column, kw + 1 XORs per eliminated row
        moved = 4 * A * (m_pad * kw + 4 * m_pad // 32 + m_pad * kw + 2 * K)
        return moved, float(A * K * m_pad + cnew * (kw + 1))
    P, C, lanes, prow, blk = args
    A, mw, m_pad = lanes.shape[0], P.shape[2], C.shape[2]
    scur = blk * K
    pcl = prow.long().clamp(max=m_pad - 1)
    rows = torch.gather(C[lanes.long()], 2, pcl[:, None, :].expand(-1, C.shape[1], -1))
    rows = rows * (prow < m_pad)[:, None, :]
    coeff = popcount(rows[:, : scur // 32 + kw])
    # the P rows some pivot's coefficients reference (G is sparse), the
    # pivots' C rows, the new P rows; one XOR per word of P per set
    # coefficient bit
    used = 0
    if scur:
        G = rows[:, : scur // 32].transpose(1, 2)  # (A, K, scur / 32)
        bits = (G[..., None] >> torch.arange(32, dtype=torch.int32, device=G.device)) & 1
        used = int(bits.any(dim=1).sum())
    return 4 * (used * mw + A * K * (scur // 32 + kw) + A * K * mw), float(coeff * mw)


def k5_dense_ops(args) -> float:
    """K5a's operations counted densely: one AND and one XOR per word of P
    and block column, as a dense product does them."""
    P, lanes, ids, Hc, scur = args
    return 2.0 * lanes.shape[0] * scur * ids.shape[1] * P.shape[2]


def unpacked_half(words: torch.Tensor) -> torch.Tensor:
    """Packed int32 words (A, ..., w) as 0/1 float16 bits (A, ..., 32 w),
    bit i of word j at 32 j + i; unpacked a few of the A at a time (about
    2^26 words each), so that the int32 bits never take more than 8 GiB."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    out = torch.empty((*words.shape[:-1], 32 * words.shape[-1]), dtype=torch.float16,
                      device=words.device)
    step = max(1, (1 << 26) // max(1, words[0].numel()))
    for i in range(0, words.shape[0], step):
        out[i:i + step] = ((words[i:i + step, ..., None] >> shifts) & 1).flatten(-2)
    return out


def k5_library_ms(name: str, args, out=None) -> float:
    """K5a's and K5b's GF(2) product as one library call: ``torch.bmm`` of
    the unpacked 0/1 operands in float16, accumulated and returned in
    float32 (exact: the sums are at most m_pad), then ``% 2``; the device
    ms of the bmm alone (``launch_ms``), its result held to the plain
    version's or, given, to the kernel's output ``out`` on the same inputs
    (Y = P H_blk for K5a, C Y for K5b, whose XOR with H_blk is W)."""
    from qldpc_tpu_torch.ops import osd_factored_cuda as ofc

    if name == "factored_y":
        P, lanes, ids, Hc, scur = args
        if not scur:
            return 0.0
        a = unpacked_half(P[lanes.long(), :scur])  # (A, scur, m_pad)
        b = unpacked_half(Hc[ids.long()]).transpose(1, 2)  # (A, m_pad, K)
        want = ofc.factored_y_plain(*args) if out is None else out
    else:
        C, lanes, ids, Hc, Y, scur = args
        if not scur:
            return 0.0
        a = unpacked_half(C[lanes.long(), : scur // 32].transpose(1, 2))  # (A, m_pad, scur)
        b = unpacked_half(Y)  # (A, scur, K)
        want = (ofc.factored_w_plain(*args) if out is None else out) ^ \
            ofc.factored_w_plain(*args[:5], 0)
    ms, out = launch_ms(lambda: torch.bmm(a, b, out_dtype=torch.float32))
    bits = torch.remainder(out, 2.0).to(torch.int32)
    packed = (bits.view(*bits.shape[:-1], bits.shape[-1] // 32, 32) << torch.arange(
        32, dtype=torch.int32, device=bits.device)).sum(-1, dtype=torch.int64)
    packed = torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)
    if not torch.equal(packed, want):
        raise AssertionError(f"{name}: the library product differs from the kernel's")
    return ms


def phase_k5(eng, failures: dict, reps: int = 3) -> dict:
    """K5a-d against their plain versions on the BP failures: the whole
    elimination on the first 128, each kernel at every block of one OSD call
    on all of them (bit-identical outputs and in-place state), the OSD-0
    solutions on 32 against the plain transform elimination's. Each kernel
    is timed twice a block, each time one launch on a fresh copy of the
    state: between plain CUDA events around the launch after a synchronize
    (``ms``, the host's launch work included, ~100 us a launch) and on the
    device alone (``device_ms``, ``launch_ms``). Logs K5a's and K5c's times
    at each block, and K5a's bound on the dense count beside the sparse one.
    Returns the records of the four kernels, their times summed over one
    OSD call."""
    from qldpc_tpu_torch.ops import osd_factored_cuda as ofc
    from qldpc_tpu_torch.ops.osd_transform_cuda import eliminate_transform_plain

    osd = eng.osd
    resid = osd._residual(failures["syn"], failures["hard"].to(torch.int32))
    order = torch.argsort(failures["llrs"].abs(), dim=1, stable=True)
    lanes = order.shape[0]
    keep = min(K5_CHECK_LANES, lanes)
    args = (order, resid, osd.Hc, osd.h_rank, osd.max_cols)
    got = ofc.eliminate_factored_cuda(order[:keep], resid[:keep], *args[2:])
    torch.cuda.synchronize()
    ref = ofc.eliminate_factored_plain(order[:keep], resid[:keep], *args[2:])
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    log(f"K5 whole elimination on {keep} BP failures (m={osd.m}, n={osd.n}, rank "
        f"{osd.h_rank}, budget {osd.max_cols} columns): mean rank reached "
        f"{got[1].sum(1).float().mean().item():.1f}, overflow {int(got[3].sum())}, "
        f"bit-identical {same}")
    if not same:
        raise AssertionError("K5 disagrees with its plain version")

    stats = {name: dict(ms=0.0, device_ms=0.0, plain_ms=0.0, moved=0, ops=0.0, calls=0, blocks=[])
             for name in K5_NAMES}
    dense_ops = 0.0

    def checked(name, kernel, plain):
        def run(*a):
            fresh = lambda: [x.clone() if torch.is_tensor(x) else x for x in a]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ms = dev_ms = 0.0
            for _ in range(reps):
                kargs = fresh()
                torch.cuda.synchronize()
                ev[0].record()
                kernel(*kargs)
                ev[1].record()
                torch.cuda.synchronize()
                ms += ev[0].elapsed_time(ev[1]) / reps
                kargs = fresh()
                t, kout = launch_ms(lambda: kernel(*kargs))
                dev_ms += t / reps
            pargs = fresh()
            ev[0].record()
            pout = plain(*pargs)
            ev[1].record()
            torch.cuda.synchronize()
            outs = [(kout, pout)] if kout is not None else []
            outs += [(x, y) for x, y in zip(kargs, pargs) if torch.is_tensor(x)]
            if not all(torch.equal(x, y) for x, y in outs):
                raise AssertionError(f"{name} disagrees with its plain version")
            nonlocal dense_ops
            st = stats[name]
            moved, ops = _k5_cost(name, kargs)
            if name in ("factored_y", "factored_w"):
                st["library_ms"] = st.get("library_ms", 0.0) + k5_library_ms(name, pargs)
            if name == "factored_y":
                dense_ops += k5_dense_ops(kargs)
            A = a[K5_LANES_ARG[name]].shape[0]
            st["blocks"].append((A, st["calls"] * ofc.BLOCK_COLS, dev_ms * 1e3, ms * 1e3))
            st["ms"] += ms
            st["device_ms"] += dev_ms
            st["plain_ms"] += ev[0].elapsed_time(ev[1])
            st["moved"] += moved
            st["ops"] += ops
            st["calls"] += 1
            return kernel(*a)

        run.launches = 0  # the wrapper counts under its module name: here
        return run

    patches = [mock.patch.object(ofc, f"{name}_cuda", checked(
        name, getattr(ofc, f"{name}_cuda"), getattr(ofc, f"{name}_plain"))) for name in K5_NAMES]
    for patch in patches:
        patch.start()
    try:
        full = ofc.eliminate_factored_cuda(*args)
    finally:
        for patch in patches:
            patch.stop()
    torch.cuda.synchronize()
    records = {}
    for name in K5_NAMES:
        st = stats[name]
        records[name] = dict(ms=st["ms"], device_ms=st["device_ms"], plain_ms=st["plain_ms"],
                             max_abs_err=0.0, library_ms=st.get("library_ms"),
                             **bound(st["moved"], st["ops"]))
        log(f"{name} over the {st['calls']} blocks of one OSD call on {lanes} BP failures: "
            f"{st['ms']:.4f} ms between events around each launch (the host's launch work "
            f"included), {st['device_ms']:.4f} ms on the device, plain {st['plain_ms']:.3f} ms, "
            f"bit-identical at every block, bound {records[name]['bound_ms']:.4f} ms "
            f"({records[name]['bound_by']})" + (
                "" if "library_ms" not in st else
                f"; the same product as one float16 torch.bmm (float32 out) a block: "
                f"{st['library_ms']:.4f} ms on the device"))
        if name in ("factored_y", "factored_panel_elim"):
            log(f"  {name} per block (A, scur, device us, event us): " + " ".join(
                f"({A}, {scur}, {us:.1f}, {ev_us:.1f})" for A, scur, us, ev_us in st["blocks"]))
    dense = bound(stats["factored_y"]["moved"], dense_ops)
    log(f"  factored_y bound on the dense count (an AND and a XOR per word): "
        f"{dense['bound_ms']:.4f} ms ({dense['bound_by']})")
    total = cuda_ms(lambda: ofc.eliminate_factored_cuda(*args), reps=3)
    log(f"K5 per OSD call on {lanes} BP failures: {total:.3f} ms with its host syncs "
        f"(kernels {sum(s['device_ms'] for s in stats.values()):.3f} ms on the device)")

    # OSD-0 solutions: factored (original column ids) against the plain
    # transform elimination (permuted column ids), which the RREF of
    # [H_perm | b] makes equal
    k, n = SOLUTION_LANES, osd.n
    bidx = torch.arange(k, device=order.device)[:, None]
    b, _, piv, overflow = (x[:k] for x in full)
    corr_f = torch.zeros((k, n + 1), dtype=torch.int32, device=order.device)
    corr_f[bidx, torch.where(piv >= 0, piv, n).long()] = b
    _, bt, _, pt = eliminate_transform_plain(order[:k], resid[:k], osd.Hc[:-1].contiguous(),
                                             osd.h_rank, True)
    e_perm = torch.zeros((k, n + 1), dtype=torch.int32, device=order.device)
    e_perm[bidx, torch.where(pt >= 0, pt, n).long()] = bt
    corr_t = torch.zeros((k, n), dtype=torch.int32, device=order.device)
    corr_t[bidx, order[:k]] = e_perm[:, :n]
    same = torch.equal(corr_f[:, :n], corr_t) and not bool(overflow.any())
    log(f"factored OSD-0 solutions on {k} BP failures against the plain transform "
        f"elimination's: identical {same}")
    if not same:
        raise AssertionError("the factored OSD-0 solutions differ from the transform's")
    return records


K3_MESSAGE_SPLIT = ("dem_check_kernel", "dem_var_kernel", "dem_syndrome_kernel",
                    "dem_freeze_kernel", "dem_init")


def phase_k3_bf16(eng, dev, card_line: str) -> dict:
    """K3's bf16 instances on a [[144]] DEM batch (phase 14b): both methods
    against the plain version in bf16 and summary against message path bit
    for bit; the float32 and bf16 instances of both paths timed in turns,
    with their device ms per pass and bytes per iteration; the engine's
    trials/s with float32 and with bf16 streams, in turns. Returns the
    record of the bf16 summary path (sum-product)."""
    from qldpc_tpu_torch.decoders import BPConfig, BPDecoder
    from qldpc_tpu_torch.ops.dem_bp_cuda import dem_bp_cuda, dem_bp_plain, summary_path

    B, tables, p = DEM_BATCH, eng.bp.tables(), 0.002
    prob, llr = eng.priors(p)
    rng = np.random.default_rng(3)
    mech = rng.random((B, eng.n_vars)) < prob.cpu().numpy()
    syn = eng._syndrome(torch.from_numpy(mech.astype(np.int8)).to(dev))
    label = f"{eng.code.name} p={p} bf16 streams"
    worst = 0.0
    for method in ("sum-product", "min-sum"):
        cfg = BPConfig(max_iter=50, method=method, stream_dtype="bfloat16")
        if not summary_path(tables, cfg):
            raise AssertionError(f"K3 {label}: the summary path does not apply")
        got, err = k3_held(eng, syn, llr, cfg, label)
        msg = dem_bp_cuda(syn, llr, tables, cfg, _store_r=True)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, msg))
        log(f"K3 {label} {method}: summary path against the message path bit for bit {same}")
        if not same:
            raise AssertionError(f"K3 {label} {method}: the two bf16 paths differ")
        worst = max(worst, err)

    cfg32 = BPConfig(max_iter=50)
    cfg16 = dataclasses.replace(cfg32, stream_dtype="bfloat16")
    calls = {
        "float32 summary": lambda: dem_bp_cuda(syn, llr, tables, cfg32),
        "bf16 summary": lambda: dem_bp_cuda(syn, llr, tables, cfg16),
        "bf16 message": lambda: dem_bp_cuda(syn, llr, tables, cfg16, _store_r=True),
        "float32 message": lambda: dem_bp_cuda(syn, llr, tables, cfg32, _store_r=True),
    }
    order = [*calls, *reversed(calls)]
    times = {name: [] for name in calls}
    for name in order:
        times[name].append(device_ms(calls[name], reps=1))
    iters = {name: int(fn()[2].max()) + 1 for name, fn in calls.items()}
    for name, fn in calls.items():
        split = kernel_device_ms(fn, K3_SPLIT if "summary" in name else K3_MESSAGE_SPLIT)
        log(f"K3 {eng.code.name} BP(50) sum-product p={p} B={B}, {name} path: device ms "
            f"{times[name][0]:.3f} / {times[name][1]:.3f} (in turns), {iters[name]} "
            f"iterations, peak memory {peak_bytes(fn) / 1e9:.3f} GB; per iteration "
            + ", ".join(f"{k} {v / iters[name]:.4f}" for k, v in split.items()))
    # device-memory bytes per iteration, every sample running (phase 11's
    # count): the summary path, either dtype, 12 B a real slot; the message
    # path in float32 reads Q twice, writes R, reads R and writes Q (20 B);
    # in bf16 it reads the 16-bit R and gathers the float32 posterior twice
    # and writes R in the check pass, and reads R in the variable pass (16 B)
    E, m, n = int(tables.check_deg.sum()), tables.m, tables.n
    per_var, per_check = n * B * 5, m * B
    moved = {"summary (either dtype)": 3 * E * B * 4 + 2 * m * B * 4 + per_var + per_check,
             "float32 message": 5 * E * B * 4 + per_var + 2 * per_check,
             "bf16 message": E * B * (4 + 8 + 2 + 2) + per_var + 2 * per_check}
    log(f"K3 {eng.code.name} B={B} bytes streamed per iteration: "
        + ", ".join(f"{k} {v / 1e9:.3f} GB ({v / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s)"
                    for k, v in moved.items()) + f" on {card_line}")

    rec = dict(ms=cuda_ms(calls["bf16 summary"], reps=2), device_ms=times["bf16 summary"][0],
               f32_device_ms=times["float32 summary"][0],
               message_device_ms=times["bf16 message"][0],
               plain_ms=cuda_ms(lambda: dem_bp_plain(syn, llr, tables, cfg16), reps=1),
               max_abs_err=worst,
               **bp_bound(syn, llr, tables, dem_bp_cuda(syn, llr, tables, cfg16)[2], E))

    bp32, bp16 = eng.bp, BPDecoder(eng.dem.H, cfg16).to(dev)
    rates = {}
    for name, dec in (("float32", bp32), ("bf16", bp16), ("bf16", bp16), ("float32", bp32)):
        eng.bp = dec
        rates.setdefault(name, []).append(steady_rate(eng, 0.001, 4 * DEM_BATCH))
    eng.bp = bp32
    log(f"DEM engine steady state {eng.code.name} p=0.001 in turns: float32 streams "
        f"{rates['float32'][0]:.1f} / {rates['float32'][1]:.1f} trials/s, bf16 streams "
        f"{rates['bf16'][0]:.1f} / {rates['bf16'][1]:.1f} trials/s, on {card_line}")
    return rec


def st_detectors(H: np.ndarray, T: int, p: float, B: int, seed: int) -> np.ndarray:
    """Space-time detectors d_t = H e_t + u_t + u_{t-1} from a numpy seed."""
    m, n = H.shape
    rng = np.random.default_rng(seed)
    e = (rng.random((B, T, n)) < p).astype(np.int64)
    u = (rng.random((B, T, m)) < p).astype(np.int64)
    s = np.einsum("btn,mn->btm", e, H) % 2
    u_prev = np.concatenate([np.zeros_like(u[:, :1]), u[:, :-1]], axis=1)
    return ((s + u + u_prev) % 2).reshape(B, T * m).astype(np.uint8)


def hold_bp(name: str, got, ref, exact: bool, B: int) -> tuple[float, int]:
    """K1's rule: at most 1 lane in 10^4 (at least 1) differing in decision
    and the posteriors of the rest within 1e-5, or bit for bit. Returns
    (max |dvalues| on agreeing lanes, lanes differing)."""
    kv, kc, ki, kh = got
    rv, rc, ri, rh = ref
    differ = (kc != rc) | (ki != ri) | (kh != rh).any(1)
    n_diff, agree = int(differ.sum()), ~differ
    err = float((kv[agree] - rv[agree]).abs().max()) if bool(agree.any()) else 0.0
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    log(f"{name}: B={B} converged {int(kc.sum())} mean iterations "
        f"{ki.float().mean().item():.3f} lanes differing in decision {n_diff} max "
        f"|dvalues| {err:.3g} bit-identical {same}")
    if exact and not same:
        raise AssertionError(f"{name} is not bit-identical to its plain version")
    if n_diff > max(1.0, DECISION_TOL * B):
        raise AssertionError(f"{name}: {n_diff} lanes differ in decision")
    if not torch.allclose(kv[agree], rv[agree], rtol=VALUE_TOL, atol=VALUE_TOL):
        raise AssertionError(f"{name}: posteriors differ beyond {VALUE_TOL}")
    return err, n_diff


def phase_k6(dev) -> tuple[dict, dict]:
    """K6 against the plain version at the space-time preset's shape, p =
    0.008. Returns its record (sum-product) and the BP failures there."""
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig
    from qldpc_tpu_torch.decoders.spacetime_bp import SpaceTimeBPDecoder
    from qldpc_tpu_torch.noise.spacetime import space_time_matrix, space_time_prior_llr
    from qldpc_tpu_torch.ops.spacetime_bp_cuda import launch_shape, st_bp_cuda, st_bp_plain

    H, T, B, p = get_code(ST_CODE).Hx, ST_ROUNDS, ST_BATCH, 0.008
    det = torch.from_numpy(st_detectors(H, T, p, B, seed=4)).to(dev)
    priors = space_time_prior_llr(H.shape[1], H.shape[0], T, p, device=dev)
    Hst = torch.from_numpy(space_time_matrix(H, T).astype(np.float32)).to(dev)
    worst, rec, failures = 0.0, None, None
    for method in ("sum-product", "min-sum"):
        cfg = BPConfig(max_iter=ST_ITERS, method=method)
        tables = SpaceTimeBPDecoder(H, T, cfg).to(dev).tables()
        got = st_bp_cuda(det, priors, tables, T, cfg)
        torch.cuda.synchronize()
        ref = st_bp_plain(det, priors, tables, T, cfg)
        torch.cuda.synchronize()
        err, _ = hold_bp(f"K6 {ST_CODE} T={T} BP({ST_ITERS}) {method} p={p}", got, ref,
                         exact=method == "min-sum", B=B)
        kv, kc, ki, kh = got
        if not bool((((kh.float() @ Hst.T) % 2) == det.float())[kc].all()):
            raise AssertionError(f"K6 {method}: a converged lane misses its detectors")
        worst = max(worst, err)
        if method == "sum-product":
            failures = dict(syn=det[~kc], llrs=kv[~kc], hard=kh[~kc])
            args = (det, priors, tables, T, cfg)
            edges = int(H.sum()) * T + (2 * T - 1) * H.shape[0]
            rec = dict(ms=cuda_ms(lambda: st_bp_cuda(*args), reps=10),
                       device_ms=device_ms(lambda: st_bp_cuda(*args), reps=10),
                       plain_ms=cuda_ms(lambda: st_bp_plain(*args), reps=1),
                       **bp_bound(det, priors, tables, ki, edges))
            S, C, threads = launch_shape(tables, T)
            log(f"K6 BP({ST_ITERS}) sum-product B={B}: {rec['ms']:.4f} ms per call "
                f"({rec['device_ms']:.4f} ms on the device), plain "
                f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}; "
                f"{edges} real edges of H_st); {S} sample(s) over a cluster of {C} blocks of "
                f"{threads} threads")
            # a batch lasts as long as its slowest samples: time the lanes
            # that run all iterations, then one of them alone
            late = det[~kc]
            ms_late = cuda_ms(lambda: st_bp_cuda(late, *args[1:]), reps=10)
            ms_one = cuda_ms(lambda: st_bp_cuda(late[:1].contiguous(), *args[1:]), reps=10)
            log(f"K6 BP({ST_ITERS}) sum-product: {ms_late:.4f} ms on the {late.shape[0]} "
                f"non-converging lanes alone, {ms_one:.4f} ms on one of them alone: "
                f"{ms_one / ST_ITERS * 1e3:.2f} us per iteration of one sample")
    rec["max_abs_err"] = worst
    return rec, failures


def phase_st_osd(dev, failures: dict) -> dict:
    """K4 on the space-time BP failures, against its plain version, timed
    there, and the OSD-0 solutions against the plain row elimination's (run
    on the card). Returns K4's record on these failures."""
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import OSDDecoder
    from qldpc_tpu_torch.noise.spacetime import space_time_matrix
    from qldpc_tpu_torch.ops.osd_cuda import eliminate_rows_plain, pack_rows
    from qldpc_tpu_torch.ops.osd_transform_cuda import (
        eliminate_transform_cuda,
        eliminate_transform_plain,
    )

    Hst = space_time_matrix(get_code(ST_CODE).Hx, ST_ROUNDS)
    osd = OSDDecoder(Hst).to(dev)
    if osd.elimination != "transform":
        raise AssertionError(f"OSD on H_st took {osd.elimination}, not the transform elimination")
    hard = failures["hard"].to(torch.int32)
    resid = osd._residual(failures["syn"], hard)
    order = torch.argsort(failures["llrs"].abs(), dim=1, stable=True)
    lanes = order.shape[0]
    args = (order, resid, osd.Hc, osd.h_rank, True)
    got = eliminate_transform_cuda(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, eliminate_transform_plain(*args)))
    log(f"K4 on {lanes} space-time BP failures (H_st {osd.m} x {osd.n}, rank {osd.h_rank}, "
        f"b-exit): mean rank reached {got[2].float().mean().item():.1f}, bit-identical {same}")
    if not same:
        raise AssertionError("K4 disagrees with its plain version on H_st")
    T, b, rank, piv = got
    log(f"K4 geometry on H_st: {k4_geometry(osd.m, piv)}")
    ms = cuda_ms(lambda: eliminate_transform_cuda(*args), reps=5)
    dev_ms = device_ms(lambda: eliminate_transform_cuda(*args), reps=5)
    plain_ms = cuda_ms(lambda: eliminate_transform_plain(*args), reps=1)
    cols = float((piv.max(dim=1).values.to(torch.int64) + 1).sum())
    moved = nbytes(order.to(torch.int32), resid, osd.Hc, T, b, rank, piv)
    rec = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, lanes=lanes,
               **bound(moved, cols * osd.m * osd.m_words * 2))
    log(f"K4 on H_st: {ms:.4f} ms ({dev_ms:.4f} ms on the device), plain {plain_ms:.4f} ms, "
        f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}; {lanes} lanes, b-exit on)")
    k, n = min(SOLUTION_LANES, lanes), osd.n
    sol = osd(failures["syn"][:k], failures["llrs"][:k], failures["hard"][:k]).to(torch.int32)
    H = torch.from_numpy(Hst).to(dev)
    _, b, piv = eliminate_rows_plain(pack_rows(H[:, order[:k]].permute(1, 0, 2)), resid[:k], n,
                                     osd.h_rank)
    bidx = torch.arange(k, device=dev)[:, None]
    e_perm = torch.zeros((k, n + 1), dtype=torch.int32, device=dev)
    e_perm[bidx, torch.where(piv >= 0, piv, n).long()] = b
    corr = torch.zeros((k, n), dtype=torch.int32, device=dev)
    corr[bidx, order[:k]] = e_perm[:, :n]
    same = torch.equal(sol, hard[:k] ^ corr)
    log(f"OSD-0 solutions on {k} space-time BP failures against the plain row "
        f"elimination's: identical {same}")
    if not same:
        raise AssertionError("the OSD-0 solutions on H_st differ from the row elimination's")
    return rec


def st_engine(dev, bp_cfg=None, code: str = ST_CODE, rounds: int = ST_ROUNDS,
              batch: int = ST_BATCH):
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
    from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine

    cfg = EngineConfig(bp=bp_cfg or BPConfig(max_iter=ST_ITERS), osd=OSDConfig(order=0),
                       channel="space-time", n_rounds=rounds, batch_size=batch)
    return MonteCarloEngine(get_code(code), cfg, device=dev)


def scalars(d: dict) -> dict:
    return {k: v for k, v in d.items() if not isinstance(v, np.ndarray)}


def hists(d: dict) -> dict:
    return {k: {int(i): int(v[i]) for i in np.nonzero(v)[0]}
            for k, v in d.items() if isinstance(v, np.ndarray)}


def phase_st_engine(dev, card_line: str) -> dict:
    """The space-time engine's sweep; K6 and K4 must launch, K2 never."""
    from qldpc_tpu_torch.ops import osd_cuda, osd_transform_cuda, spacetime_bp_cuda

    eng = st_engine(dev)
    wrappers = {"st_bp": spacetime_bp_cuda.st_bp_cuda,
                "gf2_transform_elim": osd_transform_cuda.eliminate_transform_cuda,
                "gf2_elim": osd_cuda.eliminate_ordered_cuda}
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    res = eng.sweep(list(ST_RATES), trials=ST_TRIALS, seed=ST_SEED)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"space-time engine sweep {ST_CODE} T={ST_ROUNDS} BP({ST_ITERS})+OSD-0, {ST_TRIALS} "
        f"trials per rate, batch {ST_BATCH}: wall {res.wall_time_s:.3f} s, "
        f"{res.throughput:.1f} trials/s (first use included) on {card_line}")
    log(f"space-time engine kernel launches in the sweep: {json.dumps(launches)}")
    if launches["st_bp"] < 1 or launches["gf2_transform_elim"] < 1:
        raise AssertionError("the space-time sweep did not launch K6 and K4")
    if launches["gf2_elim"]:
        raise AssertionError("the space-time sweep launched K2")
    for p, d in zip(ST_RATES, res.per_rate):
        log(f"space-time engine p={p}: {json.dumps(scalars(d))}")
        log(f"  LER {d['ler']:.5f}, OSD rate {d['osd']:.5f}, mean BP iterations "
            f"{d['average_iterations']:.3f}")
        if d["trials"] != ST_TRIALS or d["BPs_fault"] != round(d["osd"] * ST_TRIALS):
            raise AssertionError("space-time engine counters are inconsistent")
    d = res.per_rate[ST_RATES.index(JAX_ST_P)]
    for key in ("ler", "osd"):
        lim = binomial_limit(d[key], d["trials"], JAX_ST_SUM_PRODUCT[key], JAX_ST_TRIALS)
        log(f"  sum-product {key} at p={JAX_ST_P}: {d[key]:.5f} against the JAX engine's "
            f"{JAX_ST_SUM_PRODUCT[key]:.5f} (limit +-{lim:.5f})")
        if abs(d[key] - JAX_ST_SUM_PRODUCT[key]) > lim:
            raise AssertionError(f"space-time {key} is outside 4 sigma of the JAX engine's")
    return launches


def phase_st_engine_checks(dev) -> None:
    """(a) the card's space-time engine against the CPU engine on small
    inputs, min-sum; (b) against the JAX engine's recorded min-sum counters."""
    from qldpc_tpu_torch.decoders import BPConfig
    from qldpc_tpu_torch.mc import counters_to_dict

    ms = BPConfig(max_iter=ST_ITERS, method="min-sum")
    for code, T, trials in ST_CPU_CHECKS:
        card_eng = st_engine(dev, ms, code=code, rounds=T, batch=trials)
        cpu_eng = st_engine("cpu", ms, code=code, rounds=T, batch=trials)
        if card_eng.osd.elimination != cpu_eng.osd.elimination:
            raise AssertionError("the card and the CPU picked different eliminations")
        got = counters_to_dict(card_eng.run_rate(JAX_ST_P, trials, seed=1))
        ref = counters_to_dict(cpu_eng.run_rate(JAX_ST_P, trials, seed=1))
        same = all(np.array_equal(got[k], ref[k]) for k in ref)
        log(f"space-time engine on the card vs the CPU engine, {code} T={T}, "
            f"{card_eng.osd.elimination} elimination, min-sum p={JAX_ST_P}, {trials} trials: "
            f"identical {same} (ler {got['ler']:.5f}, BP faults {got['BPs_fault']})")
        if not same:
            raise AssertionError("the card's space-time engine disagrees with the CPU engine")
    got = counters_to_dict(st_engine(dev, ms).run_rate(JAX_ST_P, JAX_ST_TRIALS, seed=JAX_ST_SEED))
    got = {**scalars(got), **hists(got)}
    differ = {k: (got[k], v) for k, v in JAX_ST_MIN_SUM.items() if got[k] != v}
    log(f"space-time engine min-sum on the card vs the JAX engine, {ST_CODE} T={ST_ROUNDS}, "
        f"p={JAX_ST_P}, {JAX_ST_TRIALS} trials: identical {not differ} (ler {got['ler']:.5f}, "
        f"BP faults {got['BPs_fault']}, OSD histogram {got['weights_found_OSD']})")
    if differ:
        raise AssertionError(f"the space-time counters differ from the JAX engine's: {differ}")


def phase_k7(H: np.ndarray, dev) -> dict:
    """K7 against the plain version at [[144,12,12]] code capacity, B =
    65,536, p = 0.050119, BP(50), L = 4. Returns its record (sum-product)."""
    from qldpc_tpu_torch.decoders import BPConfig, BPDecoder
    from qldpc_tpu_torch.ops.bp_layered_cuda import bp_layered_cuda, bp_layered_plain, layer_count

    B, p = LAYERED_BATCH, REF_P
    _, syn_np = sample(H, p, B, seed=5)
    syn = torch.from_numpy(syn_np).to(dev)
    prior = torch.full((H.shape[1],), math.log((1 - p) / p), dtype=torch.float32, device=dev)
    worst, rec = 0.0, None
    for method in ("sum-product", "min-sum"):
        cfg = BPConfig(max_iter=50, method=method, schedule="layered")
        tables = BPDecoder(H, cfg).to(dev).tables()
        got = bp_layered_cuda(syn, prior, tables, cfg)
        torch.cuda.synchronize()
        ref = bp_layered_plain(syn, prior, tables, cfg)
        torch.cuda.synchronize()
        err, _ = hold_bp(f"K7 {CODE} BP(50) layered L={layer_count(H.shape[0])} {method} p={p}",
                         got, ref, exact=method == "min-sum", B=B)
        worst = max(worst, err)
        if method == "sum-product":
            args = (syn, prior, tables, cfg)
            rec = dict(ms=cuda_ms(lambda: bp_layered_cuda(*args), reps=5),
                       device_ms=device_ms(lambda: bp_layered_cuda(*args), reps=5),
                       plain_ms=cuda_ms(lambda: bp_layered_plain(*args), reps=1),
                       **bp_bound(syn, prior, tables, got[2], int(H.sum())))
            log(f"K7 BP(50) sum-product B={B}: {rec['ms']:.4f} ms per call "
                f"({rec['device_ms']:.4f} ms on the device), plain "
                f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")
    rec["max_abs_err"] = worst
    return rec


def phase_layered_engine(dev, card_line: str) -> dict:
    """The layered engine at p = 0.050119: K7 and K2 must launch; its LER
    against the JAX layered engine's; its counters against the CPU engine's
    on a small input (min-sum)."""
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
    from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine, counters_to_dict
    from qldpc_tpu_torch.ops import bp_cuda, bp_layered_cuda, osd_cuda

    code = get_code(CODE)
    eng = MonteCarloEngine(code, EngineConfig(
        bp=BPConfig(max_iter=50, schedule="layered"), osd=OSDConfig(order=0),
        batch_size=LAYERED_BATCH), device=dev)
    wrappers = {"bp_layered": bp_layered_cuda.bp_layered_cuda,
                "gf2_elim": osd_cuda.eliminate_ordered_cuda,
                "bp_flooding": bp_cuda.bp_flooding_cuda}
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    d = counters_to_dict(eng.run_rate(REF_P, JAX_LAYERED["trials"], seed=LAYERED_SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"layered engine {CODE} BP(50)+OSD-0 p={REF_P}, {d['trials']} trials: wall {wall:.3f} s "
        f"(first use included) on {card_line}; launches {json.dumps(launches)}")
    log(f"layered engine p={REF_P}: {json.dumps(scalars(d))}")
    if launches["bp_layered"] < 1 or launches["gf2_elim"] < 1 or launches["bp_flooding"]:
        raise AssertionError("the layered engine did not run K7 and K2 alone")
    for key in ("ler", "osd"):
        lim = binomial_limit(d[key], d["trials"], JAX_LAYERED[key], JAX_LAYERED["trials"])
        log(f"  {key} {d[key]:.5f} against the JAX layered engine's {JAX_LAYERED[key]:.5f} "
            f"(limit +-{lim:.5f}); mean iterations {d['average_iterations']:.4f} against "
            f"{JAX_LAYERED['average_iterations']:.4f}")
        if abs(d[key] - JAX_LAYERED[key]) > lim:
            raise AssertionError(f"layered {key} is outside 4 sigma of the JAX engine's")
    log(f"layered engine steady state: {steady_rate(eng, REF_P, LAYERED_BATCH):.1f} trials/s "
        f"with K7 and K2, on {card_line}")
    cfg = EngineConfig(bp=BPConfig(max_iter=50, method="min-sum", schedule="layered"),
                       osd=OSDConfig(order=0), batch_size=2048)
    got = counters_to_dict(MonteCarloEngine(code, cfg, device=dev).run_rate(0.04, 2048, seed=1))
    ref = counters_to_dict(MonteCarloEngine(code, cfg, device="cpu").run_rate(0.04, 2048, seed=1))
    same = all(np.array_equal(got[k], ref[k]) for k in ref)
    log(f"layered engine on the card vs the CPU engine, {CODE} min-sum p=0.04, 2048 trials: "
        f"identical {same} (ler {got['ler']:.5f}, BP faults {got['BPs_fault']})")
    if not same:
        raise AssertionError("the card's layered engine disagrees with the CPU engine")
    return launches


# ------------------------------------------------ the CLI and the rest of the family
# the JAX package's bf16-stream cells, 10,000 trials (results/
# circuit_bf16_val_r5, docs/circuit_ler.md:25-34): p -> (obs-err, OSD rate)
CLI_CODES = {"[[90, 8, 10]]": {0.001: (0.004, 0.6942), 0.002: (0.0472, 0.9225)},
             "[[108, 8, 10]]": {0.001: (0.0018, 0.7533), 0.002: (0.0263, 0.9529)}}
CLI_TRIALS = 10_240
CKPT_INTERRUPT = 2  # batches before the interruption
DEM288_CODE, DEM288_P, DEM288_BATCH = "[[288, 12, 18]]", 0.003, 1024
K5_CHECK_BLOCKS, K5_CHECK_FAILURES = 2, 64
ST288_K4G_LANES = 8  # [[288]] space-time BP failures K4g is held on, without the b-exit
K3_288_LANES = 256  # samples of a [[288]] DEM batch K3 is held on
ST288_ROUNDS, ST288_RATES, ST288_TRIALS, ST288_CPU_TRIALS = 18, (0.004, 0.008), 1024, 16
# K4g past 9,312 rows: synthetic wide systems (rows, columns, dependent
# rows): the first size past the shared layout, 12,288, and 20,736 (the
# [[288]] code's 288 detectors a round over 72 rounds)
WIDE_SIZES = ((9313, 37400, 8), (12288, 49300, 8), (20736, 83000, 8))
WIDE_LANES = 1  # outside H's image: the walk to rank(H)


class Interrupted(Exception):
    pass


def capture_engines():
    """Patch ``runners.build_engine`` so that every engine run_experiment
    builds is kept (its run_rate timed per call); returns (patch, engines,
    rates) with rates a list of (code, p, trials, seconds)."""
    from qldpc_tpu_torch.experiments import runners

    engines, rates = [], []
    build = runners.build_engine

    def keep(*a, **kw):
        eng = build(*a, **kw)
        run_rate = eng.run_rate

        def timed(p, trials, **kw2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run_rate(p, trials, **kw2)
            rates.append((eng.code.name, p, trials, time.perf_counter() - t0))
            return out

        eng.run_rate = timed
        engines.append(eng)
        return eng

    return mock.patch.object(runners, "build_engine", keep), engines, rates


def phase_cli_dems(dev, card_line: str, out_dir: str) -> dict:
    """The experiments CLI on the card: complete-bposd as shipped (bf16
    streams) on the [[90]] and [[108]] DEMs, read back from its npz; obs-err
    and OSD rate within 4 sigma of the JAX package's bf16 cells. Both DEMs
    take K3's bf16 instances and K4 (never K5): the counts are zeroed before
    the CLI runs and read after.
    Then K4 is held to its plain version on each DEM's BP failures, with and
    without the b-exit (the [[108]] DEM's 1,080 rows take K4's instance for
    more than 1,024 rows, which no earlier phase runs)."""
    from qldpc_tpu_torch.experiments.cli import main as cli_main
    from qldpc_tpu_torch.experiments.results_io import load_results
    from qldpc_tpu_torch.ops import dem_bp_cuda, osd_factored_cuda, osd_transform_cuda

    wrappers = {"dem_bp": dem_bp_cuda.dem_bp_cuda,
                "gf2_transform_elim": osd_transform_cuda.eliminate_transform_cuda,
                **{name: getattr(osd_factored_cuda, f"{name}_cuda") for name in K5_NAMES}}
    patch, engines, rates = capture_engines()
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    dem_bp_cuda.dem_bp_cuda.bf16_launches = 0
    t0 = time.perf_counter()
    with patch:
        code = cli_main(["run", "complete-bposd", "--codes", *CLI_CODES, "--error-rates",
                         "0.001", "0.002", "--trials", str(CLI_TRIALS), "--out", out_dir,
                         "--no-checkpoint"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    launches["dem_bp_bf16"] = dem_bp_cuda.dem_bp_cuda.bf16_launches
    log(f"CLI complete-bposd on {list(CLI_CODES)}: exit {code}, {wall:.1f} s (DEM builds "
        f"included), kernel launches {json.dumps(launches)} on {card_line}")
    if code != 0:
        raise AssertionError(f"the CLI exited {code}")
    if launches["dem_bp"] < 1 or launches["gf2_transform_elim"] < 1:
        raise AssertionError("the CLI's run did not launch K3 and K4")
    if launches["dem_bp_bf16"] != launches["dem_bp"]:
        raise AssertionError("the CLI's run launched K3 without its bf16 streams")
    if load_results(f"{out_dir}/complete-bposd.npz")["_meta"]["spec"]["bp_stream_dtype"] \
            != "bfloat16":
        raise AssertionError("the CLI's archived spec does not say bfloat16")
    if any(launches[name] for name in K5_NAMES):
        raise AssertionError("the CLI's run launched K5 on the [[90]] or [[108]] DEM")
    for name, p, trials, secs in rates:
        log(f"  {name} p={p}: {trials / secs:.1f} trials/s")
    res = load_results(f"{out_dir}/complete-bposd.npz")
    for eng in engines:
        refs = CLI_CODES[eng.code.name]
        if eng.osd.elimination != "transform":
            raise AssertionError(f"{eng.code.name}: OSD took {eng.osd.elimination}, not K4")
        syn, llrs, hard = dem_failures(eng, 0.002, seed=5)
        order, resid = k4_held(eng.osd, syn, llrs, hard, f"{eng.code.name} DEM")
        piv = osd_transform_cuda.eliminate_transform_cuda(order, resid, eng.osd.Hc,
                                                          eng.osd.h_rank, True)[3]
        log(f"{eng.code.name} DEM {eng.m_checks} x {eng.n_vars}, rank {eng.osd.h_rank}: K4 "
            f"geometry on {order.shape[0]} BP failures: {k4_geometry(eng.osd.m, piv)}")
        for p, (ref_err, ref_osd) in refs.items():
            d = res[eng.code.name][p]
            log(f"  {eng.code.name} p={p}: {json.dumps(scalars(d))}")
            for what, got, ref in (("obs-err", d["ler"], ref_err), ("OSD rate", d["osd"], ref_osd)):
                lim = binomial_limit(got, d["trials"], ref, DEM_REF_TRIALS)
                log(f"    {what} {got:.5f} against {ref} (limit +-{lim:.5f})")
                if abs(got - ref) > lim or d["trials"] != CLI_TRIALS:
                    raise AssertionError(f"{eng.code.name} {what} at p={p}: {got} is outside "
                                         f"4 sigma of {ref}")
    return launches


def dem_failures(eng, p: float, seed: int):
    """One batch of the engine at p: the BP failures' syndromes, LLRs and
    hard decisions."""
    from qldpc_tpu_torch.utils import rng

    _, syn, priors = eng._sample(rng.key(seed), p)
    res = eng.bp(syn, priors)
    fail = ~res.converged
    return syn[fail], res.llrs[fail], res.hard[fail]


def interrupted_then_resumed(eng, p: float, trials: int, seed: int, path) -> dict:
    """A CheckpointManager run stopped after CKPT_INTERRUPT batches, then
    resumed; returns the resumed run's counters."""
    from qldpc_tpu_torch.mc import CheckpointManager, counters_to_dict

    mgr = CheckpointManager(path)
    save = mgr.save

    def save_then_stop(engine, p_, seed_, counters, next_batch):
        save(engine, p_, seed_, counters, next_batch)
        if next_batch == CKPT_INTERRUPT:
            raise Interrupted

    mgr.save = save_then_stop
    try:
        mgr.run_rate(eng, p, trials, seed)
        raise AssertionError("the interrupted run was not interrupted")
    except Interrupted:
        pass
    fresh = CheckpointManager(path)
    if fresh.load(eng, p, seed)[1] != CKPT_INTERRUPT:
        raise AssertionError("the checkpoint does not hold the interrupted batches")
    return counters_to_dict(fresh.run_rate(eng, p, trials, seed))


def phase_checkpoints(dev, out_dir: str) -> None:
    """On the card: the [[144]] code-capacity engine and the [[72]] DEM
    engine interrupted after CKPT_INTERRUPT batches and resumed, against an
    uninterrupted run_rate and the same rate run through the CLI."""
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
    from qldpc_tpu_torch.experiments.cli import main as cli_main
    from qldpc_tpu_torch.experiments.results_io import load_results
    from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine, counters_to_dict

    cc = MonteCarloEngine(get_code(CODE), EngineConfig(bp=BPConfig(max_iter=50),
                          osd=OSDConfig(order=0), batch_size=ENGINE_BATCH), device=dev)
    cases = (
        ("code capacity", cc, REF_P, 4 * ENGINE_BATCH, 11,
         ["study", "--codes", CODE, "--batch-size", str(ENGINE_BATCH)]),
        ("DEM", dem_engine(dev), 0.002, 4 * DEM_BATCH, 12,
         ["complete-bposd", "--codes", DEM_CODE, "--batch-size", str(DEM_BATCH),
          "--set", "bp_stream_dtype=float32"]),
    )
    for name, eng, p, trials, seed, cli_args in cases:
        whole = counters_to_dict(eng.run_rate(p, trials, seed=seed))
        resumed = interrupted_then_resumed(eng, p, trials, seed, f"{out_dir}/ckpt-{seed}")
        out = f"{out_dir}/cli-{seed}"
        if cli_main(["run", *cli_args, "--error-rates", str(p), "--trials", str(trials),
                     "--seed", str(seed), "--out", out, "--no-checkpoint", "--quiet"]):
            raise AssertionError("the CLI run failed")
        preset = cli_args[0]
        cli = load_results(f"{out}/{preset}.npz")[cli_args[2]][p]
        same = {k: np.array_equal(resumed[k], whole[k]) and np.array_equal(cli[k], whole[k])
                for k in whole}
        log(f"checkpointed {name} run on the card ({eng.code.name}, p={p}, {trials} trials, "
            f"interrupted after {CKPT_INTERRUPT} batches, resumed): equal to the "
            f"uninterrupted run and to the CLI's {all(same.values())} (ler {whole['ler']:.5f}, "
            f"BP faults {whole['BPs_fault']})")
        if not all(same.values()):
            raise AssertionError(f"{name}: resumed or CLI counters differ: "
                                 f"{[k for k, v in same.items() if not v]}")


def k5_checked_blocks(osd, syn, llrs, hard, label: str) -> None:
    """K5a-d against their plain versions at the first K5_CHECK_BLOCKS
    blocks of one OSD call on the first K5_CHECK_FAILURES BP failures (each
    launch on a copy of its inputs, the outputs and in-place state compared
    bit for bit); the later blocks run the kernels alone."""
    from qldpc_tpu_torch.ops import osd_factored_cuda as ofc

    k = min(K5_CHECK_FAILURES, syn.shape[0])
    if k < 8:
        raise AssertionError(f"{label}: only {k} BP failures to hold K5 on")
    resid = osd._residual(syn[:k], hard[:k].to(torch.int32))
    order = torch.argsort(llrs[:k].abs(), dim=1, stable=True)
    calls = dict.fromkeys(K5_NAMES, 0)

    def checked(name, kernel, plain):
        def run(*a):
            if calls[name] < K5_CHECK_BLOCKS:
                kargs = [x.clone() if torch.is_tensor(x) else x for x in a]
                pargs = [x.clone() if torch.is_tensor(x) else x for x in a]
                kout, pout = kernel(*kargs), plain(*pargs)
                torch.cuda.synchronize()
                outs = [(kout, pout)] if kout is not None else []
                outs += [(x, y) for x, y in zip(kargs, pargs) if torch.is_tensor(x)]
                if not all(torch.equal(x, y) for x, y in outs):
                    raise AssertionError(f"{label}: {name} disagrees with its plain version "
                                         f"at block {calls[name]}")
            calls[name] += 1
            return kernel(*a)

        run.launches = 0  # the wrapper counts under its module name: here
        return run

    patches = [mock.patch.object(ofc, f"{name}_cuda", checked(
        name, getattr(ofc, f"{name}_cuda"), getattr(ofc, f"{name}_plain"))) for name in K5_NAMES]
    for patch in patches:
        patch.start()
    try:
        ofc.eliminate_factored_cuda(order, resid, osd.Hc, osd.h_rank, osd.max_cols)
    finally:
        for patch in patches:
            patch.stop()
    torch.cuda.synchronize()
    log(f"{label}: K5a-d bit-identical to their plain versions at blocks 0-"
        f"{K5_CHECK_BLOCKS - 1} of one OSD call on {k} BP failures (m={osd.m}, n={osd.n}, "
        f"rank {osd.h_rank}; launches a kernel in that call {json.dumps(calls)})")


def k5_device_ms(osd, syn, llrs, hard) -> dict:
    """Each K5 kernel's device ms summed over the launches of one OSD call
    on these failures (each launch timed by ``launch_ms``), and K5a's and
    K5b's ``library_ms`` over the same blocks (``k5_library_ms``, held to
    each launch's output, in a second call after the first one's timing)."""
    from qldpc_tpu_torch.ops import osd_factored_cuda as ofc

    resid = osd._residual(syn, hard.to(torch.int32))
    order = torch.argsort(llrs.abs(), dim=1, stable=True)
    recs = {name: dict(device_ms=0.0, launches=0, lanes=order.shape[0]) for name in K5_NAMES}

    library = []

    def timed(name, kernel):
        def run(*a):
            if library:  # the second pass: the library's products, untimed kernels
                out = kernel(*a)
                if name in ("factored_y", "factored_w"):  # neither changes its inputs
                    recs[name]["library_ms"] = recs[name].get("library_ms", 0.0) + \
                        k5_library_ms(name, a, out)
                return out
            ms, out = launch_ms(lambda: kernel(*a))
            recs[name]["device_ms"] += ms
            recs[name]["launches"] += 1
            return out

        run.launches = 0  # the wrapper counts under its module name: here
        return run

    patches = [mock.patch.object(ofc, f"{name}_cuda", timed(name, getattr(ofc, f"{name}_cuda")))
               for name in K5_NAMES]
    for patch in patches:
        patch.start()
    try:
        t0 = time.perf_counter()
        ofc.eliminate_factored_cuda(order, resid, osd.Hc, osd.h_rank, osd.max_cols)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for patch in patches:
            patch.stop()
    ms = cuda_ms(lambda: ofc.eliminate_factored_cuda(order, resid, osd.Hc, osd.h_rank,
                                                      osd.max_cols), reps=1)
    library.append(True)
    for patch in patches:
        patch.start()
    try:
        ofc.eliminate_factored_cuda(order, resid, osd.Hc, osd.h_rank, osd.max_cols)
    finally:
        for patch in patches:
            patch.stop()
    log(f"K5 over one OSD call on {order.shape[0]} BP failures (m={osd.m}): " + ", ".join(
        f"{n} {r['device_ms']:.3f} ms on the device in {r['launches']} launches"
        for n, r in recs.items()) + f"; the call {ms:.3f} ms with its host syncs "
        f"({wall * 1e3:.1f} ms with each launch timed); the same products as one float16 "
        f"torch.bmm (float32 out) a block, over the call: " + ", ".join(
            f"{n} {recs[n]['library_ms']:.3f} ms on the device" for n in ("factored_y", "factored_w")))
    return recs


def phase_dem288(dev, card_line: str, out_dir: str) -> dict:
    """The [[288]] DEM: one batch of 1,024 at p = 0.003 through
    run_experiment with complete-bposd's OSD-0 (float32 streams: obs-err,
    logical errors, OSD rate, peak memory, stage times, K4g's launches and
    the samples it took): every BP failure within the factored column
    budget keeps the factored elimination's solution, and those past it
    take the transform (K4g), as the JAX lanes path, which has no budget,
    solves every sample. Then K3 held to its plain version on K3_288_LANES
    samples of a batch (the preset's BP(50), sum-product and min-sum),
    K5a-d held to their plain versions at blocks 0 and 1 of one OSD call;
    on the BP failures of a second batch, those past the budget counted,
    K4g on them against its plain version (T, b, rank, piv) and timed, the
    decoder's solutions on them against the plain transform's OSD-0, each
    satisfying its syndrome; and K5's device ms over a whole OSD call.
    Returns K5's records at [[288]], K4g's OSD-0 record and the engine."""
    from qldpc_tpu_torch.experiments import get_preset, run_experiment
    from qldpc_tpu_torch.ops import osd_factored_cuda, osd_transform_cuda as otc
    from qldpc_tpu_torch.utils import rng

    spec = get_preset("complete-bposd").replace(
        codes=[DEM288_CODE], error_rates=[DEM288_P], trials=DEM288_BATCH,
        batch_size=DEM288_BATCH, bp_stream_dtype="float32", output_dir=out_dir)
    patch, engines, _ = capture_engines()
    k4g = otc.eliminate_transform_global_cuda
    taken = []

    def counted(order, *a, **kw):
        taken.append(order.shape[0])
        return k4g(order, *a, **kw)

    counted.launches = 0  # the wrapper counts under its module name: here
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with patch, mock.patch.object(otc, "eliminate_transform_global_cuda", counted):
        res = run_experiment(spec, device=dev, checkpoint=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4g_launches = counted.launches
    peak = torch.cuda.max_memory_allocated()
    d = res[DEM288_CODE][DEM288_P]
    eng = engines[0]
    osd = eng.osd
    log(f"[[288]] DEM {eng.m_checks} x {eng.n_vars}, rank {osd.h_rank}, OSD-{osd.config.order}"
        f" route {osd.elimination}, column budget {osd.max_cols}: one batch of {DEM288_BATCH} "
        f"at p={DEM288_P} through run_experiment in {wall:.1f} s (the host's DEM and engine "
        f"build included), peak device memory {peak / 2**30:.2f} GiB, K4g launched "
        f"{k4g_launches} time(s) on {sum(taken)} BP failures past the budget, on {card_line}")
    log(f"  {json.dumps(scalars(d))}")
    log(f"  obs-err {d['ler']:.5f} ({round(d['ler'] * d['trials'])} logical errors of "
        f"{d['trials']}), OSD rate {d['osd']:.5f} (docs/circuit_ler.md:34: 0.0384 obs-err at "
        f"10,000 trials, float32, from the TPU's budgeted route)")
    if d["trials"] != DEM288_BATCH or d["BPs_fault"] != round(d["osd"] * DEM288_BATCH):
        raise AssertionError("[[288]] DEM counters are inconsistent")
    if osd.config.order or osd.elimination != "factored+transform" or k4g_launches < 1:
        raise AssertionError("[[288]] DEM OSD-0 did not send the samples past the factored "
                             "budget through K4g")
    _, syn, llr = eng._sample(rng.key(7), DEM288_P)
    for method in ("sum-product", "min-sum"):
        k3_held(eng, syn[:K3_288_LANES], llr, dataclasses.replace(eng.bp.config, method=method),
                f"[[288]] DEM p={DEM288_P}, {K3_288_LANES} of the batch's {DEM288_BATCH} samples")
    syn, llrs, hard = dem_failures(eng, DEM288_P, seed=7)
    k5_checked_blocks(osd, syn, llrs, hard, "[[288]] DEM")
    order = torch.argsort(llrs.abs(), dim=1, stable=True)
    resid = osd._residual(syn, hard.to(torch.int32))
    overflow = osd_factored_cuda.eliminate_factored_cuda(order, resid, osd.Hc, osd.h_rank,
                                                         osd.max_cols)[3]
    rec = dict(past_budget=int(overflow.sum()),
               bp_failures=len(syn), logical_errors=round(d["ler"] * d["trials"]),
               run_launches=k4g_launches, run_lanes=sum(taken))
    over = torch.nonzero(overflow).flatten()
    if len(over):
        args = (order[over], resid[over], osd.Hc[:osd.n], osd.h_rank, True)
        ms, dev_ms, got = timed_call(lambda: k4g(*args))
        plain_ms, _, ref = timed_call(lambda: otc.eliminate_transform_plain(*args))
        same = all(torch.equal(x, y) for x, y in zip(got, ref))
        sol = osd(syn[over], llrs[over], hard[over]).to(torch.int32)
        osd0 = transform_osd0(order[over], ref[1], ref[3], hard[over].to(torch.int32))
        solved = ~osd._residual(syn[over], sol).bool().any(dim=1)
        log(f"  BP failures of a second batch past the factored column budget "
            f"({osd.max_cols}): {len(over)} of {len(syn)}; K4g on them {ms:.2f} ms "
            f"({dev_ms:.2f} on the device), plain {plain_ms:.1f} ms, T, b, rank and piv "
            f"bit-identical: {same}; the decoder's solutions equal the plain transform's "
            f"OSD-0: {torch.equal(sol, osd0)}; each satisfies its syndrome: "
            f"{bool(solved.all())}")
        if not (same and torch.equal(sol, osd0) and bool(solved.all())):
            raise AssertionError("[[288]] DEM: a sample past the budget is not solved as the "
                                 "plain transform solves it")
        rec.update(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, lanes=len(over))
    else:
        log(f"  no BP failure of the second batch passed the factored column budget")
    return k5_device_ms(osd, syn, llrs, hard), rec, eng


def phase_st288(dev, card_line: str) -> dict:
    """[[288]] space-time at T = 18 (H_st 2,592 x 7,776): the card engine's
    min-sum counters against the CPU engine's, K5a-d against their plain
    versions at blocks 0 and 1 of one OSD call on H_st, the card's OSD-0
    solutions against the plain row elimination's, and the LER and OSD rate
    at p = 0.004 and 0.008 (K6 and K5 launch, K4 and K2 never); the card
    engine's min-sum counters against the JAX engine's recorded ones
    (JAX_ST288), identical; then K4g against its plain version on a few BP
    failures, without the b-exit (H_st's rows are independent, so every
    lane walks to rank(H)), bit for bit (scripts/probe_k4g.py times it), and
    OSD-e(7) on them through the decoder (in-image syndromes: OSD-0 after
    the consistency test), no solution costing more than the transform's
    OSD-0."""
    from qldpc_tpu_torch.decoders import OSDConfig, OSDDecoder
    from qldpc_tpu_torch.decoders import BPConfig
    from qldpc_tpu_torch.mc import counters_to_dict
    from qldpc_tpu_torch.ops import osd_cuda, osd_factored_cuda, osd_transform_cuda
    from qldpc_tpu_torch.ops import spacetime_bp_cuda
    from qldpc_tpu_torch.ops.osd_cuda import eliminate_rows_plain, pack_rows
    from qldpc_tpu_torch.noise.spacetime import space_time_matrix
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.utils import rng

    code, T = DEM288_CODE, ST288_ROUNDS
    ms = BPConfig(max_iter=ST_ITERS, method="min-sum")
    card_eng = st_engine(dev, ms, code=code, rounds=T, batch=ST288_CPU_TRIALS)
    cpu_eng = st_engine("cpu", ms, code=code, rounds=T, batch=ST288_CPU_TRIALS)
    if card_eng.osd.elimination != cpu_eng.osd.elimination:
        raise AssertionError("the card and the CPU picked different eliminations")
    got = counters_to_dict(card_eng.run_rate(0.008, ST288_CPU_TRIALS, seed=1))
    ref = counters_to_dict(cpu_eng.run_rate(0.008, ST288_CPU_TRIALS, seed=1))
    same = all(np.array_equal(got[k], ref[k]) for k in ref)
    log(f"space-time engine on the card vs the CPU engine, {code} T={T} (H_st "
        f"{card_eng.m_checks} x {card_eng.n_vars}, {card_eng.osd.elimination} elimination), "
        f"min-sum p=0.008, {ST288_CPU_TRIALS} trials: identical {same} (ler {got['ler']:.5f}, "
        f"BP faults {got['BPs_fault']})")
    if not same:
        raise AssertionError("the card's [[288]] space-time engine disagrees with the CPU's")

    eng = st_engine(dev, code=code, rounds=T)
    _, syn, priors = eng._sample(rng.key(3), 0.008)
    res = eng.bp(syn, priors)
    fail = ~res.converged
    syn_f, llrs_f, hard_f = syn[fail], res.llrs[fail], res.hard[fail]
    k5_checked_blocks(eng.osd, syn_f, llrs_f, hard_f, f"{code} H_st T={T}")
    k = min(SOLUTION_LANES, syn_f.shape[0])
    sol = eng.osd(syn_f[:k], llrs_f[:k], hard_f[:k]).to(torch.int32)
    hard = hard_f[:k].to(torch.int32)
    resid = eng.osd._residual(syn_f[:k], hard)
    order = torch.argsort(llrs_f[:k].abs(), dim=1, stable=True)
    n = eng.osd.n
    Hst_np = space_time_matrix(get_code(code).Hx, T)
    Hst = torch.from_numpy(Hst_np).to(dev)
    _, b, piv = eliminate_rows_plain(pack_rows(Hst[:, order].permute(1, 0, 2)), resid, n,
                                     eng.osd.h_rank)
    bidx = torch.arange(k, device=dev)[:, None]
    e_perm = torch.zeros((k, n + 1), dtype=torch.int32, device=dev)
    e_perm[bidx, torch.where(piv >= 0, piv, n).long()] = b
    corr = torch.zeros((k, n), dtype=torch.int32, device=dev)
    corr[bidx, order] = e_perm[:, :n]
    same = torch.equal(sol, hard ^ corr)
    log(f"OSD-0 solutions (K5) on {k} of {syn_f.shape[0]} {code} T={T} space-time BP failures "
        f"against the plain row elimination's: identical {same}")
    if not same:
        raise AssertionError("the [[288]] H_st OSD-0 solutions differ from the row elimination's")

    wrappers = {"st_bp": spacetime_bp_cuda.st_bp_cuda,
                "gf2_transform_elim": osd_transform_cuda.eliminate_transform_cuda,
                "gf2_elim": osd_cuda.eliminate_ordered_cuda,
                **{name: getattr(osd_factored_cuda, f"{name}_cuda") for name in K5_NAMES}}
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    res = eng.sweep(list(ST288_RATES), trials=ST288_TRIALS, seed=ST_SEED)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log(f"space-time sweep {code} T={T} BP({ST_ITERS})+OSD-0, {ST288_TRIALS} trials per rate, "
        f"batch {ST_BATCH}: wall {res.wall_time_s:.3f} s, {res.throughput:.1f} trials/s (first "
        f"use included), launches {json.dumps(launches)} on {card_line}")
    if launches["st_bp"] < 1 or any(launches[name] < 1 for name in K5_NAMES) or \
            launches["gf2_transform_elim"] or launches["gf2_elim"]:
        raise AssertionError("the [[288]] space-time sweep did not launch K6 and K5 alone")
    for p, d in zip(ST288_RATES, res.per_rate):
        log(f"  p={p}: LER {d['ler']:.5f}, OSD rate {d['osd']:.5f}, mean BP iterations "
            f"{d['average_iterations']:.3f}; {json.dumps(scalars(d))}")
        if d["trials"] != ST288_TRIALS or d["BPs_fault"] != round(d["osd"] * ST288_TRIALS):
            raise AssertionError("[[288]] space-time counters are inconsistent")

    jax_eng = st_engine(dev, ms, code=code, rounds=T, batch=JAX_ST288_BATCH)
    got = counters_to_dict(jax_eng.run_rate(JAX_ST288_P, JAX_ST288_TRIALS, seed=JAX_ST288_SEED))
    got = {**scalars(got), **hists(got)}
    differ = {k: (got[k], v) for k, v in JAX_ST288.items() if got[k] != v}
    log(f"space-time engine on the card vs the JAX engine's recorded counters, {code} T={T}, "
        f"BP({ST_ITERS}) min-sum + OSD-0, batch {JAX_ST288_BATCH}, p={JAX_ST288_P}, "
        f"{JAX_ST288_TRIALS} trials, seed {JAX_ST288_SEED}: identical {not differ} (ler "
        f"{got['ler']:.5f} against {JAX_ST288['ler']:.5f}, BP faults {got['BPs_fault']})")
    if differ:
        raise AssertionError(f"[[288]] space-time counters differ from the JAX engine's: {differ}")

    # K4g on H_st's BP failures, without the b-exit: H_st's rows are
    # independent, so no syndrome leaves its image and every lane walks to
    # rank(H), a call the decoder makes only on samples past the budget
    lanes = min(ST288_K4G_LANES, syn_f.shape[0])
    osd = eng.osd
    args = (order[:lanes], resid[:lanes], osd.Hc[:n], osd.h_rank, False)
    got = osd_transform_cuda.eliminate_transform_global_cuda(*args)
    ref = osd_transform_cuda.eliminate_transform_plain(*args)
    same = all(torch.equal(x, y) for x, y in zip(got, ref)) and \
        bool((got[2] == osd.h_rank).all())
    log(f"K4g on {lanes} {code} H_st T={T} BP failures without the b-exit: T, b, rank and piv "
        f"bit-identical to the plain version's, every lane at rank(H): {same}")
    if not same:
        raise AssertionError("K4g disagrees with its plain version on the [[288]] H_st lanes")

    t0 = time.perf_counter()
    osde = OSDDecoder(Hst_np, OSDConfig(order=PH_ORDER)).to(dev)
    built = time.perf_counter() - t0
    if osde.elimination != "factored+transform":
        raise AssertionError(f"OSD-e on H_st took {osde.elimination}, not the factored "
                             "elimination and K4g")
    stage_ms, _, sol = timed_call(lambda: osde(syn_f[:lanes], llrs_f[:lanes], hard[:lanes]))
    osd0 = transform_osd0(order[:lanes], ref[1], ref[3], hard[:lanes])
    worse = more_costly(sol, osd0, llrs_f[:lanes], hard[:lanes])
    log(f"OSD-e({PH_ORDER}) through the decoder (built in {built:.1f} s, route "
        f"{osde.elimination}) on the same {lanes} lanes: {stage_ms:.1f} ms; changed from the "
        f"transform's OSD-0: {int((sol.to(torch.int32) != osd0).any(dim=1).sum())}; costing "
        f"more: {int(worse.sum())}")
    if bool(worse.any()):
        raise AssertionError("an OSD-e solution on the [[288]] H_st lanes costs more than OSD-0's")


def synthetic_wide(m: int, n: int, dependent: int, seed: int) -> np.ndarray:
    """H's packed columns (n, ceil(m / 32)) int32 of the synthetic wide
    system of tests/test_torch_cuda.py's ``_rank_deficient_wide`` (the same
    draws from ``default_rng(seed)``), built packed: columns of weight 3-6
    on the first m - dependent rows, and row m - dependent + i the XOR of
    rows i and dependent + i. No dense m x n array (1.7 GB at 20,736 rows)."""
    rng = np.random.default_rng(seed)
    mw = -(-m // 32)
    rows = rng.integers(0, m - dependent, (n, 6))
    weight = rng.integers(3, 7, n)
    words = np.zeros((n, mw), np.uint32)
    for k in range(6):
        on = np.flatnonzero(weight > k)
        r = rows[on, k]
        np.bitwise_xor.at(words, (on, r // 32), (np.uint32(1) << (r % 32).astype(np.uint32)))
    bit = lambda r: (words[:, r // 32] >> np.uint32(r % 32)) & np.uint32(1)  # noqa: E731
    for i in range(dependent):
        r = m - dependent + i
        words[:, r // 32] |= (bit(i) ^ bit(dependent + i)) << np.uint32(r % 32)
    return words.view(np.int32)


def synthetic_lanes(Hc: np.ndarray, m: int, lanes: int, seed: int):
    """Lanes of the synthetic system (``synthetic_wide``) as the OSD decoder
    gives them to the transform elimination: errors at 0.002 a column, the
    even lanes with the last (dependent) row's syndrome bit flipped, so
    outside H's image; LLRs N(4, 2), hard decisions their signs. Returns
    (order (lanes, n) int64, resid (lanes, m) int32) as numpy."""
    rng = np.random.default_rng(seed)
    n = Hc.shape[0]
    words = Hc.view(np.uint32)
    e = rng.random((lanes, n)) < 0.002
    llrs = rng.normal(4.0, 2.0, (lanes, n)).astype(np.float32)
    hard = llrs < 0
    resid = np.zeros((lanes, m), np.int32)
    for s in range(lanes):
        # resid = H (e + hard): the syndrome's residual after the hard decision
        packed = np.bitwise_xor.reduce(words[np.flatnonzero(e[s] ^ hard[s])], axis=0)
        resid[s] = np.unpackbits(packed.view(np.uint8), bitorder="little")[:m]
    resid[::2, -1] ^= 1
    order = np.argsort(np.abs(llrs), axis=1, kind="stable")
    return order, resid


def phase_k4g_wide(dev, card_line: str) -> list:
    """K4g past the 9,312 rows whose per-block state a cluster of 16 holds
    in shared memory (its spilled layout: the panel's pairs, U and the
    leader's list in a global workspace, 32-bit slots), on synthetic wide
    systems (``synthetic_wide``) of WIDE_SIZES rows, WIDE_LANES lane(s) each
    (the even ones outside H's image, walking to rank(H); the b-exit on):
    T, b, rank and piv bit for bit against the plain version, its
    device ms and its bound from the work this input needs (``k4g_needs``).
    Returns a record per size."""
    from types import SimpleNamespace

    from qldpc_tpu_torch.ops import osd_transform_cuda as otc

    recs = []
    k4g = otc.eliminate_transform_global_cuda
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, n, dependent in WIDE_SIZES:
        t0 = time.perf_counter()
        Hc_np = synthetic_wide(m, n, dependent, m)
        order, resid = synthetic_lanes(Hc_np, m, WIDE_LANES, 5)
        Hc = torch.from_numpy(Hc_np).to(dev)
        order = torch.from_numpy(order).to(dev)
        resid = torch.from_numpy(resid).to(dev)
        h_rank = m - dependent
        built = time.perf_counter() - t0
        args = (order, resid, Hc, h_rank, True)
        ms, dev_ms, got = timed_call(lambda: k4g(*args))
        cleared = torch.zeros((), dtype=torch.int64, device=dev)
        plain_ms, _, ref = timed_call(lambda: otc.eliminate_transform_plain(*args,
                                                                           cleared=cleared))
        same = all(torch.equal(x, y) for x, y in zip(got, ref))
        C, t_smem, waves = otc.global_launch_shape(m, WIDE_LANES, sms,
                                                   otc.wide_clusters(dev, m))
        osd = SimpleNamespace(m=m, n=n, Hc=Hc, m_words=Hc.shape[1])
        T, b, rank, piv = got
        moved, ops, cols, no_pivot = k4g_needs(osd, order, piv, cleared,
                                               nbytes(resid, T, b, rank, piv))
        rec = dict(m=m, n=n, lanes=WIDE_LANES, device_ms=dev_ms, ms=ms, plain_ms=plain_ms,
                   cluster=C, spilled=otc.global_spills(m),
                   smem_bytes=otc.global_smem_bytes(m, C, t_smem),
                   workspace_bytes=4 * otc.global_workspace_words(m, WIDE_LANES, C),
                   **bound(moved, ops))
        full = bool((rank[::2] == h_rank).all())
        log(f"K4g at {m} rows ({m} x {n}, rank {h_rank}, {otc.t_bytes(m)} B of T a sample; "
            f"built in {built:.1f} s): {WIDE_LANES} lanes, cluster of {C} blocks, spilled "
            f"layout {rec['spilled']} ({rec['smem_bytes']} B of shared memory a block, "
            f"{rec['workspace_bytes']} B of workspace), {waves} wave(s); {ms:.2f} ms "
            f"({dev_ms:.2f} on the device), plain {plain_ms:.1f} ms; T, b, rank and piv "
            f"bit-identical: {same}; the outside lane at rank(H): {full}; columns walked "
            f"{[int(x) + 1 for x in piv.max(dim=1).values]}, {cols:.0f} in all, {int(cleared)} "
            f"rows cleared; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), K4g at "
            f"{100 * rec['bound_ms'] / dev_ms:.3f}% of it, on {card_line}")
        if not (same and full):
            raise AssertionError(f"K4g disagrees with its plain version at {m} rows")
        recs.append(rec)
        del Hc, order, resid, got, ref, T, b, rank, piv
        torch.cuda.empty_cache()
    return recs


def phase_rescue(dev, card_line: str) -> None:
    """rescue_iters on the card: the [[144]] code-capacity counters with
    rescue_iters = 10 equal those without it at the same seed; both timed."""
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
    from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine, counters_to_dict

    cfg = EngineConfig(bp=BPConfig(max_iter=50), osd=OSDConfig(order=0),
                       batch_size=ENGINE_BATCH)
    out = {}
    for rescue in (0, 10):
        eng = MonteCarloEngine(get_code(CODE), dataclasses.replace(cfg, rescue_iters=rescue),
                               device=dev)
        eng.run_rate(REF_P, ENGINE_BATCH, seed=9)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[rescue] = counters_to_dict(eng.run_rate(REF_P, 4 * ENGINE_BATCH, seed=9))
        torch.cuda.synchronize()
        log(f"{CODE} code capacity p={REF_P}, rescue_iters={rescue}: "
            f"{4 * ENGINE_BATCH / (time.perf_counter() - t0):.1f} trials/s on {card_line}")
    same = all(np.array_equal(out[0][k], out[10][k]) for k in out[0])
    log(f"rescue_iters=10 counters equal to a single BP(50) run's: {same} "
        f"(ler {out[10]['ler']:.5f}, BP faults {out[10]['BPs_fault']})")
    if not same:
        raise AssertionError("rescue_iters changed the counters")


def search_cost(sol, llrs, hard) -> torch.Tensor:
    """The OSD-e search's cost of each solution, in float64: the sum over
    the bits it flips from ``hard`` of |llr| * (1 - 2 * hard)."""
    hard = hard.to(torch.int32)
    w = llrs.double().abs() * (1.0 - 2.0 * hard.double())
    return ((sol.to(torch.int32) ^ hard).double() * w).sum(dim=1)


def more_costly(sol, osd0, llrs, hard) -> torch.Tensor:
    """Samples whose OSD-e solution costs more than the OSD-0 one (the zero
    pattern, which the search scores first), beyond float64 rounding."""
    c, c0 = search_cost(sol, llrs, hard), search_cost(osd0, llrs, hard)
    return (c - c0) > 1e-9 * c0.abs().clamp(min=1.0)


def hold_osde(label: str, got, ref, llrs, hard, max_ties: int = 0) -> None:
    """OSD-e solutions identical, save where the two choices cost the same
    within float32 rounding (relative 2^-20), at most ``max_ties`` of them."""
    differ = torch.nonzero((got.to(torch.int32) != ref.to(torch.int32)).any(dim=1)).flatten()
    cg = search_cost(got[differ], llrs[differ], hard[differ])
    cr = search_cost(ref[differ], llrs[differ], hard[differ])
    far = (cg - cr).abs() > 2.0**-20 * torch.maximum(cg.abs(), cr.abs())
    log(f"{label}: {len(got) - len(differ)} of {len(got)} identical, {len(differ)} differing "
        f"(near-ties), {int(far.sum())} beyond a near-tie")
    if bool(far.any()) or len(differ) > max_ties:
        raise AssertionError(f"{label}: the OSD-e solutions differ")


def phase_osde_rows(dev, card_line: str) -> dict:
    """OSD-e(7) on the rows path: [[144]] phenomenological BP(50) min-sum
    failures. K2's packed-rows loader on the inconsistent samples against
    its plain version (A, b, piv) and against the ordered loader's (b, piv);
    the card's OSD-e solutions against the CPU's; every cost at most OSD-0's;
    the search's and the OSD stage's ms and peak memory; then the engine's
    counters against the JAX engine's (K1, K2's two loaders launch)."""
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, OSDConfig, OSDDecoder
    from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine, counters_to_dict
    from qldpc_tpu_torch.ops import bp_cuda, osd_cuda
    from qldpc_tpu_torch.ops.osd_cuda import pack_permuted_rows
    from qldpc_tpu_torch.utils import rng

    def engine(batch):
        cfg = EngineConfig(bp=BPConfig(max_iter=50, method="min-sum"),
                           osd=OSDConfig(order=PH_ORDER), channel="phenomenological",
                           batch_size=batch)
        return MonteCarloEngine(get_code(PH_CODE), cfg, device=dev)

    eng = engine(PH_BATCH)
    osd = eng.osd
    _, syn, priors = eng._sample(rng.key(5), PH_P)
    res = eng.bp(syn, priors)
    fail = ~res.converged
    syn_f, llrs_f, hard_f = syn[fail], res.llrs[fail], res.hard[fail]
    resid = osd._residual(syn_f, hard_f.to(torch.int32))
    order = torch.argsort(llrs_f.abs(), dim=1, stable=True)
    b, piv = osd_cuda.eliminate_ordered_cuda(order, resid, osd.Hc, osd.h_rank)
    sel = torch.nonzero(((piv < 0) & (b != 0)).any(dim=1)).flatten()
    rows = pack_permuted_rows(order[sel], osd.Hc, osd.m)
    args = (rows, resid[sel], osd.n, osd.h_rank)
    ka, kb, kp = osd_cuda.eliminate_rows_cuda(*args)
    ra, rb, rp = osd_cuda.eliminate_rows_plain(*args)
    same = (torch.equal(ka, ra) and torch.equal(kb, rb) and torch.equal(kp, rp)
            and torch.equal(kb, b[sel]) and torch.equal(kp, piv[sel]))
    rows_ms = device_ms(lambda: osd_cuda.eliminate_rows_cuda(*args), reps=5)
    log(f"OSD-e({PH_ORDER}) rows path, {PH_CODE} phenomenological p={PH_P}, B={PH_BATCH}: "
        f"{len(syn_f)} BP failures, {len(sel)} inconsistent; K2's packed-rows loader on them "
        f"bit-identical to its plain version and to the ordered loader's (b, piv): {same}; "
        f"{rows_ms:.4f} ms on the device")
    if not same:
        raise AssertionError("K2's packed-rows loader disagrees on the OSD-e path")

    w = llrs_f[sel].abs() * (1.0 - 2.0 * hard_f[sel].to(llrs_f.dtype))
    search = (ka, kb, kp, order[sel], torch.gather(w, 1, order[sel]))
    search_ms = cuda_ms(lambda: osd._search(*search), reps=3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sol = osd(syn_f, llrs_f, hard_f)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    stage_ms = cuda_ms(lambda: osd(syn_f, llrs_f, hard_f), reps=3)
    log(f"  {osd.patterns.shape[0]} patterns over {osd.num_test} test columns, chunk "
        f"{osd.config.chunk}: the search {search_ms:.3f} ms, the OSD-e stage {stage_ms:.3f} ms on "
        f"{len(syn_f)} failures, peak {peak / 2**30:.3f} GiB above the inputs, on {card_line}")
    osd0 = OSDDecoder(get_code(PH_CODE).Hx, OSDConfig(order=0)).to(dev)(syn_f, llrs_f, hard_f)
    worse = more_costly(sol, osd0, llrs_f, hard_f)
    log(f"  solutions that OSD-e changed from OSD-0's: "
        f"{int((sol != osd0).any(dim=1).sum())}; costing more than OSD-0's: {int(worse.sum())}")
    if bool(worse.any()):
        raise AssertionError("an OSD-e solution costs more than the OSD-0 one")
    k = min(OSDE_CPU_LANES, len(syn_f))
    cpu = OSDDecoder(get_code(PH_CODE).Hx, OSDConfig(order=PH_ORDER))
    t0 = time.perf_counter()
    ref = cpu(syn_f[:k].cpu(), llrs_f[:k].cpu(), hard_f[:k].cpu())
    log(f"  the CPU's OSD-e on {k} of them: {time.perf_counter() - t0:.1f} s")
    hold_osde("  card OSD-e against the CPU's", sol[:k].cpu(), ref, llrs_f[:k].cpu(),
              hard_f[:k].cpu())

    eng = engine(JAX_PH_OSDE7_TRIALS)
    wrappers = {"bp_flooding": bp_cuda.bp_flooding_cuda,
                "gf2_elim": osd_cuda.eliminate_ordered_cuda,
                "gf2_elim_rows": osd_cuda.eliminate_rows_cuda}
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    got = counters_to_dict(eng.run_rate(PH_P, JAX_PH_OSDE7_TRIALS, seed=JAX_PH_OSDE7_SEED))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    got = {**scalars(got), **hists(got)}
    differ = {k: (got[k], v) for k, v in JAX_PH_OSDE7.items() if got[k] != v}
    log(f"phenomenological engine, OSD-e({PH_ORDER}), on the card vs the JAX engine, {PH_CODE} "
        f"p={PH_P}, {JAX_PH_OSDE7_TRIALS} trials: identical {not differ} (ler "
        f"{got['ler']:.5f}, BP faults {got['BPs_fault']}); launches {json.dumps(launches)}")
    if differ:
        raise AssertionError(f"the OSD-e counters differ from the JAX engine's: {differ}")
    if any(v < 1 for v in launches.values()):
        raise AssertionError("the OSD-e engine did not launch K1 and both K2 loaders")
    return dict(launches=launches["gf2_elim_rows"], device_ms=rows_ms, systems=len(sel))


def phase_osde_transform(dev) -> dict:
    """OSD-e(7) on the transform path: the [[72]] DEM's BP failures at
    p = 0.002 with one detector flipped each. K4 (b-exit on) against its
    plain version on 128 of the inconsistent lanes (T, b, rank, piv), and
    every inconsistent lane at rank(H) (it never b-exits, so its T is the
    full-rank transform the search reads); the card's OSD-e solutions
    against the CPU's on 16; costs at most OSD-0's."""
    from qldpc_tpu_torch.decoders import OSDConfig, OSDDecoder
    from qldpc_tpu_torch.ops import osd_transform_cuda
    from qldpc_tpu_torch.ops.osd_transform_cuda import eliminate_transform_plain

    eng = dem_engine(dev)
    syn, llrs, hard = dem_failures(eng, 0.002, seed=7)
    g = torch.Generator().manual_seed(7)
    flip = torch.randint(0, syn.shape[1], (syn.shape[0],), generator=g).to(dev)
    syn = syn.clone()
    syn[torch.arange(len(syn), device=dev), flip] ^= 1
    osd = OSDDecoder(eng.dem.H, OSDConfig(order=PH_ORDER)).to(dev)
    resid = osd._residual(syn, hard.to(torch.int32))
    order = torch.argsort(llrs.abs(), dim=1, stable=True)
    k4 = osd_transform_cuda.eliminate_transform_cuda
    T, b, rank, piv = k4(order, resid, osd.Hc, osd.h_rank, b_exit=True)
    sel = torch.nonzero(((piv < 0) & (b != 0)).any(dim=1)).flatten()
    held = sel[:K4_NO_EXIT_LANES]
    pT, pb, prank, ppiv = eliminate_transform_plain(order[held], resid[held], osd.Hc,
                                                    osd.h_rank, b_exit=True)
    same = (torch.equal(T[held], pT) and torch.equal(b[held], pb)
            and torch.equal(rank[held], prank) and torch.equal(piv[held], ppiv))
    full = bool((rank[sel] == osd.h_rank).all())
    log(f"OSD-e({PH_ORDER}) transform path, {eng.code.name} ({osd.m} x {osd.n}, rank "
        f"{osd.h_rank}), p=0.002: {len(syn)} BP failures with a detector flipped, {len(sel)} "
        f"inconsistent; K4's T, b, rank and piv on {len(held)} of them bit-identical to the "
        f"plain version's (b-exit on): {same}; every inconsistent lane at rank(H): {full}")
    if not (same and full):
        raise AssertionError("K4 disagrees on the OSD-e path, or an inconsistent lane b-exited")
    torch.cuda.synchronize()
    k4.launches = 0
    t0 = time.perf_counter()
    sol = osd(syn, llrs, hard)
    torch.cuda.synchronize()
    launches = k4.launches
    log(f"  the OSD-e stage on the card: {(time.perf_counter() - t0) * 1e3:.1f} ms "
        f"(first call), K4 launched {launches} times")
    osd0 = eng.osd(syn, llrs, hard)
    worse = more_costly(sol, osd0, llrs, hard)
    log(f"  changed from OSD-0's: {int((sol != osd0).any(dim=1).sum())}; costing more: "
        f"{int(worse.sum())}")
    if bool(worse.any()) or launches < 1:
        raise AssertionError("an OSD-e solution costs more than OSD-0's, or K4 never launched")
    lanes = sel[:OSDE_DEM_CPU_LANES]
    cpu = OSDDecoder(eng.dem.H, OSDConfig(order=PH_ORDER))
    t0 = time.perf_counter()
    ref = cpu(syn[lanes].cpu(), llrs[lanes].cpu(), hard[lanes].cpu())
    log(f"  the CPU's OSD-e on {len(lanes)} inconsistent lanes: {time.perf_counter() - t0:.1f} s")
    hold_osde("  card OSD-e against the CPU's", sol[lanes].cpu(), ref, llrs[lanes].cpu(),
              hard[lanes].cpu())
    return dict(launches=launches, systems=len(sel))


def left_null_space(H: np.ndarray) -> np.ndarray:
    """A basis (d, m) 0/1 of the dependencies of H's rows, {y : y H = 0}:
    H's rows packed 64 columns a word beside the identity and eliminated as
    ``decoders.osd.gf2_rank`` does; a row whose H part clears carries a
    dependency in its identity part."""
    H = np.asarray(H)
    m, n = H.shape
    hw, iw = -(-n // 64), -(-m // 64)
    R = np.zeros((m, (hw + iw) * 8), np.uint8)
    R[:, : -(-n // 8)] = np.packbits(H & 1, axis=1, bitorder="little")
    eye = np.zeros((m, iw * 64), np.uint8)
    eye[np.arange(m), np.arange(m)] = 1
    R[:, hw * 8:] = np.packbits(eye, axis=1, bitorder="little")
    R = R.view("<u8")
    dependent = []
    for i in range(m):
        nz = np.flatnonzero(R[i, :hw])
        if not nz.size:
            dependent.append(i)
            continue
        w = nz[0]
        word = int(R[i, w])
        bit = np.uint64((word & -word).bit_length() - 1)  # the row's lowest set bit
        below = i + 1 + np.flatnonzero((R[i + 1:, w] >> bit) & np.uint64(1))
        R[below, w:] ^= R[i, w:]
    return np.unpackbits(R[dependent, hw:].view(np.uint8), axis=1, bitorder="little")[:, :m]


def out_of_image(eng, p: float, seed: int, lanes: int):
    """The first ``lanes`` BP failures of one batch of the DEM engine at p,
    each with one detector flipped that a dependency of H's rows involves,
    so that every syndrome leaves H's image (a BP failure's syndrome is in
    it) and OSD-e searches every lane; and whether each one is outside by
    the dependencies' parities (syndromes, LLRs, hard decisions, outside)."""
    syn, llrs, hard = (x[:lanes] for x in dem_failures(eng, p, seed))
    Y = left_null_space(eng.dem.H)
    support = np.flatnonzero(Y.any(axis=0))
    flip = np.random.default_rng(seed).choice(support, size=len(syn))
    dev = syn.device
    syn = syn.clone()
    syn[torch.arange(len(syn), device=dev), torch.from_numpy(flip).to(dev)] ^= 1
    Yt = torch.from_numpy(Y.astype(np.float32)).to(dev)
    outside = torch.remainder(syn.float() @ Yt.T, 2.0).any(dim=1)
    log(f"  H has {Y.shape[0]} dependencies, over {len(support)} of its {Y.shape[1]} rows")
    return syn, llrs, hard, outside


def timed_call(fn):
    """Host ms (to a synchronize) and device ms (CUDA events) of one call of
    ``fn``, long enough that its launch work does not matter, and its result."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, ev[0].elapsed_time(ev[1]), out


def phase_osde_wide(eng, card_line: str, p: float, lanes: int, cpu_lanes: int = 0):
    """OSD-e(7) past K4's block (the route "factored+transform") on ``lanes``
    BP failures of the DEM engine at p whose syndromes leave H's image
    (``k4g_osde``). The engine's OSD decoder serves where it is OSD-e(7)'s."""
    syn, llrs, hard, outside = out_of_image(eng, p, 7, lanes)
    osd = eng.osd if eng.osd.config.order == PH_ORDER else None
    return k4g_osde(eng.code.name, eng.dem.H, osd, syn, llrs, hard, outside, card_line,
                    cpu_lanes)


def k4g_needs(osd, order, piv, cleared, moved_extra: int):
    """The work the transform elimination needs on these lanes: each lane's
    order entries and packed columns up to its last pivot read once, and
    ``moved_extra`` bytes (the residuals and the outputs); per column up to
    the last pivot, an AND and a XOR for each word the column is nonzero in
    on every row in a panel with a pivot, on the rows at or below the rank
    in a panel without one (K4g's pivot-first panels: no other row can
    change); per row a pivot clears (the plain run's count), a XOR per word
    of T. Returns (bytes, operations, columns, panels without a pivot)."""
    B, n = order.shape
    dev = order.device
    last = piv.max(dim=1).values.to(torch.int64)
    cols = torch.arange(n, device=dev)
    within = cols < (last + 1)[:, None]
    panels = -(-n // 32)
    pivots = torch.zeros((B, panels + 1), dtype=torch.int64, device=dev)
    pc = torch.where(piv >= 0, piv.long() // 32, panels)
    pivots.scatter_add_(1, pc, torch.ones_like(pc))
    pivots = pivots[:, :panels]
    rank0 = torch.cumsum(pivots, dim=1) - pivots  # the rank at each panel's start
    rows = torch.where(pivots > 0, osd.m, osd.m - rank0)  # (B, panels)
    nz_words = (osd.Hc[:osd.n] != 0).sum(dim=1)
    per_col = nz_words[order] * rows.gather(1, (cols // 32).expand(B, n)) * within
    tested = float(per_col.sum())
    walked = (cols[::32] < (last + 1)[:, None])
    no_pivot = int(((pivots == 0) & walked).sum())
    moved = float(within.sum()) * 4 * (1 + osd.m_words) + moved_extra
    ops = 2 * tested + osd.m_words * float(cleared)
    return moved, ops, float(within.sum()), no_pivot


def k4g_osde(label: str, H, osd, syn, llrs, hard, outside, card_line: str, cpu_lanes: int = 0):
    """K4g and OSD-e(7) past K4's block on lanes of H: K4g against its plain
    version (T, b, rank and piv bit for bit), both timed once, with the
    b-exit as the decoder calls it (``outside``: which lanes left H's image;
    those must reach rank(H) and be inconsistent); the OSD-e stage through
    the decoder (K5a-d, K4g where a lane is inconsistent or past the column
    budget, the search) with its ms, K4g's launches and peak memory; no cost
    above the lanes path's OSD-0 (the transform's, the search's zero
    pattern). ``osd`` is H's OSD-e(7) decoder, built here if None. With
    ``cpu_lanes``, after the card's timings, the CPU decoder's OSD-e(7) on
    that many lanes, to which the card's solutions are held. Returns K4g's
    record; its bound counts the work this input needs (``k4g_needs``)."""
    from qldpc_tpu_torch.decoders import OSDConfig, OSDDecoder
    from qldpc_tpu_torch.ops import osd_transform_cuda as otc

    dev = syn.device
    t0 = time.perf_counter()
    built = osd is None
    if built:
        osd = OSDDecoder(H, OSDConfig(order=PH_ORDER)).to(dev)
    log(f"OSD-e({PH_ORDER}) past K4's block, {label} ({osd.m} x {osd.n}, rank "
        f"{osd.h_rank}, {otc.t_bytes(osd.m)} B of T a sample): the decoder "
        f"{'built' if built else 'of the engine'} ({time.perf_counter() - t0:.1f}"
        f" s), route {osd.elimination}")
    if osd.elimination != "factored+transform":
        raise AssertionError(f"OSD-e took {osd.elimination}, not the factored elimination and K4g")
    hard = hard.to(torch.int32)
    resid = osd._residual(syn, hard)
    order = torch.argsort(llrs.abs(), dim=1, stable=True)
    k4g = otc.eliminate_transform_global_cuda
    args = (order, resid, osd.Hc[:osd.n], osd.h_rank, True)
    ms, dev_ms, (T, b, rank, piv) = timed_call(lambda: k4g(*args))
    cleared = torch.zeros((), dtype=torch.int64, device=dev)
    plain_ms, _, ref = timed_call(lambda: otc.eliminate_transform_plain(*args, cleared=cleared))
    same = all(torch.equal(x, y) for x, y in zip((T, b, rank, piv), ref))
    searched = ((piv < 0) & (b != 0)).any(dim=1)
    full = bool((rank == osd.h_rank).all())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    C, t_smem, waves = otc.global_launch_shape(osd.m, len(syn), sms,
                                               otc.wide_clusters(dev, osd.m))
    last = piv.max(dim=1).values.to(torch.int64)
    moved, ops, cols, no_pivot = k4g_needs(osd, order, piv, cleared, nbytes(resid, T, b, rank, piv))
    log(f"  K4g on {len(syn)} BP failures (a detector flipped each, all outside H's image: "
        f"{bool(outside.all())}; all inconsistent: {bool(searched.all())}): "
        f"T, b, rank and piv bit-identical to the plain version's (b-exit on): {same}; "
        f"every lane at rank(H): "
        f"{full}; last pivot column {last.float().mean().item():.0f} mean, {int(last.max())} "
        f"max, past the factored column budget ({osd.max_cols}) on "
        f"{int((last >= osd.max_cols).sum())} lanes; panels without a pivot {no_pivot} of "
        f"{int(-(-(last + 1) // 32).sum())}; a cluster of {C} block(s) of "
        f"{otc._GLOBAL_THREADS} threads a sample, T in {'shared' if t_smem else 'global'} "
        f"memory ({otc.global_smem_bytes(osd.m, C, t_smem)} B of shared memory a block), "
        f"{waves} wave(s); K4g {ms:.2f} ms ({dev_ms:.2f} on the device), plain {plain_ms:.1f} "
        f"ms, on {card_line}")
    if not (same and full and bool(searched.all() and outside.all())):
        raise AssertionError("K4g disagrees with its plain version, or a lane left H's image "
                             "without reaching rank(H)")

    torch.cuda.synchronize()
    k4g.launches = 0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stage_ms, stage_dev_ms, sol = timed_call(lambda: osd(syn, llrs, hard))
    peak = torch.cuda.max_memory_allocated() - base
    launches = k4g.launches
    osd0 = transform_osd0(order, b, piv, hard)
    worse = more_costly(sol, osd0, llrs, hard)
    log(f"  the OSD-e stage on them: {stage_ms:.1f} ms ({stage_dev_ms:.1f} between device "
        f"events), K4g launched {launches} time(s), peak {peak / 2**30:.3f} GiB above the "
        f"inputs; changed from OSD-0's: {int((sol != osd0).any(dim=1).sum())}; costing more: "
        f"{int(worse.sum())}")
    if bool(worse.any()) or launches < 1:
        raise AssertionError("an OSD-e solution costs more than OSD-0's, or K4g never launched")
    if cpu_lanes:
        t0 = time.perf_counter()
        cpu = OSDDecoder(H, OSDConfig(order=PH_ORDER))
        cpu_in = [x[:cpu_lanes].cpu() for x in (syn, llrs, hard)]
        cpu_sol = cpu(*cpu_in)
        log(f"  the CPU's OSD-e on {cpu_lanes} of them, after the card's timings: "
            f"{time.perf_counter() - t0:.1f} s on {torch.get_num_threads()} threads (the "
            f"decoder's build included)")
        hold_osde("  card OSD-e against the CPU's", sol[:cpu_lanes].cpu(), cpu_sol, *cpu_in[1:])
    log(f"  the work this input needs: {cols:.0f} columns, {int(cleared)} rows cleared by "
        f"pivots; {moved / 1e9:.3f} GB, {ops / 1e9:.3f} G operations; K4g at "
        f"{100 * bound(moved, ops)['bound_ms'] / dev_ms:.2f}% of its bound")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, max_abs_err=0.0, lanes=len(syn),
                osde_launches=launches, stage_ms=stage_ms, cluster=C, t_smem=t_smem,
                no_pivot_panels=no_pivot, **bound(moved, ops))


def transform_osd0(order, b, piv, hard) -> torch.Tensor:
    """OSD-0 from the transform elimination's (b, piv_col) in permuted
    columns, ``e[piv_col[r]] = b[r]`` un-permuted into ``hard``: the JAX
    lanes path's, and the OSD-e search's zero pattern."""
    B, n = hard.shape
    rows = torch.arange(B, device=hard.device)[:, None]
    e = torch.zeros((B, n + 1), dtype=torch.int32, device=hard.device)
    e[rows, torch.where(piv >= 0, piv, n).long()] = b
    corr = torch.zeros_like(hard)
    corr[rows, order] = e[:, :n]
    return hard ^ corr


def phase_cli_osde(dev, card_line: str, out_dir: str) -> None:
    """complete-bposd on the [[144]] DEM, one batch of 1,024 at p = 0.002,
    with ``--set osd_order=7`` and with ``osd_order=0`` at the same seed: its
    syndromes are in H's image, so OSD-e is OSD-0 and the counters are
    equal; K5a-d launch, and K4g only on samples past the factored column
    budget, as often under both orders. The OSD stage's ms under both."""
    from qldpc_tpu_torch.experiments.cli import main as cli_main
    from qldpc_tpu_torch.experiments.results_io import load_results
    from qldpc_tpu_torch.ops import osd_factored_cuda, osd_transform_cuda

    wrappers = {"gf2_transform_elim_global": osd_transform_cuda.eliminate_transform_global_cuda,
                "factored_y": osd_factored_cuda.factored_y_cuda}
    res, k4g_launches = {}, {}
    for order in (PH_ORDER, 0):
        patch, engines, _ = capture_engines()
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with patch:
            code = cli_main(["run", "complete-bposd", "--codes", DEM144_CODE, "--error-rates",
                             str(OSDE_WIDE_P), "--trials", str(DEM_BATCH), "--set",
                             f"osd_order={order}", "--out", f"{out_dir}/o{order}",
                             "--no-checkpoint", "--quiet"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items()}
        if code != 0:
            raise AssertionError(f"the CLI exited {code}")
        eng = engines[0]
        res[order] = load_results(f"{out_dir}/o{order}/complete-bposd.npz")[DEM144_CODE][OSDE_WIDE_P]
        log(f"CLI complete-bposd {DEM144_CODE} DEM, osd_order={order}, one batch of {DEM_BATCH} at "
            f"p={OSDE_WIDE_P}: {wall:.1f} s (the DEM build included), route "
            f"{eng.osd.elimination}, launches {json.dumps(launches)}, on {card_line}")
        if launches["factored_y"] < 1:
            raise AssertionError("the CLI's OSD did not take K5 on in-image syndromes")
        k4g_launches[order] = launches["gf2_transform_elim_global"]
        del engines[:], eng
    if k4g_launches[PH_ORDER] != k4g_launches[0]:
        raise AssertionError(f"K4g launched {k4g_launches} times by order on in-image syndromes")
    differ = [k for k in res[0] if not np.array_equal(np.asarray(res[PH_ORDER][k]),
                                                      np.asarray(res[0][k]))]
    log(f"  osd_order={PH_ORDER} counters identical to osd_order=0's: {not differ} "
        f"({json.dumps(scalars(res[0]))})")
    if differ:
        raise AssertionError(f"OSD-e's counters differ from OSD-0's on in-image syndromes: {differ}")


def phase_alpha(dev, card_line: str) -> None:
    """Alvarado's alpha, min-sum, on the card: equal to the CPU's and to the
    JAX package's recorded value."""
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders.alvarado import estimate_alpha

    H = get_code(ALPHA_CODE).Hx
    t0 = time.perf_counter()
    card_alpha = estimate_alpha(H, ALPHA_P, seed=ALPHA_SEED, device=dev)
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_alpha = estimate_alpha(H, ALPHA_P, seed=ALPHA_SEED, device="cpu")
    log(f"estimate_alpha min-sum {ALPHA_CODE} p={ALPHA_P} seed {ALPHA_SEED}: card {card_alpha!r} "
        f"({secs:.2f} s, first use included, on {card_line}), CPU {cpu_alpha!r} "
        f"({time.perf_counter() - t0:.2f} s), JAX {JAX_ALPHA!r}")
    if not card_alpha == cpu_alpha == JAX_ALPHA:
        raise AssertionError("the card's alpha differs from the CPU's or the JAX package's")


def mesh_checked(label: str, cases: list, reference: list, ranks: list,
                 card_line: str) -> None:
    """Log each case's identity, trials/s at 1 and N ranks and each rank's
    launches; raise unless every counter equals the reference and every rank
    launched its kernels."""
    from qldpc_tpu_torch.parallel import smoke

    rows = smoke.compare(reference, ranks)
    for row in rows:
        log(f"{label} {row['name']}: identical to one process {row['identical']}; "
            f"{row['trials']} trials in {row['seconds_1']:.3f} s alone = "
            f"{row['trials_per_s_1']:.1f} trials/s, {row['seconds_n']:.3f} s on {len(ranks)} "
            f"ranks = {row['trials_per_s_n']:.1f} trials/s; launches alone "
            f"{json.dumps(row['launches_1'])}, per rank {json.dumps(row['launches_n'])} "
            f"on {card_line}")
        if not row["identical"]:
            raise AssertionError(f"{label} {row['name']}: the counters differ from one process's")
        for r, launched in enumerate(row["launches_n"]):
            missing = [k for k in MESH_KERNELS[row["name"]] if not launched.get(k)]
            if missing:
                raise AssertionError(f"{label} {row['name']}: rank {r} never launched {missing}")


def phase_mesh(dev, card_line: str) -> None:
    """Phase 29: parallel.smoke's workers on the card at full width against
    this process alone (the single-process runs of the same cases)."""
    from qldpc_tpu_torch.parallel import Mesh, smoke

    alone = lambda cases: smoke.run_cases(cases, dev, meshes=lambda r: Mesh())
    module = "qldpc_tpu_torch.parallel.smoke"
    two = smoke.launch(2, dict(cases=MESH_CASES, device="cuda:0"), MESH_TIMEOUT, module=module)
    mesh_checked("2 ranks on cuda:0,", MESH_CASES, alone(MESH_CASES), two, card_line)
    rate = [MESH_RATE_CASE]
    four = smoke.launch(4, dict(cases=rate, device="cuda:0"), MESH_TIMEOUT, module=module)
    mesh_checked("4 ranks (rate 2, mc 2) on cuda:0,", rate, alone(rate), four, card_line)
    cards = torch.cuda.device_count()
    if cards >= 2:
        many = smoke.launch(cards, dict(cases=MESH_CASES, device="cuda"), MESH_TIMEOUT,
                            module=module)
        mesh_checked(f"{cards} ranks a card each,", MESH_CASES, alone(MESH_CASES), many,
                     card_line)
    else:
        log("one card: no run with a rank a card")


def phase_mesh_cli(dev, card_line: str, out_dir: str) -> None:
    """Phase 30: the CLI under torchrun, 2 ranks on this host's cards,
    against the same arguments in this process."""
    from qldpc_tpu_torch.experiments.cli import main as cli_main
    from qldpc_tpu_torch.experiments.results_io import load_results

    root = Path(__file__).resolve().parent
    two, one = Path(out_dir, "two"), Path(out_dir, "one")
    env = dict(os.environ, PYTHONPATH=str(root))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank is on this host
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "qldpc_tpu_torch.experiments.cli", *MESH_CLI_ARGS, "--out", str(two)],
        capture_output=True, text=True, cwd=root, env=env, timeout=MESH_TIMEOUT)
    wall = time.perf_counter() - t0
    log(f"torchrun CLI ({' '.join(MESH_CLI_ARGS)}), 2 ranks: exit {proc.returncode}, {wall:.1f} s "
        f"(start-up included) on {card_line}")
    if proc.returncode != 0:
        raise AssertionError(f"the torchrun CLI failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    for line in proc.stdout.splitlines():
        if line.startswith("[study]"):
            log(f"  {line}")
    if cli_main([*MESH_CLI_ARGS, "--out", str(one), "--quiet"]):
        raise AssertionError("the one-process CLI failed")
    a, b = load_results(two / "study.npz"), load_results(one / "study.npz")
    same = all(np.array_equal(np.asarray(a[CODE][p][k]), np.asarray(b[CODE][p][k]))
               for p in b[CODE] for k in b[CODE][p])
    files = lambda d: sorted(str(f.relative_to(d)) for f in d.rglob("*"))
    printed = proc.stdout.count(f"[study] {CODE} p=0.03:")
    log(f"torchrun CLI npz equal to one process's {same}; same files {files(two) == files(one)} "
        f"({len(files(one))}); per-rate lines printed {printed} time(s)")
    if not same or files(two) != files(one) or printed != 1:
        raise AssertionError("the torchrun CLI's results, files or output differ")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from qldpc_tpu_torch.codes import get_code  # the repo must be beside the script
    from qldpc_tpu_torch.ops import dem_bp_cuda, osd_factored_cuda, osd_transform_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card_line = card()
    H = get_code(CODE).Hx

    def timed(fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        log(f"[{fn.__name__} took {time.perf_counter() - t0:.1f} s]")
        return out

    timed(phase_toolchain, card_line)
    timed(phase_build)
    k8 = timed(phase_k8, card_line)
    k1_err, failures = timed(phase_k1, H, dev)
    k2 = timed(phase_k2, H, dev, failures)
    launches = timed(phase_engine, dev, card_line)
    timed(phase_engine_vs_cpu, dev)
    k1 = timed(phase_throughput, H, dev, card_line)
    with tempfile.TemporaryDirectory() as tmp:
        k1_bf16, k1_bf16_launches = timed(phase_k1_bf16, H, dev, card_line, tmp)

    eng = timed(dem_engine, dev)
    k3_72, dem_failures = timed(phase_k3, eng, dev)
    k4 = timed(phase_k4, eng, dem_failures)
    k3_wrapper = dem_bp_cuda.dem_bp_cuda
    k4_wrapper = osd_transform_cuda.eliminate_transform_cuda
    dem_launches = timed(phase_dem_engine, eng, card_line, DEM_REF,
                         {"dem_bp": k3_wrapper, "gf2_transform_elim": k4_wrapper}, {})
    for backend in ("auto", "factored"):
        timed(phase_dem_engine_vs_cpu, dev, DEM_CPU_TRIALS, backend=backend)
    timed(phase_dem_throughput, eng, card_line)
    del eng
    torch.cuda.empty_cache()

    eng144 = timed(dem_engine, dev, code=DEM144_CODE, rounds=DEM144_ROUNDS)
    log(f"{eng144.code.name}: {eng144.m_checks} x {eng144.n_vars}, rank {eng144.osd.h_rank}, "
        f"elimination {eng144.osd.elimination}, column budget {eng144.osd.max_cols}")
    k3, failures144 = timed(phase_k3, eng144, dev, rates=(0.002,), methods=("sum-product",))
    k3["max_abs_err"] = max(k3["max_abs_err"], k3_72["max_abs_err"])
    k5 = timed(phase_k5, eng144, failures144)
    k9 = timed(phase_k9, dev, card_line, eng144)
    k5_wrappers = {name: getattr(osd_factored_cuda, f"{name}_cuda") for name in K5_NAMES}
    dem144_launches = timed(phase_dem_engine, eng144, card_line, DEM144_REF,
                            {"dem_bp": k3_wrapper, **k5_wrappers},
                            {"gf2_transform_elim": k4_wrapper})
    timed(phase_dem_engine_vs_cpu, dev, DEM144_CPU_TRIALS, code=DEM144_CODE,
          rounds=DEM144_ROUNDS)
    k3_bf16 = timed(phase_k3_bf16, eng144, dev, card_line)
    k4g = timed(phase_osde_wide, eng144, card_line, OSDE_WIDE_P, OSDE_WIDE_LANES,
                OSDE_WIDE_CPU_LANES)
    del eng144
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        timed(phase_cli_osde, dev, card_line, tmp)

    k6, st_failures = timed(phase_k6, dev)
    k4["h_st"] = timed(phase_st_osd, dev, st_failures)
    st_launches = timed(phase_st_engine, dev, card_line)
    timed(phase_st_engine_checks, dev)

    k7 = timed(phase_k7, H, dev)
    layered_launches = timed(phase_layered_engine, dev, card_line)

    with tempfile.TemporaryDirectory() as tmp:
        cli_launches = timed(phase_cli_dems, dev, card_line, f"{tmp}/cli")
        timed(phase_checkpoints, dev, tmp)
        k5_288, k4g["osd0_288"], eng288 = timed(phase_dem288, dev, card_line,
                                                f"{tmp}/dem288")
    k4g["at_288"] = timed(phase_osde_wide, eng288, card_line, DEM288_P, OSDE_288_LANES)
    del eng288
    gc.collect()
    torch.cuda.empty_cache()
    k4g["past_9312"] = timed(phase_k4g_wide, dev, card_line)
    timed(phase_st288, dev, card_line)
    timed(phase_rescue, dev, card_line)
    k2["osde_rows"] = timed(phase_osde_rows, dev, card_line)
    k4["osde"] = timed(phase_osde_transform, dev)
    timed(phase_alpha, dev, card_line)
    torch.cuda.empty_cache()
    timed(phase_mesh, dev, card_line)
    with tempfile.TemporaryDirectory() as tmp:
        timed(phase_mesh_cli, dev, card_line, tmp)
    for name in K5_NAMES:
        k5[name]["at_288"] = k5_288[name]

    k1.update(max_abs_err=k1_err)
    rows = [
        ("bp_flooding", "bp_flooding.cu", "qldpc_tpu/ops/bp_pallas.py:256",
         launches["bp_flooding"], k1),
        ("gf2_elim", "gf2_elim.cu", "qldpc_tpu/ops/osd_pallas.py:36",
         launches["gf2_elim"], k2),
        ("dem_bp", "dem_bp.cu", "qldpc_tpu/ops/dem_bp_pallas.py:78",
         dem144_launches["dem_bp"], k3),
        ("gf2_transform_elim", "gf2_transform_elim.cu",
         "qldpc_tpu/ops/osd_transform_pallas.py:37",
         dem_launches["gf2_transform_elim"], k4),
        ("factored_y", "gf2_factored.cu", "qldpc_tpu/ops/osd_factored.py:84",
         dem144_launches["factored_y"], k5["factored_y"]),
        ("factored_w", "gf2_factored.cu", "qldpc_tpu/ops/osd_factored.py:111",
         dem144_launches["factored_w"], k5["factored_w"]),
        ("factored_panel_elim", "gf2_factored.cu", "qldpc_tpu/ops/osd_factored.py:183",
         dem144_launches["factored_panel_elim"], k5["factored_panel_elim"]),
        ("factored_resolve", "gf2_factored.cu", "qldpc_tpu/ops/osd_factored.py:308",
         dem144_launches["factored_resolve"], k5["factored_resolve"]),
        ("st_bp", "spacetime_bp.cu", "qldpc_tpu/ops/spacetime_bp_pallas.py:42",
         st_launches["st_bp"], k6),
        ("bp_layered", "bp_layered.cu", "qldpc_tpu/ops/bp_pallas.py:123",
         layered_launches["bp_layered"], k7),
        ("bp_flooding_bf16", "bp_flooding.cu", "qldpc_tpu/ops/bp_pallas.py:256",
         k1_bf16_launches, k1_bf16),
        ("dem_bp_bf16", "dem_bp.cu", "qldpc_tpu/ops/dem_bp_pallas.py:78",
         cli_launches["dem_bp_bf16"], k3_bf16),
        # K4g computes an XLA function of the JAX package, not a Pallas kernel;
        # its path: OSD-0 at the [[288]] DEM, the samples past the budget
        ("gf2_transform_elim_global", "gf2_transform_elim_global.cu",
         "qldpc_tpu/decoders/osd.py:492", k4g["osd0_288"]["run_launches"], k4g),
        # K8 replaces no Pallas kernel: the JAX counter stream is XLA code;
        # its launches: phase 5's sweep, one a batch
        ("threefry_uniform", "threefry_uniform.cu", "none (qldpc_tpu/utils/rng.py:48, XLA)",
         launches["threefry_uniform"], k8),
        # K9 replaces no Pallas kernel: the JAX classification is XLA code;
        # its launches: phase 5's sweep, one a batch
        ("classify", "classify.cu", "none (qldpc_tpu/mc/engine.py _classify, XLA)",
         launches["classify"], k9),
    ]
    # K1 where samples iterate, K2's packed-rows entry and its launches on
    # the OSD-e path, K4 on the space-time failures and on the OSD-e path, K5
    # at the [[288]] DEM; beside the bf16 instances the float32 instance's
    # device ms in turns and K3's bf16 message path's
    extra = ("at_p_0_050119", "rows", "osde_rows", "h_st", "osde", "at_288",
             "f32_device_ms", "message_device_ms", "lanes", "stage_ms", "cluster", "t_smem",
             "no_pivot_panels", "osde_launches", "osd0_288", "past_9312", "shape",
             "code_capacity", "space_time", "dem")
    kernels = [
        dict(name=name, route="cuda", source=f"qldpc_tpu_torch/ops/csrc/{src}",
             replaces=replaces, launches=count, max_abs_err=rec["max_abs_err"],
             ms=rec["ms"], device_ms=rec["device_ms"], plain_ms=rec["plain_ms"],
             bound_ms=rec["bound_ms"],
             bound_by=rec["bound_by"], library_ms=rec.get("library_ms"),
             **{k: rec[k] for k in extra if k in rec})
        for name, src, replaces, count, rec in rows
    ]
    log(card_line)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
