"""Whether the timed path decoded correctly: its outputs on the checked
batches against the plain reference, layer by layer.

The reference builds the configuration's decoding problem at p from its
channel's file, ``reference/channels/<channel>.py`` (the code from its
polynomials; for a circuit-level configuration the DEM and its priors, for
a space-time one H_st), draws the errors from the seed, and follows the
program stage by stage: each stage of the reference takes the program's
outputs of the stage before, which the comparison before it has judged.

  sample_bits_differ    error bits the program drew that the seed's
                        stream does not give, plus syndrome bits that are
                        not the parity of the program's errors. A DEM
                        draw within 2^-22 of its prior may fall either
                        way, as float32 priors round.
  bp_lanes_differ       share of samples whose convergence, iteration
                        count or hard decision differs from plain float32
                        BP on the program's syndromes.
  bp_llr_gap            largest |program - reference| / (1 + |reference|)
                        of a posterior, over the samples that agree.
  osd_lanes_differ      samples whose final correction is not plain OSD-0
                        of the program's BP output (or BP's hard decision
                        where BP converged).
  counter_fields_differ counter fields and histogram bins of a batch that
                        differ from the classification of the program's
                        errors and corrections (through the channel's
                        fold: the net flip of each qubit over rounds).
"""

from __future__ import annotations

import importlib
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.reference import bp as ref_bp
from benchmark.reference import classify, osd, rng

NUMBERS = ("sample_bits_differ", "bp_lanes_differ", "bp_llr_gap", "osd_lanes_differ",
           "counter_fields_differ")
HIST_BINS = 128
CHANNELS = Path(__file__).resolve().parent / "reference" / "channels"


class Reference:
    """The configuration's decoding problem, worked out from its file and
    its channel's (``reference/channels/<channel>.py``)."""

    def __init__(self, config: dict, p: float):
        self.p = p
        self.tanh_clip = float(config["tanh_clip"])
        self.max_iter = int(config["spec"]["bp_max_iter"])
        path = CHANNELS / f"{config['channel'].replace('-', '_')}.py"
        if not path.is_file():
            raise ValueError(f"no reference for the channel {config['channel']!r}: "
                             f"no file {path}")
        channel = importlib.import_module(f"benchmark.reference.channels.{path.stem}")
        problem = channel.problem(config, p)
        self.H, self.L, self.llr = problem["H"], problem["L"], problem["llr"]
        self.prior, self.band = problem["prior"], problem["band"]
        self.distance, self.fold = problem["distance"], problem["fold"]
        self.m, self.n = self.H.shape
        self.edges = int(np.count_nonzero(self.H))

    def place(self, device) -> None:
        """Put the reference's tables on ``device``, where it runs."""
        self.device = device
        self.prior, self.llr = self.prior.to(device), self.llr.to(device)
        self.graph = ref_bp.Graph(self.H, device)
        self.columns = osd.Columns(self.H, device)
        self.L = torch.from_numpy(self.L.astype(np.float32)).to(device)

    def draws(self, seed: int, batch_index: int, batch: int):
        """(uniforms, errors) of one batch of the seed's stream."""
        u = rng.counter_uniform(rng.batch_key(seed, self.p, batch_index), 0, batch, self.n,
                                device=self.device)
        return u, u < self.prior


def compare(ref: Reference, seed: int, batches: dict, counters: dict,
            seconds: dict | None = None) -> dict:
    """The numbers above over the checked batches. ``batches[b]`` holds the
    program's outputs of batch b (``errors``, ``syn``, ``hard``, ``llrs``,
    ``converged``, ``iterations``, ``final``), ``counters[b]`` its counters;
    ``seconds`` gets the reference's seconds by stage."""
    seconds = {} if seconds is None else seconds
    clock = [time.perf_counter()]

    def lap(stage):
        clock.append(time.perf_counter())
        seconds[stage] = seconds.get(stage, 0.0) + clock[-1] - clock[-2]

    out = dict.fromkeys(NUMBERS, 0)
    lanes = differ = 0
    gap = 0.0
    for b, got in sorted(batches.items()):
        errors = got["errors"].to(ref.device)
        syn = got["syn"].to(ref.device)
        B = errors.shape[0]
        u, want = ref.draws(seed, b, B)
        wrong = (errors != 0) != want
        if ref.band:
            wrong &= (u - ref.prior).abs() > ref.band
        out["sample_bits_differ"] += int(wrong.sum())
        out["sample_bits_differ"] += int((ref.graph.parity(errors) != syn).sum())
        del u, want, wrong
        lap("sample")

        llrs, conv = got["llrs"].to(ref.device), got["converged"].to(ref.device)
        iters, hard = got["iterations"].to(ref.device), got["hard"].to(ref.device)
        chunk = max(1, int(16e9 // (ref.graph.m * ref.graph.dc * 32)))
        r_llrs, r_conv, r_iters, r_hard = ref_bp.decode(ref.graph, syn, ref.llr, ref.max_iter,
                                                        ref.tanh_clip, chunk=chunk)
        apart = (r_conv != conv) | (r_iters != iters) | (r_hard != hard).any(-1)
        lanes += B
        differ += int(apart.sum())
        if bool((~apart).any()):
            rel = (llrs[~apart] - r_llrs[~apart]).abs() / (1.0 + r_llrs[~apart].abs())
            gap = max(gap, float(rel.max()))
        del r_llrs, r_conv, r_iters, r_hard
        lap("bp")

        want_final = hard.clone()
        fail = torch.nonzero(~conv).flatten()
        if len(fail):
            want_final[fail] = osd.osd0(ref.columns, syn[fail], llrs[fail], hard[fail])
        final = got["final"].to(ref.device)
        out["osd_lanes_differ"] += int((want_final != final).any(-1).sum())
        lap("osd")

        want_counts = classify.counters(errors, final, syn, conv, iters, ref.L,
                                        ref.graph.parity, ref.distance, HIST_BINS,
                                        fold=ref.fold)
        for field, value in want_counts.items():
            value = np.asarray(value)
            have = counters[b].get(field)
            out["counter_fields_differ"] += value.size if have is None or \
                np.shape(have) != value.shape else int(np.sum(np.asarray(have) != value))
        lap("classify")
    out["bp_lanes_differ"] = differ / max(lanes, 1)
    out["bp_llr_gap"] = gap
    return out
