"""A whole run of a small cell on the CPU: the check passes on the program
as configured and fails on its bf16 control (for the space-time cell, the
reference's BP with bf16 messages in K6's place) and on a timed path
broken underneath. The run here skips the look for a card; everything
after it is the run's own. One test runs a real cell on the card."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
KINDS = ["cc", "dem", "st"]


@pytest.mark.parametrize("kind", KINDS)
def test_program_as_configured_is_correct(kind):
    res = tiny.run(kind)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"trials_per_s", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("kind", KINDS)
def test_traced_run_reports_its_layers(kind):
    res = tiny.run(kind, traced=True)
    assert res["correct"], res["checks"]
    assert {"sample_ms", "bp_ms", "osd_ms", "classify_ms"} <= set(res["metrics"])
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]
    assert len(res["breakdown"]["idle_gaps"]) <= 10


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_control_is_not_correct(kind):
    res = tiny.run(kind, control=True)
    assert not res["correct"]
    c = res["checks"]
    assert c["bp_llr_gap"]["value"] > c["bp_llr_gap"]["limit"] or \
        c["bp_lanes_differ"]["value"] > c["bp_lanes_differ"]["limit"]


def test_the_bp_control_puts_the_reference_in_bps_place():
    """As configured the space-time engine decodes with K6's decoder; with
    the control ``{"bp": "bfloat16"}`` with the reference's BP, its
    messages kept in bfloat16, through every capture (``calibrate.py``
    captures seed after seed)."""
    from qldpc_tpu_torch.decoders.spacetime_bp import SpaceTimeBPDecoder
    from qldpc_tpu_torch.utils import rng

    from benchmark import check, harness
    from benchmark.reference import bp as ref_bp

    config, p = tiny.st_config(), 0.03
    assert isinstance(harness.build_engine(config, "cpu", p=p).bp, SpaceTimeBPDecoder)
    engine = harness.build_engine(config, "cpu", control=True, p=p)
    for _ in range(2):
        harness.Capture(engine).remove()
    _, syn, priors = engine._sample(rng.key(7), p)
    got = engine._decode(syn, priors, 1.0)
    ref = check.Reference(config, p)
    ref.place("cpu")
    low, plain = (ref_bp.decode(ref.graph, syn, ref.llr, ref.max_iter, ref.tanh_clip,
                                messages=dtype) for dtype in (torch.bfloat16, torch.float32))
    for have, want in zip((got.llrs, got.converged, got.iterations, got.hard), low):
        assert torch.equal(have, want)
    assert not torch.equal(low[0], plain[0])


def _bp_unchanged(self, syndromes, priors, alpha=None):
    """BP that returns its input state: the priors, their hard decision."""
    from qldpc_tpu_torch.decoders.bp import BPResult

    B = syndromes.shape[0]
    n = getattr(self, "n_vars", None) or self.graph.n  # space-time: T (n + m)
    llrs = torch.as_tensor(priors, dtype=torch.float32).expand(B, n).clone()
    return BPResult(hard=(llrs < 0).to(torch.int8),
                    converged=(syndromes == 0).all(-1),
                    llrs=llrs, iterations=torch.zeros(B, dtype=torch.int32))


def _half_batch(original):
    def classify(self, errors, final, syn, bp_res, valid):
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        return original(self, errors, final, syn, bp_res, valid)
    return classify


def _osd_altered(original):
    def forward(self, syndromes, llrs, hard):
        out = original(self, syndromes, llrs, hard).clone()
        out[0, 0] ^= 1
        return out
    return forward


def _sample_altered(original):
    def sample(self, key, p):
        errors, syn, priors = original(self, key, p)
        errors = errors.clone()
        errors[-1, 3] ^= 1
        return errors, syn, priors
    return sample


FAULTS = ["bp_unchanged", "half_batch", "osd_answer_altered", "sample_altered"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fault", FAULTS)
def test_broken_timed_path_is_not_correct(kind, fault, monkeypatch):
    from qldpc_tpu_torch.decoders import bp, osd, spacetime_bp
    from qldpc_tpu_torch.mc import dem_engine, engine

    if fault == "bp_unchanged":
        cls = spacetime_bp.SpaceTimeBPDecoder if kind == "st" else bp.BPDecoder
        monkeypatch.setattr(cls, "forward", _bp_unchanged)
    elif fault == "half_batch":
        monkeypatch.setattr(engine.MonteCarloEngine, "_classify",
                            _half_batch(engine.MonteCarloEngine._classify))
    elif fault == "osd_answer_altered":
        monkeypatch.setattr(osd.OSDDecoder, "forward", _osd_altered(osd.OSDDecoder.forward))
    else:
        cls = dem_engine.DEMEngine if kind == "dem" else engine.MonteCarloEngine
        monkeypatch.setattr(cls, "_sample", _sample_altered(cls._sample))
    res = tiny.run(kind)
    assert not res["correct"], (fault, res["checks"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_a_real_cell_runs_correct_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cc144_p014", "--seed",
         str(2**32 + 99), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
