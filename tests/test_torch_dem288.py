"""The two-gross code's circuit-level DEM, [[288,12,18]], as the benchmark's
``dem288_p003`` cell configures it (``benchmark/configs/bb288_dem_bposd.json``),
at two rounds on the CPU: the port's DEM and priors are the plain
reference's (``benchmark/reference``), and a seeded batch decodes as the
reference does stage by stage (``benchmark/check.py``), with OSD-0 by the
factored route over more than one block of columns."""

import copy

import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.reference import circuit, codes
from qldpc_tpu_torch.codes import get_code
from qldpc_tpu_torch.decoders import osd as osd_module
from qldpc_tpu_torch.noise.circuit import parametric_memory_dem
from qldpc_tpu_torch.utils import profiling

torch.set_num_threads(2)

CELL = "dem288_p003"
SEED = 2**33 + 2626
# the DEM over two rounds: 144 + 288 + 144 detectors
ROUNDS, DETECTORS, MECHANISMS = 2, 576, 15693


@pytest.fixture(scope="module")
def cell():
    return harness.load_cell(CELL)


def _at_two_rounds(config: dict, batch: int) -> dict:
    config = copy.deepcopy(config)
    config.update(rounds=ROUNDS, detectors=DETECTORS, mechanisms=MECHANISMS)
    config["spec"].update(n_rounds=ROUNDS, batch_size=batch)
    return config


def test_the_configuration_is_the_registry_s_two_gross_code(cell):
    config = cell.config
    port = get_code(config["code"]["name"])
    ref = codes.bb_code(config["code"])
    for key in ("Hx", "Hz", "Lx", "Lz"):
        assert np.array_equal(ref[key], getattr(port, key)), key
    assert (port.n, port.k, port.distance) == (288, 12, 18) == \
        tuple(config["code"][k] for k in ("n", "k", "d"))
    # rounds = d; the first and the last round detect the Z checks alone
    m = port.Hz.shape[0]
    assert config["rounds"] == config["spec"]["n_rounds"] == 18
    assert config["detectors"] == m + (config["rounds"] - 1) * 2 * m + m == 5184
    assert config["reduced"] == [] and cell.traffic["p"] == 0.003


def test_the_dem_and_its_priors_are_the_reference_s(cell):
    config = _at_two_rounds(cell.config, batch=8)
    port = parametric_memory_dem(get_code(config["code"]["name"]), basis="z", rounds=ROUNDS)
    ref = circuit.parametric_dem(codes.bb_code(config["code"]), "z", ROUNDS)
    assert port.H.shape == (DETECTORS, MECHANISMS)
    for key in ("H", "L", "ratios", "counts"):
        assert np.array_equal(ref[key], getattr(port, key)), key
    engine = harness.build_engine(config, "cpu")
    q, llr = engine.priors(cell.traffic["p"])
    want_q, want_llr = circuit.priors(ref, cell.traffic["p"])
    assert torch.equal(q, want_q) and torch.equal(llr, want_llr)


def test_a_seeded_batch_decodes_as_the_reference_stage_by_stage(cell, monkeypatch):
    """Past K4's block (forced: two rounds fit it) OSD-0 takes the route
    ``factored+transform``; the window's first batch is checked as a run
    checks it, and every number reads 0."""
    monkeypatch.setattr(osd_module, "SMEM_LIMIT", 0)
    config, p = _at_two_rounds(cell.config, batch=8), float(cell.traffic["p"])
    engine = harness.build_engine(config, "cpu")
    assert engine.osd.elimination == "factored+transform"
    ref = check.Reference(config, p)
    ref.place(torch.device("cpu"))
    capture = harness.Capture(engine, keep=[0])
    before = profiling.counts()
    try:
        win = harness.window(engine, p, SEED, float("inf"), capture, max_batches=1)
    finally:
        capture.remove()
    after = profiling.counts()
    counters = {b: harness.batch_counters(win["totals"], b) for b in capture.kept}
    assert sorted(counters) == [0]
    numbers = check.compare(ref, SEED, capture.kept, counters)
    assert numbers == dict.fromkeys(check.NUMBERS, 0)
    blocks = after.get("osd.factored_blocks", 0) - before.get("osd.factored_blocks", 0)
    assert blocks > 1  # more than one block of columns
    assert int(counters[0]["osd_invocations"]) > 0
