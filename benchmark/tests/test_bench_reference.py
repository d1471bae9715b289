"""The reference's frozen copies and plain decoders against the program's
CPU path on [[72,12,6]] at a small size. The tests import both sides; the
reference itself imports nothing of the program."""

import numpy as np
import pytest
import torch

from benchmark import check
from benchmark.reference import bp as ref_bp
from benchmark.reference import circuit, classify, codes, osd, rng
from benchmark.tests import tiny
from qldpc_tpu_torch.codes import get_code
from qldpc_tpu_torch.decoders.bp import BPConfig, BPDecoder
from qldpc_tpu_torch.decoders.osd import OSDConfig, OSDDecoder
from qldpc_tpu_torch.noise.circuit import parametric_memory_dem
from qldpc_tpu_torch.utils import rng as port_rng

CODE = codes.bb_code(tiny.CODE72)


@pytest.fixture(scope="module")
def dem():
    return circuit.parametric_dem(CODE, "z", 2)


def test_threefry_stream_is_the_engines():
    for seed, p, b in ((0, 0.01, 0), (2**33 + 7, 0.05011872336272722, 5), (3_000_000_001, 1e-3, 9)):
        k = port_rng.fold_in(port_rng.fold_in(port_rng.key(seed), hash(p) % 2**31), b)
        want = port_rng.counter_uniform(k, 37, 16, 145)
        assert torch.equal(rng.counter_uniform(rng.batch_key(seed, p, b), 37, 16, 145), want)


def test_bb_code_and_logicals_are_the_engines():
    port = get_code("[[72, 12, 6]]")
    for key in ("Hx", "Hz", "Lx", "Lz"):
        assert np.array_equal(CODE[key], getattr(port, key)), key
    with pytest.raises(ValueError):
        codes.bb_code(dict(tiny.CODE72, k=10))


def test_circuit_dem_and_priors_are_the_engines(dem):
    port = parametric_memory_dem(get_code("[[72, 12, 6]]"), basis="z", rounds=2)
    assert np.array_equal(dem["H"], port.H) and np.array_equal(dem["L"], port.L)
    assert np.array_equal(dem["ratios"], port.ratios) and np.array_equal(dem["counts"], port.counts)
    q, _ = circuit.priors(dem, 0.003)
    assert np.allclose(q.numpy(), port.priors_at(0.003), rtol=1e-4)


def _draw(H, prior, B, seed=5, p=0.05):
    u = rng.counter_uniform(rng.batch_key(seed, p, 0), 0, B, H.shape[1])
    errors = (u < prior).to(torch.int8)
    return errors, ref_bp.Graph(H, "cpu").parity(errors).to(torch.int8)


@pytest.mark.parametrize("kind", ["cc", "dem"])
def test_plain_bp_equals_the_engines_float32_bp(kind, dem):
    if kind == "cc":
        H, p = CODE["Hx"], 0.06
        p32 = torch.tensor(p, dtype=torch.float32)
        prior, llr = p32, torch.log((1 - p32) / p32).expand(H.shape[1])
    else:
        H, p = dem["H"], 0.004
        prior, llr = circuit.priors(dem, p)
    _, syn = _draw(H, prior, 512, p=p)
    got = ref_bp.decode(ref_bp.Graph(H, "cpu"), syn, llr, 50, 0.9999999)
    want = BPDecoder(H, BPConfig(max_iter=50))(syn, llr)
    apart = (got[1] != want.converged) | (got[2] != want.iterations) | \
        (got[3] != want.hard).any(-1)
    assert int(apart.sum()) <= 1
    ok = ~apart
    gap = ((got[0][ok] - want.llrs[ok]).abs() / (1 + got[0][ok].abs())).max()
    assert float(gap) < 1e-3
    assert 0 < int(got[1].sum()) < 512  # both converged and failed samples


@pytest.mark.parametrize("kind", ["cc", "dem"])
def test_plain_osd0_equals_the_engines_osd0(kind, dem):
    if kind == "cc":
        H, p = CODE["Hx"], 0.08
        prior = torch.tensor(p, dtype=torch.float32)
        llr = torch.log((1 - prior) / prior).expand(H.shape[1])
    else:
        H, p = dem["H"], 0.006
        prior, llr = circuit.priors(dem, p)
    _, syn = _draw(H, prior, 256, p=p)
    llrs, conv, _, hard = ref_bp.decode(ref_bp.Graph(H, "cpu"), syn, llr, 10, 0.9999999)
    fail = ~conv
    assert int(fail.sum()) > 10
    want = OSDDecoder(H, OSDConfig())(syn[fail], llrs[fail], hard[fail])
    got = osd.osd0(osd.Columns(H, "cpu"), syn[fail], llrs[fail], hard[fail], chunk=64)
    assert torch.equal(got, want)
    assert bool((ref_bp.Graph(H, "cpu").parity(got) == syn[fail]).all())


def test_classification_equals_the_engines_counters():
    from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine
    from qldpc_tpu_torch.utils import rng as prng

    eng = MonteCarloEngine(get_code("[[72, 12, 6]]"), EngineConfig(batch_size=256),
                           device="cpu")
    key = prng.fold_in(prng.fold_in(prng.key(3), hash(0.07) % 2**31), 0)
    errors, syn, priors = eng._sample(key, 0.07)
    res = eng._decode(syn, priors, 1.0)
    final, _ = eng._post_process(syn, res)
    valid = torch.ones(256, dtype=torch.bool)
    want = eng._classify(errors, final, syn, res, valid)._asdict()
    graph = ref_bp.Graph(CODE["Hx"], "cpu")
    got = classify.counters(errors, final, syn, res.converged, res.iterations,
                            torch.from_numpy(CODE["Lx"].astype(np.float32)), graph.parity,
                            6, check.HIST_BINS)
    for field, value in got.items():
        if field == "osd_overflow":
            continue
        assert np.array_equal(np.asarray(value), want[field].numpy()), field
    assert got["logical_errors"] > 0 and got["degeneracies"] > 0


# ------------------------------------------------- the channels' problems
def _engine_problem(kind, **spec):
    """(config, p, engine) of the tiny cell ``kind``, its spec updated by
    ``spec``, with its engine on the CPU."""
    from benchmark import harness

    c = tiny.cell(kind)
    c.config["spec"].update(spec)
    return c.config, float(c.traffic["p"]), harness.build_engine(c.config, "cpu")


def _held_to_draws(ref, engine, p, seed=11):
    """The engine's errors, syndromes and priors of batch 0 against the
    reference's draws, parity and LLRs, bit for bit."""
    key = port_rng.fold_in(port_rng.fold_in(port_rng.key(seed), hash(p) % 2**31), 0)
    errors, syn, priors = engine._sample(key, p)
    _, want = ref.draws(seed, 0, errors.shape[0])
    assert torch.equal(errors != 0, want)
    assert torch.equal(ref.graph.parity(errors), syn.to(torch.int32))
    assert torch.equal(torch.as_tensor(priors).expand(ref.n), ref.llr)
    return errors, syn, priors


@pytest.mark.parametrize("kind", ["cc", "dem"])
def test_channel_files_give_the_engines_problem(kind):
    config, p, engine = _engine_problem(kind)
    ref = check.Reference(config, p)
    port = get_code("[[72, 12, 6]]")
    if kind == "cc":
        H, L = port.Hx, port.Lx
        prior = torch.tensor(p, dtype=torch.float32)
        llr = torch.log((1.0 - prior) / prior).expand(H.shape[1])
        assert (ref.band, ref.distance) == (0.0, port.distance)
    else:
        dem = parametric_memory_dem(port, basis="z", rounds=2)
        H, L = dem.H, dem.L
        prior, llr = engine.priors(p)
        assert (ref.band, ref.distance) == (2.0 ** -22, 0)
    assert np.array_equal(ref.H, H) and ref.H.dtype == np.uint8
    assert np.array_equal(ref.L, L)
    assert torch.equal(ref.prior, prior) and torch.equal(ref.llr, llr)
    bits = torch.randint(0, 2, (4, ref.n), dtype=torch.int8)
    assert ref.fold(bits) is bits
    ref.place("cpu")
    _held_to_draws(ref, engine, p)


def test_an_unknown_channel_names_the_file_looked_for():
    config = dict(tiny.cell("cc").config, channel="phenomenological")
    with pytest.raises(ValueError, match=r"channels/phenomenological\.py"):
        check.Reference(config, 0.01)


@pytest.mark.parametrize("flip_rate", [None, 0.02])
def test_space_time_channel_is_the_engines(flip_rate):
    from qldpc_tpu_torch.noise import spacetime as st

    config, p, engine = _engine_problem("st", syndrome_flip_rate=flip_rate)
    ref = check.Reference(config, p)
    H = get_code("[[72, 12, 6]]").Hx
    assert engine.n_rounds == 4
    assert np.array_equal(ref.H, st.space_time_matrix(H, 4))
    assert np.array_equal(ref.L, get_code("[[72, 12, 6]]").Lx)
    assert (ref.band, ref.distance) == (0.0, 6)
    q = p if flip_rate is None else flip_rate
    assert torch.equal(ref.prior[: 4 * 72], torch.tensor(p, dtype=torch.float32).expand(288))
    assert torch.equal(ref.prior[4 * 72:], torch.tensor(q, dtype=torch.float32).expand(144))
    ref.place("cpu")
    errors, syn, priors = _held_to_draws(ref, engine, p)
    assert torch.equal(ref.fold(errors), st.fold_data_correction(errors, 72, 4).to(torch.int8))


def test_space_time_folded_classification_equals_the_engines_counters():
    config, p, engine = _engine_problem("st")
    ref = check.Reference(config, 0.04)
    ref.place("cpu")
    key = port_rng.fold_in(port_rng.fold_in(port_rng.key(3), hash(0.04) % 2**31), 0)
    errors, syn, priors = engine._sample(key, 0.04)
    res = engine._decode(syn, priors, 1.0)
    final, _ = engine._post_process(syn, res)
    valid = torch.ones(errors.shape[0], dtype=torch.bool)
    want = engine._classify(errors, final, syn, res, valid)._asdict()
    got = classify.counters(errors, final, syn, res.converged, res.iterations, ref.L,
                            ref.graph.parity, ref.distance, check.HIST_BINS, fold=ref.fold)
    for field, value in got.items():
        if field == "osd_overflow":
            continue
        assert np.array_equal(np.asarray(value), want[field].numpy()), field
    assert got["bp_faults"] > 0 and got["logical_errors"] > 0 and got["degeneracies"] > 0
