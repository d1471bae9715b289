"""The port's own copies of the JAX package's host modules against the
originals, the carry-over of JAX-built codes and DEMs, and the engines'
default device.

The copies (``qldpc_tpu_torch.codes``, ``ops.tanner``, ``noise.dem`` and
``noise.circuit``) keep the originals' names and numpy code, so every array
they build must equal the original's bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import qldpc_tpu.codes as jax_codes
from qldpc_tpu.noise import circuit as jax_circuit
from qldpc_tpu.ops import tanner as jax_tanner
from qldpc_tpu_torch import codes
from qldpc_tpu_torch.convert import code_from_reference, dem_from_reference
from qldpc_tpu_torch.decoders import BPConfig
from qldpc_tpu_torch.mc import DEMEngine, DEMEngineConfig, EngineConfig, MonteCarloEngine
from qldpc_tpu_torch.noise import circuit
from qldpc_tpu_torch.noise.dem import DEMData
from qldpc_tpu_torch.ops import tanner

DEMS = {"steane-rounds-3": ("steane", 3), "[[72]]-rounds-6": ("[[72, 12, 6]]", 6)}


@pytest.fixture(scope="module", params=list(DEMS))
def dems(request):
    name, rounds = DEMS[request.param]
    ref = jax_circuit.parametric_memory_dem(jax_codes.get_code(name), basis="z", rounds=rounds)
    got = circuit.parametric_memory_dem(codes.get_code(name), basis="z", rounds=rounds)
    return got, ref


def _same_fields(got, ref, fields):
    for f in fields:
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))), f


@pytest.mark.parametrize("name", jax_codes.ALL_CODE_NAMES)
def test_codes_match_the_originals(name):
    got, ref = codes.get_code(name), jax_codes.get_code(name)
    assert type(got) is codes.CSSCode and got.name == ref.name
    assert got.distance == ref.distance
    _same_fields(got, ref, ("Hx", "Hz", "Lx", "Lz"))
    assert codes.gf2.rank(got.Hx) == jax_codes.gf2.rank(ref.Hx)


def test_dem_builders_match_the_originals(dems):
    got, ref = dems
    assert type(got) is circuit.ParametricDEM
    _same_fields(got, ref, ("H", "L", "ratios", "counts"))
    _same_fields(got.at(0.002), ref.at(0.002), ("H", "L", "priors"))


def test_fixed_prior_dem_matches_the_original():
    got = circuit.memory_experiment_dem(codes.get_code("steane"), p=0.01, rounds=3)
    ref = jax_circuit.memory_experiment_dem(jax_codes.get_code("steane"), p=0.01, rounds=3)
    assert type(got) is DEMData
    _same_fields(got, ref, ("H", "L", "priors", "llrs"))


def test_tanner_tables_match_the_originals(dems):
    H = dems[0].H
    for a, b in zip(tanner.parity_tables(H), jax_tanner.parity_tables(H)):
        assert np.array_equal(a, b)
    got, ref = tanner.TannerGraph.from_H(H), jax_tanner.TannerGraph.from_H(H)
    _same_fields(got, ref, [f.name for f in dataclasses.fields(ref)])


def test_codes_and_dems_carry_over(dems):
    got, ref = dems
    code = code_from_reference(jax_codes.get_code("[[72, 12, 6]]"))
    assert type(code) is codes.CSSCode
    assert code.name == "[[72, 12, 6]]" and code.distance == 6
    _same_fields(code, codes.get_code("[[72, 12, 6]]"), ("Hx", "Hz", "Lx", "Lz"))
    carried = dem_from_reference(ref)
    assert type(carried) is circuit.ParametricDEM
    _same_fields(carried, got, ("H", "L", "ratios", "counts"))
    fixed = dem_from_reference(ref.at(0.003))
    assert type(fixed) is DEMData
    _same_fields(fixed, got.at(0.003), ("H", "L", "priors"))
    # a dict of the fields works as well
    as_dict = {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}
    _same_fields(dem_from_reference(as_dict), got, ("H", "L", "ratios", "counts"))


def test_dem_engine_refuses_a_jax_built_dem():
    ref = jax_circuit.parametric_memory_dem(jax_codes.get_code("steane"), basis="z", rounds=2)
    with pytest.raises(TypeError, match="dem_from_reference"):
        DEMEngine(ref, DEMEngineConfig(batch_size=8), device="cpu")


def test_engines_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dem = circuit.parametric_memory_dem(codes.get_code("steane"), basis="z", rounds=2)
    cfg = DEMEngineConfig(bp=BPConfig(max_iter=5), batch_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEMEngine(dem, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MonteCarloEngine(codes.get_code("steane"), EngineConfig(batch_size=8))
    # asked for, the CPU runs the plain versions
    assert DEMEngine(dem, cfg, device="cpu").device.type == "cpu"


# ------------------------------------------------- the experiments layer's copies
def _source_lines(module):
    import inspect

    return inspect.getsource(module).splitlines()


def _copy_matches(copy, original, renamed=()):
    """The copy is the original with a first line naming it and the imports
    of ``renamed`` pointed at the port."""
    got, ref = _source_lines(copy), _source_lines(original)
    assert got[0].startswith(f"# Copied from {original.__name__.replace('.', '/')}.py")
    for old, new in renamed:
        ref = [line.replace(old, new) for line in ref]
    assert got[1:] == ref


def test_experiment_configs_are_copies():
    from qldpc_tpu.experiments import configs as jax_configs
    from qldpc_tpu_torch.experiments import configs

    _copy_matches(configs, jax_configs,
                  [("from qldpc_tpu.codes.registry", "from qldpc_tpu_torch.codes.registry")])
    assert list(configs.PRESETS) == list(jax_configs.PRESETS)
    for name, ref in jax_configs.PRESETS.items():
        got = configs.PRESETS[name]
        for f in dataclasses.fields(ref):
            assert getattr(got, f.name) == getattr(ref, f.name), (name, f.name)
        for code in got.codes:
            assert got.rates_for(code) == ref.rates_for(code)
    assert configs.LOGSPACE_GRID == jax_configs.LOGSPACE_GRID
    assert configs.get_preset("study") is not configs.PRESETS["study"]


def test_results_io_and_plotting_are_copies(tmp_path):
    from qldpc_tpu.experiments import results_io as jax_results_io
    from qldpc_tpu.utils import plotting as jax_plotting
    from qldpc_tpu_torch.experiments import results_io
    from qldpc_tpu_torch.utils import plotting

    _copy_matches(results_io, jax_results_io,
                  [("from qldpc_tpu.utils import plotting", "from qldpc_tpu_torch.utils import plotting")])
    _copy_matches(plotting, jax_plotting)
    # the copies draw and reload the same archive
    rates = [0.01, 0.02]
    res = {"steane": {p: {"ler": 0.1 * (i + 1)} for i, p in enumerate(rates)}, "_meta": {}}
    np.savez(tmp_path / "r.npz", results=np.array(res, dtype=object), allow_pickle=True)
    assert results_io.load_results(tmp_path / "r.npz") == jax_results_io.load_results(
        tmp_path / "r.npz")
    got = results_io.replot(tmp_path / "r.npz", tmp_path / "port.png")
    ref = jax_results_io.replot(tmp_path / "r.npz", tmp_path / "jax.png")
    assert got.exists() and ref.exists()


def test_phase_timer_is_a_copy():
    import inspect

    from qldpc_tpu.utils import profiling as jax_profiling
    from qldpc_tpu_torch.utils import profiling

    got, ref = profiling.PhaseTimer, jax_profiling.PhaseTimer
    assert inspect.getsource(got) == inspect.getsource(ref)
    timers = [got(), ref()]
    for t in timers:
        for name in ("a", "b", "a"):
            with t.phase(name):
                pass
    summaries = [t.summary() for t in timers]
    assert {k: v["calls"] for k, v in summaries[0].items()} == {"a": 2, "b": 1}
    assert all(s.keys() == summaries[1].keys() for s in summaries)
    assert timers[0].report().splitlines()[0] == timers[1].report().splitlines()[0]
