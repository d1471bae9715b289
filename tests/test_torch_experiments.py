"""The port's experiments CLI against the JAX package's, on the CPU.

Both CLIs get the same arguments (the port's with ``--device cpu``) and
write their npz archives; the counters in them are compared. Both engines
key batch b of rate p as fold_in(fold_in(key(seed + i), hash(p) % 2**31), b),
so min-sum without alpha (exact arithmetic in both packages) must give
identical counters; sum-product may reorder an OSD near-tie through XLA's
last-ulp tanh/atanh (ROADMAP.md, Queue 3), so its rates are held within 4
sigma of the two-sample binomial difference. The rates are ones where XLA's
float32 log gives torch's priors (test_torch_engine.py,
test_torch_dem_engine.py). The JAX ``complete`` presets run their Pallas DEM
kernel in interpret mode here, ``complete-bposd`` with its bf16 streams,
which the port runs too (min-sum identical after the same roundings).
"""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from qldpc_tpu.experiments import get_preset as jax_preset
from qldpc_tpu.experiments.cli import main as jax_main
from qldpc_tpu.experiments import PRESETS as JAX_PRESETS
from qldpc_tpu.experiments import runners as jax_runners
from qldpc_tpu.experiments.runners import _llr_histograms as jax_llr_histograms
from qldpc_tpu_torch.convert import (
    bp_config_from_reference,
    osd_config_from_reference,
    spec_from_reference,
)
from qldpc_tpu_torch.experiments import ExperimentSpec, get_preset, run_experiment
from qldpc_tpu_torch.experiments import runners
from qldpc_tpu_torch.experiments.cli import main
from qldpc_tpu_torch.experiments.results_io import load_reference_archive, load_results

torch.set_num_threads(2)

C72 = "[[72, 12, 6]]"


def _both(tmp_path, args, jax_args=()):
    """Run both CLIs on ``args``; returns their two output directories."""
    jax_out, out = tmp_path / "jax", tmp_path / "port"
    common = ["--no-checkpoint", "--quiet"]
    assert jax_main([*args, *jax_args, "--out", str(jax_out), *common]) == 0
    assert main([*args, "--device", "cpu", "--out", str(out), *common]) == 0
    return jax_out, out


def _load(out, name):
    return load_results(out / f"{name}.npz")


def _cells(results):
    return {(c, k): d for c in results if c != "_meta" for k, d in results[c].items()}


def _identical(a: dict, b: dict) -> None:
    ca, cb = _cells(a), _cells(b)
    assert ca.keys() == cb.keys()
    for cell in ca:
        assert ca[cell].keys() == cb[cell].keys()
        for k in ca[cell]:
            if k == "llr_hist":
                continue
            np.testing.assert_array_equal(np.asarray(cb[cell][k]), np.asarray(ca[cell][k]),
                                          err_msg=f"{cell} {k}")


def _within_bars(a: dict, b: dict, keys=("ler", "osd")) -> None:
    ca, cb = _cells(a), _cells(b)
    assert ca.keys() == cb.keys()
    for cell in ca:
        n1, n2 = ca[cell]["trials"], cb[cell]["trials"]
        for k in keys:
            x, y = ca[cell][k], cb[cell][k]
            lim = 4 * math.sqrt(x * (1 - x) / n1 + y * (1 - y) / n2) + 1e-12
            assert abs(x - y) <= lim, (cell, k, x, y, lim)


STUDY = ["run", "study", "--codes", C72, "--trials", "192", "--batch-size", "64",
         "--error-rates", "0.03", "0.06"]


def test_study_min_sum_identical_and_archives(tmp_path):
    jax_out, out = _both(tmp_path, [*STUDY, "--set", "bp_method=min-sum"])
    a, b = _load(jax_out, "study"), _load(out, "study")
    _identical(a, b)
    assert b[C72][0.06]["BPs_fault"] > 0
    # the reference-format archive has the same keys and values
    ra = load_reference_archive(jax_out / "study_reference_format.npz")
    rb = load_reference_archive(out / "study_reference_format.npz")
    assert ra.keys() == rb.keys() and ra[C72].keys() == rb[C72].keys()
    assert np.array_equal(ra["physicalErrorRates"], rb["physicalErrorRates"])
    for k in ra[C72]:
        assert np.array_equal(np.asarray(ra[C72][k]), np.asarray(rb[C72][k])), k
    # the archived spec is the one run, with the port's plots beside it
    spec_a, spec_b = a["_meta"]["spec"], b["_meta"]["spec"]
    assert spec_b.pop("output_dir") == str(out) and spec_a.pop("output_dir") == str(jax_out)
    assert spec_b == spec_a
    assert (out / "study_ler.png").exists()


def test_study_sum_product_within_bars(tmp_path):
    jax_out, out = _both(tmp_path, STUDY)
    _within_bars(_load(jax_out, "study"), _load(out, "study"))


@pytest.mark.parametrize("preset", ["complete", "complete-bposd"])
def test_circuit_level_presets_on_the_steane_dem(preset, tmp_path, capsys):
    args = ["run", preset, "--codes", "steane", "--trials", "256", "--batch-size", "128",
            "--error-rates", "0.005", "0.006", "--set", "bp_method=min-sum"]
    # both CLIs run the preset as shipped: complete-bposd with bf16 streams
    jax_out, out = _both(tmp_path, args)
    a, b = _load(jax_out, preset), _load(out, preset)
    _identical(a, b)
    assert b["steane"][0.006]["BPs_fault"] > 0
    streams = "bfloat16" if preset == "complete-bposd" else "float32"
    assert b["_meta"]["spec"]["bp_stream_dtype"] == streams
    assert "not ported" not in capsys.readouterr().err


def test_space_time_on_72_identical(tmp_path):
    args = ["run", "space-time", "--codes", C72, "--trials", "128", "--batch-size", "64",
            "--error-rates", "0.004", "0.008", "--set", "bp_method=min-sum",
            "--set", "n_rounds=3"]
    jax_out, out = _both(tmp_path, args)
    a, b = _load(jax_out, "space-time"), _load(out, "space-time")
    _identical(a, b)
    assert b[C72][0.008]["BPs_fault"] > 0


def test_bp_iteration_llr_histograms(tmp_path):
    """Counters identical under min-sum; the LLR histograms are drawn with
    keyed jax.random.bernoulli (float32 draws, as the JAX CLI makes them
    without x64), so they are identical under min-sum, and under
    sum-product differ by at most 0.1% of the entries (last-ulp LLRs that
    cross a bin edge)."""
    args = ["run", "bp-iteration", "--codes", "steane", "--trials", "128", "--batch-size",
            "64", "--set", "max_iter_grid=[5, 10]", "--set", "bp_method=min-sum"]
    with jax.enable_x64(False):
        jax_out, out = _both(tmp_path, args)
    a, b = _load(jax_out, "bp-iteration"), _load(out, "bp-iteration")
    _identical(a, b)
    for cell, d in _cells(a).items():
        got = _cells(b)[cell]["llr_hist"]
        for k in ("edges", "true_0", "true_1"):
            assert np.array_equal(got[k], d["llr_hist"][k]), (cell, k)
    spec = get_preset("bp-iteration")
    ref_spec = jax_preset("bp-iteration")
    with jax.enable_x64(False):
        ref = jax_llr_histograms(ref_spec, C72, 0.01, 20, None, seed=3)
    got = runners._llr_histograms(spec, C72, 0.01, 20, None, seed=3, device="cpu")
    entries = got["true_0"].sum() + got["true_1"].sum()
    assert entries == 2048 * 72 and got["true_1"].sum() == ref["true_1"].sum() > 0
    moved = sum(np.abs(got[k] - ref[k]).sum() for k in ("true_0", "true_1"))
    assert moved <= 1e-3 * entries, moved


def test_presets_listing_identical(capsys):
    assert jax_main(["presets"]) == 0
    ref = capsys.readouterr().out
    assert main(["presets"]) == 0
    assert capsys.readouterr().out == ref


# The four presets that refused until OSD-e and the fitted alpha were
# ported; their ids keep the ROADMAP.md items that ported them. The OSD-e
# presets run min-sum, as the identical CLI tests above do; rework-minsum is
# min-sum with Alvarado's alpha, whose fit JAX draws in float32 without x64,
# as its CLI does.
_PORTED_PRESETS = {
    "paper-gpu": ["--error-rates", "0.03", "0.06", "--set", "bp_method=min-sum"],
    "rework": ["--error-rates", "0.05", "0.1", "--set", "bp_method=min-sum"],
    "different-orders": ["--error-rates", "0.06", "--set", "bp_method=min-sum",
                         "--set", "max_iter_grid=[10, 30]"],
    "rework-minsum": ["--error-rates", "0.04", "0.06"],
}


@pytest.mark.parametrize("preset", [
    pytest.param("paper-gpu", id="paper-gpu-item 1: OSD-e"),
    pytest.param("rework", id="rework-item 1: OSD-e"),
    pytest.param("different-orders", id="different-orders-item 1: OSD-e"),
    pytest.param("rework-minsum", id="rework-minsum-item 2: Alvarado"),
])
def test_unported_presets_refuse_before_any_engine(preset, tmp_path):
    """The presets of OSD-e(7) and of the fitted alpha run on the CPU and
    give the JAX CLI's counters (and fitted alphas) on the same arguments.
    Their code-capacity and doubled syndromes are all in image(H), so OSD-e
    returns OSD-0 there (tests/test_torch_osde.py holds the search)."""
    args = ["run", preset, "--codes", C72, "--trials", "128", "--batch-size", "64",
            *_PORTED_PRESETS[preset]]
    with jax.enable_x64(False):
        jax_out, out = _both(tmp_path, args)
    a, b = _load(jax_out, preset), _load(out, preset)
    assert all(d["BPs_fault"] > 0 for d in _cells(b).values())
    if preset == "rework-minsum":
        # the fitted alphas are the JAX ones exactly; with them BP's message
        # sums round in each package's order, which leaves BP's decisions
        # alone but may reorder an OSD near-tie (ROADMAP.md, Queue 3): BP's
        # counters identical, the LER within the 4-sigma bars above
        for cell, d in _cells(a).items():
            got = _cells(b)[cell]
            for k in ("alpha", "trials", "BPs_fault", "osd", "average_iterations"):
                assert got[k] == d[k], (cell, k)
            assert 0.0 < got["alpha"] < 1.0
        _within_bars(a, b, keys=("ler",))
    else:
        _identical(a, b)
    if preset == "different-orders":
        assert sorted(k[:2] for k in b[C72]) == [(10, 0), (10, 7), (30, 0), (30, 7)]


def test_mm_dtype_refuses_before_any_engine(tmp_path, monkeypatch):
    """bp_mm_dtype with the layered schedule: the JAX BPConfig refuses it,
    and so does the port, before any engine is built."""
    def no_engine(*a, **kw):
        raise AssertionError("an engine was built")

    args = ["run", "study", "--set", "bp_backend=pallas", "--set", "bp_schedule=layered",
            "--set", "bp_mm_dtype=bfloat16"]
    with pytest.raises(ValueError, match="mm_dtype"):
        jax_main([*args, "--out", str(tmp_path / "jax")])
    monkeypatch.setattr(runners, "build_engine", no_engine)
    out = tmp_path / "port"
    with pytest.raises(ValueError, match="mm_dtype"):
        main([*args, "--device", "cpu", "--out", str(out)])
    assert not out.exists()  # nothing was written


@pytest.mark.parametrize("preset", sorted(JAX_PRESETS))
def test_runner_configs_are_converts_mapping_of_the_jax_runners(preset):
    """The runner's BP and OSD configs are convert.py's mapping of the JAX
    runner's, for every preset as shipped (complete-bposd's bf16 streams
    included)."""
    spec = runners.check_spec(get_preset(preset))
    jax_spec = jax_preset(preset)
    assert runners._bp_config(spec) == bp_config_from_reference(
        jax_runners._bp_config(jax_spec))
    jax_osd = jax_runners._osd_config(jax_spec)
    assert runners._osd_config(spec) == (
        None if jax_osd is None else osd_config_from_reference(jax_osd))


def test_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["run", "study", "--codes", "steane", "--trials", "8", "--out", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="one process per device"):
        run_experiment(get_preset("study"), device=["cpu", "cpu"])


def test_a_jax_spec_json_runs_unchanged(tmp_path):
    spec = jax_preset("study").replace(
        name="from-json", codes=["steane"], trials=128, batch_size=64,
        error_rates=[0.02, 0.05], bp_method="min-sum", bp_backend="pallas",
        osd_backend="lanes", output_dir=str(tmp_path / "unused"),
    )
    path = tmp_path / "spec.json"
    spec.to_json(path)
    port_spec = ExperimentSpec.from_json(path)
    assert port_spec == spec_from_reference(spec)
    assert dataclasses.asdict(port_spec) == dataclasses.asdict(spec)
    jax_out, out = _both(tmp_path, ["run", "--config", str(path)])
    _identical(_load(jax_out, "from-json"), _load(out, "from-json"))


def test_checkpointed_cli_run_resumes(tmp_path):
    """The CLI checkpoints by default: a second run over the same output
    reads every batch back and gives the same counters."""
    args = ["run", "study", "--codes", "steane", "--trials", "96", "--batch-size", "32",
            "--error-rates", "0.05", "--device", "cpu", "--out", str(tmp_path), "--quiet"]
    assert main(args) == 0
    first = _load(tmp_path, "study")
    ckpt = sorted((tmp_path / "study_ckpt").iterdir())
    assert [p.name for p in ckpt] == ["steane_code-capacity_p0.05_s0.npz"]
    assert json.loads(str(np.load(ckpt[0])["meta"]))["next_batch"] == 3
    assert main(args) == 0
    _identical(first, _load(tmp_path, "study"))


def test_trace_writes_a_chrome_trace(tmp_path):
    assert main(["run", "study", "--codes", "steane", "--trials", "32", "--batch-size", "32",
                 "--error-rates", "0.05", "--device", "cpu", "--out", str(tmp_path / "o"),
                 "--no-checkpoint", "--quiet", "--trace", str(tmp_path / "t")]) == 0
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_checkpointed_grid_entries_keep_their_own_counters(tmp_path):
    """Each max_iter_grid entry resumes its own checkpoint files: the
    checkpointed sweep equals the same sweep without checkpoints (BP(30)
    fails on none of the 256 Steane trials, BP(1) on some)."""
    args = ["run", "bp-iteration", "--codes", "steane", "--trials", "256",
            "--batch-size", "64", "--error-rates", "0.05", "--set", "max_iter_grid=[1, 30]",
            "--device", "cpu", "--quiet"]
    assert main([*args, "--out", str(tmp_path / "ckpt")]) == 0
    assert main([*args, "--out", str(tmp_path / "plain"), "--no-checkpoint"]) == 0
    got, ref = _load(tmp_path / "ckpt", "bp-iteration"), _load(tmp_path / "plain", "bp-iteration")
    _identical(got, ref)
    assert ref["steane"][(1, 0.05)]["BPs_fault"] > 0
    assert got["steane"][(30, 0.05)]["BPs_fault"] == 0
    ckpt = tmp_path / "ckpt" / "bp-iteration_ckpt"
    assert sorted(p.name for p in ckpt.iterdir()) == ["max_iter1", "max_iter30"]
    # a second run resumes each entry's finished files to the same counters
    assert main([*args, "--out", str(tmp_path / "ckpt")]) == 0
    _identical(_load(tmp_path / "ckpt", "bp-iteration"), ref)


def test_checkpoint_layout_without_grids(tmp_path):
    """A spec without grids keeps its files in <name>_ckpt itself, where the
    JAX runner writes them (tests/test_torch_checkpoint.py resumes them
    across the packages)."""
    args = ["run", "study", "--codes", "steane", "--trials", "64", "--batch-size", "64",
            "--error-rates", "0.05", "--device", "cpu", "--quiet", "--out", str(tmp_path)]
    assert main(args) == 0
    files = list((tmp_path / "study_ckpt").iterdir())
    assert len(files) == 1 and files[0].suffix == ".npz"
