"""The port's examples against the JAX package's (examples/*.py).

Each port example runs with ``--device cpu`` and prints the marker lines
tests/test_examples.py checks in the JAX one. Both quickstarts decode the
same Steane errors to the same BP and OSD-0 decisions. Both noise-model
walkthroughs draw the same errors (the port's keyed ``rng.split`` is
``jax.random.split``; the JAX example runs without x64, as a user runs it),
so every sampling statistic they print is equal; their BP is sum-product in
float32, whose last-ulp tanh/atanh differences between XLA and torch turn
a few oscillating samples (ROADMAP.md, Queue 3: up to 2 lanes in 256), so
the converged fractions are held to that. degeneracy_count's counters equal
the JAX engine's at 200 trials with min-sum BP, where both packages'
arithmetic is exact; its default sum-product run is held to its markers.
"""

import itertools
import math
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from qldpc_tpu.codes import BB_CODE_NAMES, get_code
from qldpc_tpu.decoders import BPConfig as JaxBPConfig
from qldpc_tpu.decoders import BPDecoder as JaxBPDecoder
from qldpc_tpu.decoders.osd import OSDConfig as JaxOSDConfig
from qldpc_tpu.decoders.osd import OSDDecoder as JaxOSDDecoder
from qldpc_tpu.mc import EngineConfig as JaxEngineConfig
from qldpc_tpu.mc import MonteCarloEngine as JaxEngine
from qldpc_tpu.mc import counters_to_dict as jax_counters_to_dict
from qldpc_tpu.parallel import make_mesh
from qldpc_tpu_torch.decoders import BPConfig
from qldpc_tpu_torch.examples import degeneracy_count, noise_models, quickstart

torch.set_num_threads(2)

SUM_PRODUCT_LANES = 2 / 256  # the float32 sum-product deviation, ROADMAP.md Queue 3


def _jax_example(name: str, capsys, **kw) -> str:
    argv = sys.argv
    sys.argv = [name]
    try:
        with jax.enable_x64(False):
            module = runpy.run_path(f"examples/{name}.py")
            module["main"](**kw)
    finally:
        sys.argv = argv
    return capsys.readouterr().out


def _lines(out: str) -> dict:
    return {line.split(":")[0].split("=")[0].strip(): line for line in out.splitlines() if line}


def test_quickstart(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("QLDPC_PLOT_DIR", str(tmp_path))
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "corrected OK" in out
    ref = _jax_example("quickstart", capsys)
    keys = ("error", "syndrome", "BP decision", "OSD decision", "residual", "logical flip")
    got, want = _lines(out), _lines(ref)
    assert {k: got.get(k) for k in keys} == {k: want.get(k) for k in keys}


def _errors(rng):
    """Every nonzero Steane error (BP decodes them all), then 40 random
    weight-6 errors on [[72, 12, 6]] (BP fails on some: OSD-0 runs)."""
    n = 7
    for w in range(1, n + 1):
        for support in itertools.combinations(range(n), w):
            e = np.zeros(n, np.int8)
            e[list(support)] = 1
            yield "steane", e
    for _ in range(40):
        e = np.zeros(72, np.int8)
        e[rng.choice(72, 6, replace=False)] = 1
        yield "[[72, 12, 6]]", e


def test_quickstart_decisions_match_jax(rng):
    """quickstart.decode against the JAX example's BP(50) and OSD-0 steps."""
    p = 0.1
    decoders = {}
    osd_runs = 0
    for name, error in _errors(rng):
        H = get_code(name).Hx
        if name not in decoders:
            decoders[name] = (JaxBPDecoder(H, JaxBPConfig(max_iter=50)),
                              JaxOSDDecoder(H, JaxOSDConfig(order=0)))
        bp, osd = decoders[name]
        prior = np.full(H.shape[1], np.log((1 - p) / p), np.float32)
        syndrome = (error @ H.T) % 2
        res = bp(syndrome[None, :], prior)
        got = quickstart.decode(H, error, p, "cpu")
        assert np.array_equal(got["bp"], np.asarray(res.hard[0]))
        assert got["converged"] == bool(res.converged[0])
        assert got["iterations"] == int(res.iterations[0])
        if got["converged"]:
            assert got["osd"] is None
        else:
            osd_runs += 1
            ref = np.asarray(osd(syndrome[None, :], res.llrs, res.hard)[0])
            assert np.array_equal(got["osd"], ref)
    assert osd_runs > 0


def test_noise_models(capsys):
    noise_models.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "code capacity" in out and "space-time" in out
    ref = _jax_example("noise_models", capsys)
    got, want = out.splitlines(), ref.splitlines()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        # every sampling statistic equal; BP's converged share within the
        # float32 sum-product deviation
        conv_a, conv_b = (float(x.split("BP converged=")[1].split()[0]) if "BP converged=" in x
                          else None for x in (a, b))
        assert a.split("BP converged=")[0] == b.split("BP converged=")[0]
        if conv_a is not None:
            assert abs(conv_a - conv_b) <= SUM_PRODUCT_LANES, (a, b)


def test_degeneracy_count_matches_the_jax_engine():
    trials, p, ms = 200, 0.050119, dict(max_iter=50, method="min-sum")
    got = degeneracy_count.run(trials, p, device="cpu", bp=BPConfig(**ms))
    for name in BB_CODE_NAMES:
        for label, osd in (("bp", None), ("bposd", JaxOSDConfig(order=0))):
            cfg = JaxEngineConfig(bp=JaxBPConfig(**ms), osd=osd, batch_size=1000)
            ref = jax_counters_to_dict(JaxEngine(get_code(name), cfg, mesh=make_mesh(1))
                                       .run_rate(p, trials=trials, seed=7))
            mine = got[name, label]
            assert mine["trials"] == trials
            for k in ref:
                np.testing.assert_array_equal(mine[k], np.asarray(ref[k]), err_msg=f"{name} {label} {k}")


def test_degeneracy_count_table(capsys):
    degeneracy_count.main(["--device", "cpu", "--trials", "100"])
    rows = capsys.readouterr().out.splitlines()
    assert rows[0] == "p = 0.050119, trials = 100"
    table = {r[:18].strip(): [float(x) for x in r[18:].split()] for r in rows[2:]}
    assert list(table) == list(BB_CODE_NAMES)
    for bp_only, bposd, degenerate in table.values():
        # every rate is a count over 100 trials
        assert all(math.isclose(x * 100, round(x * 100)) for x in (bp_only, bposd, degenerate))
        assert 0 <= bposd <= 1 and 0 <= degenerate <= 1


@pytest.mark.parametrize("module", [quickstart, noise_models, degeneracy_count])
def test_examples_run_on_the_card_unless_asked(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
