"""The port's space-time engine and its OSD-0 on H_st against the JAX package.

Both engines key batch b of rate p as fold_in(fold_in(key(seed), hash(p) %
2**31), b) and draw sample i's T*n data and T*m measurement uniforms from one
counter stream, so they sample the same errors and detectors; every counter,
the residual-weight histograms included, must then agree exactly. The JAX
engine runs on a one-device mesh with its XLA structured decoder and its
``lanes`` OSD; the port runs its plain torch path on the CPU.

The configurations keep BP bit-identical between the packages: min-sum
without alpha is exact arithmetic, and the sum-product cases are ones where
the last-ulp differences of XLA's tanh/atanh (see test_torch_spacetime.py)
reach no decision. The rates are ones where XLA's float32 log gives the
port's priors (test_torch_spacetime.py::test_priors_agree_at_the_tested_rates).
Sum-product on Steane is left out: its BP decisions agree, but its symmetric
graph leaves many |LLR| ties that the last-ulp differences break another
way in OSD's stable sort, so one or two OSD outcomes in 256 trials differ at
every rate and T tried (ROADMAP.md, Queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code
from qldpc_tpu.decoders import BPConfig
from qldpc_tpu.decoders.osd import OSDConfig
from qldpc_tpu.decoders.osd import OSDDecoder as JaxOSDDecoder
from qldpc_tpu.mc import EngineConfig as JaxEngineConfig
from qldpc_tpu.mc import MonteCarloEngine as JaxEngine
from qldpc_tpu.mc import counters_to_dict as jax_counters_to_dict
from qldpc_tpu.noise import spacetime as jst
from qldpc_tpu.parallel import make_mesh
from qldpc_tpu_torch.codes import get_code as port_code
from qldpc_tpu_torch.convert import code_from_reference, engine_config_from_reference
from qldpc_tpu_torch.decoders import BPConfig as PortBPConfig
from qldpc_tpu_torch.decoders import OSDDecoder
from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine, counters_to_dict
from qldpc_tpu_torch.noise.spacetime import space_time_matrix

torch.set_num_threads(2)

MS = BPConfig(max_iter=30, method="min-sum")
SP = BPConfig(max_iter=20)
CASES = {
    "steane-ms-T-default": ("steane", dict(bp=MS), 0.03),
    "72-sp-T2": ("[[72, 12, 6]]", dict(bp=SP, n_rounds=2), 0.03),
    "72-ms-T3": ("[[72, 12, 6]]", dict(bp=MS, n_rounds=3), 0.02),
    "72-sp-T3-q": ("[[72, 12, 6]]", dict(bp=SP, n_rounds=3, syndrome_flip_rate=0.01), 0.02),
    "72-ms-T2-bp-only": ("[[72, 12, 6]]", dict(bp=MS, n_rounds=2, osd=None), 0.03),
}


@pytest.mark.parametrize("case", list(CASES))
def test_counters_identical_to_jax_engine(case):
    code_name, kw, p = CASES[case]
    code = get_code(code_name)
    ref_cfg = JaxEngineConfig(**{"osd": OSDConfig(order=0), "batch_size": 128,
                                 "channel": "space-time", **kw})
    ref = jax_counters_to_dict(
        JaxEngine(code, ref_cfg, mesh=make_mesh(1)).run_rate(p, trials=256, seed=5)
    )
    port_cfg = engine_config_from_reference(ref_cfg)
    assert port_cfg.channel == "space-time" and port_cfg.n_rounds == kw.get("n_rounds", 0)
    port = MonteCarloEngine(code_from_reference(code), port_cfg, device="cpu")
    assert port.n_rounds == (kw.get("n_rounds") or code.distance)
    got = counters_to_dict(port.run_rate(p, trials=256, seed=5))
    assert got["trials"] == 256 and got["BPs_fault"] > 0
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


def test_osd_on_the_144_space_time_matrix_takes_the_transform_elimination():
    """H_st of [[144,12,12]] at T = 12 is 864 x 2,592: narrow by its words,
    but one sample's packed rows (287 KB) overflow K2's warp, so OSD-0 takes
    the transform elimination, and its solutions are the JAX lanes path's."""
    H = get_code("[[144, 12, 12]]").Hx
    Hst = space_time_matrix(H, 12)
    assert Hst.shape == (864, 2592)
    osd = OSDDecoder(Hst)
    assert not osd.wide and osd.elimination == "transform" and osd.h_rank == 864
    rng = np.random.default_rng(11)
    B = 8
    e = (rng.random((B, 2592)) < 0.01).astype(np.int64)
    syn = ((e @ Hst.T) % 2).astype(np.int8)
    llrs = (rng.normal(4.0, 3.0, (B, 2592))).astype(np.float32)
    hard = (llrs < 0).astype(np.int8)
    ref = JaxOSDDecoder(Hst, OSDConfig(order=0, backend="lanes"))(syn, llrs, hard)
    got = osd(torch.from_numpy(syn), torch.from_numpy(llrs), torch.from_numpy(hard))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    # full row rank: every solution reproduces its syndrome
    assert np.array_equal((got.numpy().astype(np.int64) @ Hst.T) % 2, syn)


def test_engine_refuses_layered_space_time_and_builds_its_matrix():
    with pytest.raises(ValueError, match="check-regular"):
        EngineConfig(channel="space-time", bp=PortBPConfig(schedule="layered"))
    with pytest.raises(ValueError, match="n_rounds"):
        EngineConfig(channel="space-time", n_rounds=-1)
    eng = MonteCarloEngine(port_code("[[72, 12, 6]]"),
                           EngineConfig(channel="space-time", n_rounds=2, batch_size=8),
                           device="cpu")
    assert (eng.m_checks, eng.n_vars, eng.n_qubits) == (72, 216, 72)
    assert eng.osd.elimination == "rows" and eng.bp.T == 2
    assert np.array_equal(eng._Hf.numpy(), jst.space_time_matrix(get_code("[[72, 12, 6]]").Hx, 2))
    assert int(eng.run_rate(0.01, 8).trials) == 8


def test_priors_follow_the_measurement_rate():
    eng = MonteCarloEngine(port_code("steane"),
                           EngineConfig(channel="space-time", n_rounds=2,
                                        syndrome_flip_rate=0.01, batch_size=4),
                           device="cpu")
    _, _, priors = eng._sample(torch.tensor([0, 7]), 0.02)
    ref = np.asarray(jst.space_time_prior_llr(7, 3, 2, jnp.float32(0.02), q=jnp.float32(0.01)))
    assert np.array_equal(priors.numpy(), ref)


def test_288_space_time_engine_equals_the_recorded_jax_counters():
    """[[288,12,18]] space-time at T = 18 (H_st 2,592 x 7,776), BP(100)
    min-sum + OSD-0, batch 32, p = 0.008, 128 trials, seed 1: the port's CPU
    engine counts exactly what the JAX engine counted
    (results/jax_counters_st288_min_sum.jsonl, from ``python3
    scripts/jax_reference_counters.py --only st288-min-sum``: 651 s of XLA,
    too long to run here). Its OSD-0 takes the factored elimination and the
    transform past the column budget, as every JAX sample is solved."""
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "results" / "jax_counters_st288_min_sum.jsonl"
    row = json.loads(path.read_text().splitlines()[0])
    ref = row["counters"]
    assert (row["p"], row["trials"], row["seed"]) == (0.008, 128, 1)
    eng = MonteCarloEngine(
        port_code("[[288, 12, 18]]"),
        EngineConfig(bp=PortBPConfig(max_iter=100, method="min-sum"), channel="space-time",
                     n_rounds=18, batch_size=32),
        device="cpu")
    assert eng.osd.elimination == "factored+transform"
    got = counters_to_dict(eng.run_rate(0.008, 128, seed=1))
    for k, v in ref.items():
        if isinstance(v, dict):
            hist = {int(i): int(c) for i, c in enumerate(np.asarray(got[k])) if c}
            assert hist == {int(i): c for i, c in v.items()}, k
        else:
            assert got[k] == v, k
    assert ref["BPs_fault"] == 29
