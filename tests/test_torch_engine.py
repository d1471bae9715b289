"""The port's Monte-Carlo engine against the JAX engine: identical counters.

Both engines key batch b of rate p with fold_in(fold_in(key(seed),
hash(p) % 2**31), b), so they draw the same errors; every counter, the four
residual-weight histograms included, must then agree exactly. The JAX engine
runs on a one-device mesh (the OSD capacity is per shard there) with its XLA
BP path; the port runs its plain torch path on the CPU.

The configurations keep BP bit-identical between the two packages: min-sum
without alpha is exact arithmetic, and the sum-product cases are ones where
the last-ulp differences of XLA's own tanh/atanh (see test_torch_bp.py) do
not reach a decision. The error rates are ones where XLA's float32 log
gives the same prior as torch's (checked below).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code
from qldpc_tpu.decoders import BPConfig
from qldpc_tpu.decoders.osd import OSDConfig
from qldpc_tpu.mc import EngineConfig as JaxEngineConfig
from qldpc_tpu.mc import MonteCarloEngine as JaxEngine
from qldpc_tpu.mc import counters_to_dict as jax_counters_to_dict
from qldpc_tpu.noise.channels import uniform_prior_llr as jax_prior
from qldpc_tpu.parallel import make_mesh
from qldpc_tpu_torch.codes import get_code as port_code
from qldpc_tpu_torch.convert import code_from_reference, engine_config_from_reference
from qldpc_tpu_torch.decoders import BPConfig as PortBPConfig
from qldpc_tpu_torch.decoders import OSDConfig as PortOSDConfig
from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine, counters_to_dict
from qldpc_tpu_torch.noise.channels import uniform_prior_llr

torch.set_num_threads(2)

SP64 = BPConfig(max_iter=20, dtype="float64")
SP32 = BPConfig(max_iter=20)
MS64 = BPConfig(max_iter=30, method="min-sum", dtype="float64")
MS32 = BPConfig(max_iter=30, method="min-sum")

CASES = {
    "steane-sp64-osd": ("steane", dict(bp=SP64), 0.05),
    "steane-sp32-osd": ("steane", dict(bp=SP32), 0.06),
    "72-ms32-osd": ("[[72, 12, 6]]", dict(bp=MS32), 0.05),
    "72-ms64-osd-overflow": ("[[72, 12, 6]]", dict(bp=MS64, osd_fraction=0.5), 0.12),
    "72-sp64-bp-only": ("[[72, 12, 6]]", dict(bp=BPConfig(max_iter=30, dtype="float64"), osd=None), 0.04),
    "72-ms32-bp-only": ("[[72, 12, 6]]", dict(bp=MS32, osd=None), 0.05),
    "steane-sp64-doubled": ("steane", dict(bp=SP64, channel="doubled"), 0.05),
    "72-ms32-doubled": ("[[72, 12, 6]]", dict(bp=MS32, channel="doubled"), 0.03),
    "72-ms64-phenomenological": (
        "[[72, 12, 6]]",
        dict(bp=MS64, channel="phenomenological", syndrome_flip_rate=0.01),
        0.03,
    ),
    "72-ms32-basis-z": ("[[72, 12, 6]]", dict(bp=MS32, basis="z"), 0.05),
}


@pytest.mark.parametrize("p", sorted({p for _, _, p in CASES.values()}))
def test_priors_agree_at_the_tested_rates(p):
    ref = np.asarray(jax_prior(4, jnp.float32(p)))
    assert np.array_equal(uniform_prior_llr(4, p).numpy(), ref)


@pytest.mark.parametrize("case", list(CASES))
def test_counters_identical_to_jax_engine(case):
    code_name, kw, p = CASES[case]
    code = get_code(code_name)
    ref_cfg = JaxEngineConfig(**{"osd": OSDConfig(order=0), "batch_size": 128, **kw})
    ref = jax_counters_to_dict(
        JaxEngine(code, ref_cfg, mesh=make_mesh(1)).run_rate(p, trials=300, seed=3)
    )
    port = MonteCarloEngine(code_from_reference(code), engine_config_from_reference(ref_cfg),
                            device="cpu")
    got = counters_to_dict(port.run_rate(p, trials=300, seed=3))
    assert got["trials"] == 300
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    if kw.get("osd_fraction", 1.0) < 1.0:
        assert got["osd_overflow"] > 0


def test_sweep_matches_per_rate_runs():
    code = port_code("steane")
    cfg = EngineConfig(bp=PortBPConfig(max_iter=20), batch_size=64)
    eng = MonteCarloEngine(code, cfg, device="cpu")
    res = eng.sweep([0.03, 0.06], trials=100, seed=4)
    assert res.error_rates == [0.03, 0.06]
    for i, p in enumerate(res.error_rates):
        d = counters_to_dict(eng.run_rate(p, trials=100, seed=4 + i))
        for k in d:
            np.testing.assert_array_equal(res.per_rate[i][k], d[k], err_msg=k)
    assert res.curve("trials").tolist() == [100, 100]


@pytest.mark.parametrize("with_osd", [False, True])
def test_stage_times_cover_every_stage_of_a_batch(with_osd):
    """stage_times runs a batch stage by stage on the CPU: four finite,
    non-negative wall times, and the engine's counters are unchanged."""
    cfg = EngineConfig(bp=PortBPConfig(max_iter=20), osd=PortOSDConfig(order=0) if with_osd else None,
                       batch_size=64)
    eng = MonteCarloEngine(port_code("steane"), cfg, device="cpu")
    before = counters_to_dict(eng.run_rate(0.05, 128, seed=2))
    st = eng.stage_times(0.05, reps=2)
    assert list(st) == ["sample", "bp", "osd", "classify"]
    assert all(np.isfinite(v) and v >= 0 for v in st.values())
    after = counters_to_dict(eng.run_rate(0.05, 128, seed=2))
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)


def test_config_conversion_and_out_of_slice_features():
    ref = JaxEngineConfig(
        bp=BPConfig(max_iter=9, backend="pallas"),
        osd=OSDConfig(order=0, backend="pallas", batch_tile=64),
        batch_size=256, osd_tiers=(4,), fused_dispatch=False,
    )
    got = engine_config_from_reference(ref)
    assert got.batch_size == 256 and got.bp.max_iter == 9 and got.osd.order == 0
    # rescue_iters is ported now and carries over; its tiers are dropped
    rescue = engine_config_from_reference(JaxEngineConfig(rescue_iters=10, rescue_tiers=(8,)))
    assert rescue.rescue_iters == 10
    # OSD-e is ported now: its fields carry over, batch_tile is dropped
    osde = engine_config_from_reference(JaxEngineConfig(
        osd=OSDConfig(order=3, max_combinations=50, extra_positions=4, chunk=8)))
    assert osde.osd == PortOSDConfig(order=3, max_combinations=50, extra_positions=4, chunk=8)
    # the space-time channel is ported now: its round count carries over
    st = engine_config_from_reference(JaxEngineConfig(channel="space-time", n_rounds=4))
    assert st.channel == "space-time" and st.n_rounds == 4
    with pytest.raises(NotImplementedError, match="one process per device"):
        MonteCarloEngine(port_code("steane"), EngineConfig(), device=["cpu", "cpu"])


def _pair(code_name, **kw):
    code = get_code(code_name)
    ref_cfg = JaxEngineConfig(**{"osd": OSDConfig(order=0), "batch_size": 64, **kw})
    return (JaxEngine(code, ref_cfg, mesh=make_mesh(1)),
            MonteCarloEngine(code_from_reference(code), engine_config_from_reference(ref_cfg),
                             device="cpu"))


def _dicts(counters_a, counters_b):
    a = jax_counters_to_dict(counters_a)
    return {k: np.asarray(v) for k, v in a.items()}, counters_to_dict(counters_b)


def test_run_rate_options_match_jax_engine():
    """start_batch, init, on_batch and a per-rate alpha give the JAX
    engine's counters. With alpha the message sums round in each package's
    order; at p = 0.03 no OSD near-tie is broken another way (at p = 0.05 a
    few are: ROADMAP.md, Queue 3)."""
    jax_eng, port = _pair("[[72, 12, 6]]", bp=MS32)
    p, trials, seed = 0.03, 200, 6
    ref_seen, seen = [], []
    ref = jax_eng.run_rate(p, trials, seed=seed, alpha=0.75,
                           on_batch=lambda b, nb, c: ref_seen.append((b, nb, c)))
    got = port.run_rate(p, trials, seed=seed, alpha=0.75,
                        on_batch=lambda b, nb, c: seen.append((b, nb, c)))
    assert [x[:2] for x in seen] == [x[:2] for x in ref_seen] == [(b, 4) for b in range(4)]
    for (_, _, r), (_, _, g) in zip(ref_seen, seen):
        a, b = _dicts(r, g)
        assert all(np.array_equal(a[k], b[k]) for k in a)
    a, b = _dicts(ref, got)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    # alpha changes the decoding (it is not ignored) ...
    plain = counters_to_dict(port.run_rate(p, trials, seed=seed))
    assert plain["average_iterations"] != b["average_iterations"]
    # ... and a resumed run from the JAX engine's counters after batch 1
    init = jax_eng.run_rate(p, 128, seed=seed, alpha=0.75)
    resumed = port.run_rate(p, trials, seed=seed, alpha=0.75, start_batch=2,
                            init=type(got)(*(torch.from_numpy(np.asarray(x, np.int64))
                                             for x in init)))
    a, b = _dicts(ref, resumed)
    assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", ["72-ms32-osd", "72-sp64-bp-only", "steane-st-ms32"])
def test_rescue_iters_match_a_single_run_and_jax(case):
    """BP(rescue_iters) on the batch then BP(max_iter) on its failures alone
    gives a single long run's counters, and the JAX engine's rescue run's."""
    if case == "steane-st-ms32":
        code_name, kw, p = "steane", dict(bp=MS32, channel="space-time", n_rounds=2), 0.03
    else:
        code_name, kw, p = CASES[case]
    jax_eng, port = _pair(code_name, rescue_iters=3, **kw)
    assert port.bp_short is not None and port.bp_short.config.max_iter == 3
    single = MonteCarloEngine(port.code, dataclasses.replace(port.config, rescue_iters=0),
                              device="cpu")
    assert single.bp_short is None
    got = counters_to_dict(port.run_rate(p, 300, seed=2))
    ref = counters_to_dict(single.run_rate(p, 300, seed=2))
    jax_ref = {k: np.asarray(v) for k, v in
               jax_counters_to_dict(jax_eng.run_rate(p, 300, seed=2)).items()}
    assert got["BPs_fault"] > 0 and got["average_iterations"] > 3 * got["BPs_fault"] / 300
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        np.testing.assert_array_equal(got[k], jax_ref[k], err_msg=k)
