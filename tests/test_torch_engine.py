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
from qldpc_tpu_torch.convert import engine_config_from_reference
from qldpc_tpu_torch.decoders import BPConfig as PortBPConfig
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
    port = MonteCarloEngine(code, engine_config_from_reference(ref_cfg), device="cpu")
    got = counters_to_dict(port.run_rate(p, trials=300, seed=3))
    assert got["trials"] == 300
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    if kw.get("osd_fraction", 1.0) < 1.0:
        assert got["osd_overflow"] > 0


def test_sweep_matches_per_rate_runs():
    code = get_code("steane")
    cfg = EngineConfig(bp=PortBPConfig(max_iter=20), batch_size=64)
    eng = MonteCarloEngine(code, cfg, device="cpu")
    res = eng.sweep([0.03, 0.06], trials=100, seed=4)
    assert res.error_rates == [0.03, 0.06]
    for i, p in enumerate(res.error_rates):
        d = counters_to_dict(eng.run_rate(p, trials=100, seed=4 + i))
        for k in d:
            np.testing.assert_array_equal(res.per_rate[i][k], d[k], err_msg=k)
    assert res.curve("trials").tolist() == [100, 100]


def test_config_conversion_and_out_of_slice_features():
    ref = JaxEngineConfig(
        bp=BPConfig(max_iter=9, backend="pallas"),
        osd=OSDConfig(order=0, backend="pallas", batch_tile=64),
        batch_size=256, osd_tiers=(4,), fused_dispatch=False,
    )
    got = engine_config_from_reference(ref)
    assert got.batch_size == 256 and got.bp.max_iter == 9 and got.osd.order == 0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine_config_from_reference(JaxEngineConfig(rescue_iters=10))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine_config_from_reference(JaxEngineConfig(osd=OSDConfig(order=3)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine_config_from_reference(JaxEngineConfig(channel="space-time"))
    eng = MonteCarloEngine(get_code("steane"), EngineConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.sweep([0.01], trials=8, checkpoint=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MonteCarloEngine(get_code("steane"), EngineConfig(), device=["cpu", "cpu"])
