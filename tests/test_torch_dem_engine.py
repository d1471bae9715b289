"""The port's DEM engine against the JAX DEM engine: identical counters.

Both engines key batch b of rate p with fold_in(fold_in(key(seed),
hash(p) % 2**31), b) and draw one uniform per mechanism with the same global
sample ids, so they fire the same mechanisms. With min-sum BP without alpha,
which is exact arithmetic, every counter and histogram must then agree. The
JAX engine runs on a one-device mesh with its XLA BP path and its
transform OSD; the port runs its plain torch paths on the CPU.

With bf16 streams the JAX engine runs its Pallas DEM kernel (interpret
mode here) and the port its plain torch path in bf16: min-sum stays exact
arithmetic after the same roundings, so the counters are identical too.

The parametric priors are float32 closed forms through exp and log, whose
XLA CPU versions differ from torch's in the last bit at some rates (ROADMAP
Queue 3); the tested rates are ones where the priors agree bit for bit,
checked below.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code
from qldpc_tpu.decoders import BPConfig
from qldpc_tpu.decoders.osd import OSDConfig
from qldpc_tpu.mc import DEMEngine as JaxDEMEngine
from qldpc_tpu.mc import DEMEngineConfig as JaxDEMEngineConfig
from qldpc_tpu.noise.circuit import memory_experiment_dem, parametric_memory_dem
from qldpc_tpu.parallel import make_mesh
from qldpc_tpu_torch.convert import dem_engine_config_from_reference, dem_from_reference
from qldpc_tpu_torch.mc import DEMEngine, DEMEngineConfig, EngineConfig
from qldpc_tpu_torch.noise.dem import DEMData

torch.set_num_threads(2)

RATES = (0.005, 0.006)
MS = BPConfig(max_iter=30, method="min-sum")


@pytest.fixture(scope="module")
def steane_parametric():
    return parametric_memory_dem(get_code("steane"), basis="z", rounds=3)


def _engines(dem, **kw):
    cfg = JaxDEMEngineConfig(**{"bp": MS, "osd": OSDConfig(order=0), "batch_size": 256, **kw})
    jax_eng = JaxDEMEngine(dem, cfg, mesh=make_mesh(1))
    port = DEMEngine(dem_from_reference(dem), dem_engine_config_from_reference(cfg), device="cpu")
    return jax_eng, port


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("p", RATES)
def test_priors_agree_at_the_tested_rates(steane_parametric, p):
    jax_eng, port = _engines(steane_parametric)
    q, llr = jax_eng._priors(jnp.float32(p))
    pq, pllr = port.priors(p)
    assert pq.dtype == pllr.dtype == torch.float32
    assert np.array_equal(np.asarray(q), pq.numpy())
    assert np.array_equal(np.asarray(llr), pllr.numpy())


@pytest.mark.parametrize("p", RATES)
def test_parametric_counters_match_jax(steane_parametric, p):
    jax_eng, port = _engines(steane_parametric)
    ref = jax_eng.run(shots=768, seed=3, p=p)
    got = port.run(shots=768, seed=3, p=p)
    assert got["BPs_fault"] > 0 and got["residual_logicals"] > 0
    assert got["BPs_miscorrected"] == 0  # distance 0: all incorrectable
    assert _same(got, ref), [k for k in ref if not np.array_equal(got[k], ref[k])]


def test_fixed_prior_dem_counters_match_jax():
    dem = memory_experiment_dem(get_code("steane"), p=0.008, rounds=3)
    jax_eng, port = _engines(dem, osd_fraction=0.25)
    ref = jax_eng.run(shots=512, seed=5)
    got = port.run(shots=512, seed=5)
    assert _same(got, ref), [k for k in ref if not np.array_equal(got[k], ref[k])]


def test_bp_only_and_sweep(steane_parametric):
    jax_eng, port = _engines(steane_parametric, osd=None)
    ref = jax_eng.run(shots=256, seed=0, p=RATES[0])
    res = port.sweep([RATES[0]], trials=256, seed=0)
    assert res.code_name == "dem" and res.error_rates == [RATES[0]]
    assert _same(res.per_rate[0], ref)


def test_sampling_and_syndrome(steane_parametric):
    dem = dem_from_reference(steane_parametric)
    port = DEMEngine(dem, DEMEngineConfig(bp=MS, batch_size=64), device="cpu")
    from qldpc_tpu_torch.utils import rng

    errors, syn, llr = port._sample(rng.key(1), RATES[0])
    assert errors.shape == (64, dem.H.shape[1]) and errors.dtype == torch.int8
    e = errors.numpy().astype(np.int64)
    assert np.array_equal(syn.numpy(), (e @ dem.H.T) % 2)
    assert torch.equal(llr, port.priors(RATES[0])[1])


def test_config_and_guards(steane_parametric):
    with pytest.raises(ValueError, match="unknown channel"):
        EngineConfig(channel="dem")  # only the DEM engine takes it
    with pytest.raises(ValueError, match="unknown channel"):
        DEMEngineConfig(channel="code-capacity")
    dem = dem_from_reference(steane_parametric)
    port = DEMEngine(dem, EngineConfig(bp=MS, batch_size=32), device="cpu")
    assert isinstance(port.config, DEMEngineConfig) and port.config.bp == MS
    with pytest.raises(ValueError, match="physical rate"):
        port.run(shots=32)
    with pytest.raises(ValueError, match="counter space"):
        DEMEngine(dem, DEMEngineConfig(batch_size=2**25), device="cpu")
    fixed = DEMData(H=dem.H, L=dem.L, priors=dem.priors_at(0.01))
    q, _ = DEMEngine(fixed, DEMEngineConfig(batch_size=8), device="cpu").priors(0.5)
    assert torch.equal(q, torch.tensor(fixed.priors, dtype=torch.float32))


def test_dem_engine_config_conversion():
    ref = JaxDEMEngineConfig(
        bp=BPConfig(max_iter=50, backend="pallas"), osd=OSDConfig(order=0),
        batch_size=1024, osd_tiers=(64, 256), fused_dispatch=True,
    )
    got = dem_engine_config_from_reference(ref)
    assert isinstance(got, DEMEngineConfig) and got.channel == "dem"
    assert got.batch_size == 1024 and got.bp.max_iter == 50 and got.osd.order == 0
    # the bf16 streams carry over
    got = dem_engine_config_from_reference(
        JaxDEMEngineConfig(bp=BPConfig(backend="pallas", stream_dtype="bfloat16"))
    )
    assert got.bp.stream_dtype == "bfloat16" and got.bp.mm_dtype == "float32"
    # rescue_iters is ported now and carries over
    assert dem_engine_config_from_reference(JaxDEMEngineConfig(rescue_iters=10)).rescue_iters == 10


def test_rescue_iters_match_a_single_run_and_jax(steane_parametric):
    """The DEM engine's rescue decoding: a single long run's counters and the
    JAX DEM engine's rescue run's."""
    jax_eng, port = _engines(steane_parametric, rescue_iters=4)
    assert port.bp_short is not None
    single = DEMEngine(port.dem, dataclasses.replace(port.config, rescue_iters=0), device="cpu")
    got = port.run(shots=512, seed=2, p=RATES[1])
    assert got["BPs_fault"] > 0
    assert _same(got, single.run(shots=512, seed=2, p=RATES[1]))
    assert _same(got, jax_eng.run(shots=512, seed=2, p=RATES[1]))


@pytest.mark.parametrize("p", RATES)
def test_bf16_stream_counters_match_jax(steane_parametric, p):
    bf16 = dataclasses.replace(MS, backend="pallas", stream_dtype="bfloat16")
    jax_eng, port = _engines(steane_parametric, bp=bf16)
    assert port.config.bp.stream_dtype == "bfloat16"
    ref = jax_eng.run(shots=512, seed=3, p=p)
    got = port.run(shots=512, seed=3, p=p)
    assert got["BPs_fault"] > 0 and got["residual_logicals"] > 0
    assert _same(got, ref), [k for k in ref if not np.array_equal(got[k], ref[k])]
    # the streams change the result: the float32 engine's counters differ
    f32 = DEMEngine(port.dem, dataclasses.replace(
        port.config, bp=dataclasses.replace(port.config.bp, stream_dtype="float32")),
        device="cpu")
    assert not _same(got, f32.run(shots=512, seed=3, p=p))
