"""The port's layered (check-serial) BP against the JAX package and the oracle.

Inputs come from numpy seeds. The JAX side runs its XLA layered path
(``BPDecoder._build_layered``) and ``PallasBPKernel(schedule="layered")`` in
interpret mode; the port runs ``bp_layered_plain`` (the CPU path of
``BPDecoder`` with ``schedule="layered"``).

Tolerances and why:
  * float64 against tests/oracles.py::bp_layered: converged, iterations and
    hard decisions exact on every sample; posteriors within 1e-6, as
    tests/test_bp.py holds the JAX layered path (the oracle divides the row
    product by each message and sums a layer's deltas before adding them);
  * float32 against the XLA path: decisions exact on every lane, and
    min-sum posteriors bit-identical (exact arithmetic, and the deltas of a
    variable's edges in one layer are added in ascending edge order, the
    order of XLA's scatter-add); sum-product is held to its decisions, as
    the flooding tests hold float32: XLA's CPU tanh/atanh differ from
    torch's in the last ulp, and near the atanh clip (8.3) an ulp of the
    product moves a message by up to 0.35, so posteriors drift apart by up
    to 1.5 within 25 iterations while every decision agrees;
  * float32 against the Pallas kernel, which forms each leave-one-out
    product directly and sums a layer's deltas in one-hot matmuls: at most
    2 lanes in 256 may differ in decision, as the flooding tests allow;
  * engine counters against the JAX engine: identical, on configurations
    where BP is bit-exact (min-sum float32, sum-product float64).
"""

import numpy as np
import pytest
import torch

import oracles
from qldpc_tpu.codes import get_code
from qldpc_tpu.decoders import BPConfig as JaxBPConfig
from qldpc_tpu.decoders import BPDecoder as JaxBPDecoder
from qldpc_tpu.decoders.osd import OSDConfig as JaxOSDConfig
from qldpc_tpu.mc import EngineConfig as JaxEngineConfig
from qldpc_tpu.mc import MonteCarloEngine as JaxEngine
from qldpc_tpu.mc import counters_to_dict as jax_counters_to_dict
from qldpc_tpu.parallel import make_mesh
from qldpc_tpu_torch.convert import code_from_reference, engine_config_from_reference
from qldpc_tpu_torch.decoders import BPConfig, BPDecoder
from qldpc_tpu_torch.mc import MonteCarloEngine, counters_to_dict
from qldpc_tpu_torch.ops.bp_layered_cuda import bp_layered, bp_layered_plain, layer_count

torch.set_num_threads(2)


def _batch(rng, code_name, p, B):
    code = get_code(code_name)
    H = code.Hx
    errors = (rng.random((B, code.n)) < p).astype(np.int8)
    syn = ((errors @ H.T) % 2).astype(np.int8)
    return H, syn, np.full(code.n, np.log((1 - p) / p))


def _port(H, syn, prior, **cfg):
    dec = BPDecoder(H, BPConfig(schedule="layered", **cfg))
    return dec(torch.from_numpy(syn), torch.from_numpy(prior))


OSD_FREE = {
    "sum-product": dict(method="sum-product"),
    "min-sum": dict(method="min-sum"),
    "ms-offset-clip": dict(method="min-sum", alpha=0.8, offset=0.2, clip_llr=25.0),
    "sp-alpha-clip": dict(method="sum-product", alpha=0.9, clip_llr=20.0),
}


@pytest.mark.parametrize("code_name,L", [("steane", 3), ("[[72, 12, 6]]", 4), ("[[72, 12, 6]]", 2)])
@pytest.mark.parametrize("config", list(OSD_FREE))
def test_float64_matches_oracle(rng, code_name, L, config):
    kw = OSD_FREE[config]
    H, syn, prior = _batch(rng, code_name, 0.05, 48)
    res = _port(H, syn, prior, max_iter=20, n_layers=L, dtype="float64", **kw)
    assert res.llrs.dtype == torch.float64
    for i in range(len(syn)):
        hard, conv, llrs, iters = oracles.bp_layered(H, syn[i], prior, max_iter=20, n_layers=L, **kw)
        assert bool(res.converged[i]) == conv, f"sample {i}"
        assert int(res.iterations[i]) == iters, f"sample {i}"
        assert np.array_equal(res.hard[i].numpy(), hard), f"sample {i}"
        np.testing.assert_allclose(res.llrs[i].numpy(), llrs, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_float32_matches_xla_and_pallas(rng, method):
    H, syn, prior = _batch(rng, "[[72, 12, 6]]", 0.05, 256)
    prior = prior.astype(np.float32)
    kw = dict(max_iter=25, method=method, schedule="layered")
    res = _port(H, syn, prior, max_iter=25, method=method)
    xla = JaxBPDecoder(H, JaxBPConfig(**kw))(syn, prior)
    got = (res.converged.numpy(), res.iterations.numpy(), res.hard.numpy())
    for g, r in zip(got, (xla.converged, xla.iterations, xla.hard)):
        assert np.array_equal(g, np.asarray(r))
    if method == "min-sum":
        assert np.array_equal(res.llrs.numpy(), np.asarray(xla.llrs))
    pal = JaxBPDecoder(H, JaxBPConfig(backend="pallas", batch_tile=128, **kw))(syn, prior)
    differ = ((got[0] != np.asarray(pal.converged)) | (got[1] != np.asarray(pal.iterations))
              | (got[2] != np.asarray(pal.hard)).any(1))
    assert int(differ.sum()) <= 2, f"{int(differ.sum())} of 256 lanes differ from the Pallas kernel"


def test_layer_count_rule():
    assert layer_count(72) == 4 and layer_count(36) == 4 and layer_count(3) == 3
    assert layer_count(6) == 3 and layer_count(10) == 2 and layer_count(7) == 1
    assert layer_count(72, 3) == 3
    with pytest.raises(ValueError, match="must divide"):
        layer_count(72, 5)
    H = get_code("[[72, 12, 6]]").Hx  # m = 36
    with pytest.raises(ValueError, match="must divide"):
        BPDecoder(H, BPConfig(schedule="layered", n_layers=5))
    with pytest.raises(ValueError, match="damping"):
        BPConfig(schedule="layered", damping=0.7)
    with pytest.raises(ValueError, match="n_layers"):
        BPConfig(schedule="layered", n_layers=-1)
    irregular = np.array([[1, 1, 0], [0, 1, 1], [1, 1, 1]], np.uint8)
    with pytest.raises(ValueError, match="check-regular"):
        BPDecoder(irregular, BPConfig(schedule="layered"))


def test_auto_layers_equal_explicit_layers(rng):
    H, syn, prior = _batch(rng, "[[72, 12, 6]]", 0.05, 64)
    auto = _port(H, syn, prior.astype(np.float32), max_iter=15)
    four = _port(H, syn, prior.astype(np.float32), max_iter=15, n_layers=4)
    one = _port(H, syn, prior.astype(np.float32), max_iter=15, n_layers=1)
    assert torch.equal(auto.llrs, four.llrs) and torch.equal(auto.iterations, four.iterations)
    assert not torch.equal(auto.llrs, one.llrs)  # the schedule matters


def test_converged_hard_reproduces_syndrome_and_entry_point(rng):
    H, syn, prior = _batch(rng, "[[72, 12, 6]]", 0.04, 128)
    res = _port(H, syn, prior.astype(np.float32), max_iter=50)
    conv = res.converged.numpy()
    assert conv.sum() > 64
    s_hat = (res.hard.numpy().astype(np.int64) @ H.T) % 2
    assert np.array_equal(s_hat[conv], syn[conv])
    dec = BPDecoder(H, BPConfig(schedule="layered", max_iter=50))
    direct = bp_layered_plain(torch.from_numpy(syn), torch.from_numpy(prior.astype(np.float32)),
                              dec.tables(), dec.config)
    assert torch.equal(direct[0], res.llrs)
    meta = torch.zeros((1, 36), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bp_layered(meta, meta[0], dec.tables(), dec.config)


ENGINE_CASES = {  # code, OSD-0 on, BP config, p
    "72-ms32-layered": ("[[72, 12, 6]]", True, dict(max_iter=30, method="min-sum"), 0.05),
    "steane-sp64-layered": ("steane", True, dict(max_iter=20, dtype="float64"), 0.05),
    "72-ms32-layered3-bp-only": ("[[72, 12, 6]]", False,
                                 dict(max_iter=30, method="min-sum", n_layers=3), 0.04),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_layered_engine_counters_identical_to_jax_engine(case):
    code_name, with_osd, bp, p = ENGINE_CASES[case]
    code = get_code(code_name)
    ref_cfg = JaxEngineConfig(
        bp=JaxBPConfig(schedule="layered", **bp),
        osd=JaxOSDConfig(order=0) if with_osd else None, batch_size=128,
    )
    ref = jax_counters_to_dict(
        JaxEngine(code, ref_cfg, mesh=make_mesh(1)).run_rate(p, trials=300, seed=3)
    )
    port_cfg = engine_config_from_reference(ref_cfg)
    assert port_cfg.bp.schedule == "layered" and port_cfg.bp.n_layers == bp.get("n_layers", 0)
    got = counters_to_dict(MonteCarloEngine(code_from_reference(code), port_cfg, device="cpu")
                           .run_rate(p, trials=300, seed=3))
    assert got["trials"] == 300
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
