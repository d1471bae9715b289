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
from qldpc_tpu_torch.ops.bp_cuda import check_rule
from qldpc_tpu_torch.ops.bp_layered_cuda import (
    LayeredTables,
    bp_layered,
    bp_layered_plain,
    layer_count,
    layer_tables,
)

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


def _layered_from_tables(syn, priors, tables: LayeredTables, cfg):
    """K7's schedule in plain torch: per layer the check rule, then the
    posteriors of the touched variables only, each adding its layer-local
    deltas in the order of ``layer_edges``."""
    B = syn.shape[0]
    n, m, dc = tables.n, tables.m, tables.dc
    L, T, K = tables.layer_edges.shape
    ml = m // L
    El = ml * dc
    var_of_edge = tables.check_var.reshape(-1).long()
    syn = syn.to(torch.int32)
    ssign = (1 - 2 * syn).to(priors.dtype)
    values = priors.expand(B, n).clone()
    R = torch.zeros((B, m * dc), dtype=priors.dtype)
    conv = torch.zeros(B, dtype=torch.bool)
    iters = torch.full((B,), cfg.max_iter - 1, dtype=torch.int32)
    for it in range(cfg.max_iter):
        v = values.clone()
        Rn = R.clone()
        for l in range(L):
            R_l = R[:, l * El:(l + 1) * El]
            Q_l = v[:, var_of_edge[l * El:(l + 1) * El]] - R_l
            if cfg.clip_llr is not None:
                Q_l = torch.clamp(Q_l, -cfg.clip_llr, cfg.clip_llr)
            R_new = check_rule(Q_l.view(B, ml, dc), ssign[:, l * ml:(l + 1) * ml],
                               cfg, cfg.alpha).reshape(B, El)
            delta = R_new - R_l
            for k in range(T):
                var = int(tables.layer_vars[l, k])
                if var >= n:
                    continue
                val = v[:, var]
                for e in tables.layer_edges[l, k].tolist():
                    if e < 0:
                        break
                    val = val + delta[:, e]
                v[:, var] = val
            Rn[:, l * El:(l + 1) * El] = R_new
        R = torch.where(conv[:, None], R, Rn)
        h = (v < 0).to(torch.int8)
        ok = ((h[:, var_of_edge].view(B, m, dc).sum(-1, dtype=torch.int32) % 2) == syn).all(-1)
        values = torch.where(conv[:, None], values, v)
        iters = torch.where(conv, iters, torch.full_like(iters, it))
        conv = conv | ok
    return values, conv, iters, (values < 0).to(torch.int8)


def test_layer_tables_list_each_layers_edges_once_in_ascending_order():
    H = get_code("[[144, 12, 12]]").Hx
    dec = BPDecoder(H, BPConfig(schedule="layered"))
    t = dec.tables()
    assert isinstance(t, LayeredTables)
    m, dc, n = t.m, t.dc, t.n
    L = layer_count(m)
    El = (m // L) * dc
    var_edge = t.var_edge.numpy()
    for l in range(L):
        seen = []
        for v, edges in zip(t.layer_vars[l].tolist(), t.layer_edges[l].tolist()):
            edges = [e for e in edges if e >= 0]
            if v == n:
                assert not edges
                continue
            want = [e - l * El for e in var_edge[v] if l * El <= e < (l + 1) * El]
            assert edges == want == sorted(want) and edges
            assert all(int(t.check_var.reshape(-1)[l * El + e]) == v for e in edges)
            seen += edges
        assert sorted(seen) == list(range(El))  # every edge of the layer, once
    # at [[144,12,12]] with L = 4 a layer touches 66 of the 144 variables
    assert (t.layer_vars < n).sum(1).tolist() == [66] * 4
    direct = layer_tables(dec.graph.var_edge, m, dc, L)
    assert np.array_equal(direct["layer_vars"], t.layer_vars.numpy())


@pytest.mark.parametrize("config", list(OSD_FREE))
def test_layer_tables_reproduce_plain_bit_for_bit(rng, config):
    """[[72,12,6]] in 2 layers: many variables have two or three edges in
    one layer, whose deltas must be added in ascending edge order."""
    H, syn, prior = _batch(rng, "[[72, 12, 6]]", 0.05, 128)
    cfg = BPConfig(schedule="layered", n_layers=2, max_iter=25, **OSD_FREE[config])
    tables = BPDecoder(H, cfg).tables()
    assert tables.layer_edges.shape[2] >= 2
    args = (torch.from_numpy(syn), torch.from_numpy(prior.astype(np.float32)), tables, cfg)
    got, ref = _layered_from_tables(*args), bp_layered_plain(*args)
    assert 0 < int(ref[1].sum()) < len(syn)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
