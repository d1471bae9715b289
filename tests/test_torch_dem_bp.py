"""The port's BP on irregular graphs (detector error models) against the JAX
package.

Inputs come from numpy seeds: the Steane memory-experiment DEM of the JAX
tests (18 detectors x 267 mechanisms, dc_max 75, so the one-pass check
rule) and a small random irregular graph (dc_max <= 16, the prefix/suffix
rule, with mechanisms in no detector). The JAX side runs its XLA slot path
and its streamed Pallas kernel in interpret mode; the port runs
``dem_bp_plain`` (the CPU path of ``BPDecoder`` on irregular graphs).

Tolerances and why:
  * min-sum without alpha or damping is exact arithmetic: posteriors,
    decisions and iterations are bit-identical to the XLA path and to the
    Pallas kernel (interpret mode), which also scales by alpha exactly as
    the port does;
  * sum-product: the XLA path sums the log magnitudes with ``jnp.sum`` in
    its own order, the Pallas kernel uses the log-domain form at every
    degree, and XLA's CPU transcendentals differ from torch's in the last
    ulps. So converged, iterations and hard decisions must agree on at
    least 98% of lanes, and the posteriors of agreeing lanes within
    rtol 1e-4, with an absolute floor of 1e-3 for posteriors near 0: the
    differences are absolute ones carried through up to 30 iterations
    (measured up to 6.6e-4 on the Steane DEM with alpha and clip, every
    lane agreeing in decision);
  * min-sum with alpha or damping against the XLA path: XLA's CPU backend
    contracts ``a*b + c`` into fused multiply-adds (the damping update, the
    alpha-scaled messages summed into the posteriors), which the port and
    its kernels never do, and min-sum's selections carry the different
    roundings on (measured up to 0.064 on a posterior of the Steane DEM).
    Those cases hold the decisions, on at least 98% of lanes.
"""

import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code
from qldpc_tpu.decoders import BPConfig as JaxBPConfig
from qldpc_tpu.decoders import BPDecoder as JaxBPDecoder
from qldpc_tpu.noise.circuit import memory_experiment_dem
from qldpc_tpu.ops.tanner import TannerGraph
from qldpc_tpu_torch.convert import bp_config_from_reference
from qldpc_tpu_torch.decoders import BPConfig, BPDecoder
from qldpc_tpu_torch.ops.dem_bp_cuda import dem_bp, dem_bp_plain

torch.set_num_threads(2)

CONFIGS = {
    "sum-product": dict(),
    "min-sum": dict(method="min-sum"),
    "ms-alpha-offset": dict(method="min-sum", alpha=0.75, offset=0.1),
    "sp-alpha-clip": dict(alpha=0.8, clip_llr=12.0),
    "ms-clip": dict(method="min-sum", clip_llr=6.0),
}
DAMPED = {
    "sp-damped-clipped": dict(alpha=0.8, damping=0.7, clip_llr=25.0),
    "ms-damped": dict(method="min-sum", damping=0.6),
}
AGREE = 0.98


def _random_irregular(rng, m=12, n=60):
    """Columns of weight 0-3 (a few all-zero: mechanisms in no detector),
    every check of degree 2..16."""
    while True:
        H = np.zeros((m, n), np.uint8)
        for j in range(n):
            w = rng.choice([0, 1, 2, 3], p=[0.05, 0.3, 0.4, 0.25])
            H[rng.choice(m, size=w, replace=False), j] = 1
        deg = H.sum(1)
        if deg.min() >= 2 and deg.max() <= 16 and (H.sum(0) == 0).any():
            return H


def _inputs(rng, kind, B):
    if kind == "steane-dem":
        dem = memory_experiment_dem(get_code("steane"), p=0.01, rounds=3)
        H, prob = dem.H, dem.priors
        prior = dem.llrs.astype(np.float32)
    else:
        H = _random_irregular(rng)
        prob = rng.uniform(0.02, 0.12, H.shape[1])
        prior = np.log((1 - prob) / prob).astype(np.float32)
    errors = (rng.random((B, H.shape[1])) < prob).astype(np.int8)
    syn = ((errors.astype(np.int64) @ H.T) % 2).astype(np.int8)
    return H, syn, prior


def _jax(H, syn, prior, backend, **cfg):
    dec = JaxBPDecoder(H, JaxBPConfig(backend=backend, **cfg))
    r = dec(syn, prior)
    return tuple(np.asarray(x) for x in (r.llrs, r.converged, r.iterations, r.hard))


def _port(H, syn, prior, **cfg):
    dec = BPDecoder(H, BPConfig(**cfg))
    assert dec.slot_layout
    r = dec(torch.from_numpy(syn), torch.from_numpy(prior))
    return tuple(x.numpy() for x in (r.llrs, r.converged, r.iterations, r.hard))


def _mode(cfg: dict, backend: str) -> str:
    """How closely the port must follow the JAX run (module docstring)."""
    if cfg.get("method") != "min-sum":
        return "close"
    contracted = cfg.get("damping", 1.0) != 1.0 or (
        cfg.get("alpha", 1.0) != 1.0 and backend == "xla"
    )
    return "decisions" if contracted else "exact"


def _hold(got, ref, mode: str):
    gv, gc, gi, gh = got
    rv, rc, ri, rh = ref
    if mode == "exact":
        np.testing.assert_array_equal(gv, rv)
        np.testing.assert_array_equal(gc, rc)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gh, rh)
        return
    agree = (gc == rc) & (gi == ri) & (gh == rh).all(1)
    assert agree.mean() >= AGREE, f"{int((~agree).sum())} lanes differ"
    if mode == "close":
        np.testing.assert_allclose(gv[agree], rv[agree], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("kind", ["steane-dem", "random-irregular"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(CONFIGS))
def test_plain_dem_bp_matches_jax(rng, kind, backend, case):
    cfg = dict(max_iter=30, **CONFIGS[case])
    H, syn, prior = _inputs(rng, kind, B=200)
    ref = _jax(H, syn, prior, backend, **cfg)
    got = _port(H, syn, prior, **cfg)
    assert 0 < got[1].sum() < len(syn)  # some lanes converge, some fail
    _hold(got, ref, _mode(cfg, backend))


@pytest.mark.parametrize("kind", ["steane-dem", "random-irregular"])
@pytest.mark.parametrize("case", list(DAMPED))
def test_damped_dem_bp_matches_xla(rng, kind, case):
    # the JAX Pallas kernel takes no damping; its decoder falls back to XLA
    cfg = dict(max_iter=30, **DAMPED[case])
    H, syn, prior = _inputs(rng, kind, B=200)
    ref = _jax(H, syn, prior, "xla", **cfg)
    _hold(_port(H, syn, prior, **cfg), ref, _mode(cfg, "xla"))


def test_float64_matches_xla_exact_cumprod(rng):
    # float64 keeps the prefix/suffix rule at any degree, as the XLA path
    H, syn, prior = _inputs(rng, "steane-dem", B=64)
    cfg = dict(max_iter=20, method="min-sum", dtype="float64")
    ref = _jax(H, syn, prior.astype(np.float64), "xla", **cfg)
    _hold(_port(H, syn, prior.astype(np.float64), **cfg), ref, "exact")


def test_tables_and_bare_prior_of_mechanisms_in_no_detector(rng):
    H, syn, prior = _inputs(rng, "random-irregular", B=32)
    g = TannerGraph.from_H(H)
    dec = BPDecoder(H, BPConfig(max_iter=5))
    t = dec.tables()
    assert (t.m, t.dc, t.n, t.dv) == (g.m, g.dc_max, g.n, g.dv_max)
    np.testing.assert_array_equal(t.check_deg.numpy(), H.sum(1))
    mask = t.slot_mask.numpy()
    # real slots come first in each check and name exactly its variables
    for c in range(g.m):
        d = H[c].sum()
        assert mask[c, :d].all() and not mask[c, d:].any()
        assert sorted(t.var_of_slot.numpy()[c, :d]) == list(np.flatnonzero(H[c]))
    S = g.m * g.dc_max
    vs = t.var_slots.numpy()
    for v in range(g.n):
        slots = vs[v][vs[v] < S]
        assert all(t.var_of_slot.numpy().reshape(-1)[s] == v for s in slots)
        assert len(slots) == H[:, v].sum()
    empty = H.sum(0) == 0
    values, *_ = dem_bp_plain(
        torch.from_numpy(syn), torch.from_numpy(prior), t, BPConfig(max_iter=5)
    )
    np.testing.assert_array_equal(values.numpy()[:, empty],
                                  np.broadcast_to(prior[empty], (32, empty.sum())))


def test_per_sample_priors_and_alpha_override(rng):
    H, syn, _ = _inputs(rng, "steane-dem", B=48)
    prior = rng.uniform(1.0, 9.0, (48, H.shape[1])).astype(np.float32)
    cfg = dict(max_iter=25, method="min-sum")
    ref = _jax(H, syn, prior, "pallas", **cfg, alpha=0.5)
    dec = BPDecoder(H, BPConfig(**cfg))
    r = dec(torch.from_numpy(syn), torch.from_numpy(prior), alpha=0.5)
    _hold(tuple(x.numpy() for x in (r.llrs, r.converged, r.iterations, r.hard)),
          ref, _mode(dict(cfg, alpha=0.5), "pallas"))


def test_config_conversion_keeps_dem_fields():
    ref = JaxBPConfig(max_iter=50, backend="pallas", chunk_size=10)
    assert bp_config_from_reference(ref) == BPConfig(max_iter=50)
    with pytest.raises(ValueError, match="float32"):
        bp_config_from_reference(JaxBPConfig(backend="pallas", stream_dtype="bfloat16"))


def test_dem_bp_refuses_unknown_devices():
    dec = BPDecoder(_random_irregular(np.random.default_rng(0)))
    meta = torch.zeros((2, dec.graph.m), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dem_bp(meta, meta[0, :1], dec.tables(), dec.config)
