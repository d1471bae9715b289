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

bf16 streams (``stream_dtype="bfloat16"``) against the Pallas kernel's bf16
streams, in interpret mode: the same standards, by the same reasons (the
roundings to bf16 are the same round-to-nearest-even in both packages, so
min-sum stays exact arithmetic: bit-identical), except the sum-product
posteriors of agreeing lanes: a last-ulp float32 difference in a message
(XLA's transcendentals, its sum order) flips that message's rounding to
bf16 where it lies near a tie, which moves it by a bf16 ulp, 2^-7 of its
magnitude and at most 2^-4 (|R| <= 2 atanh(0.9999999) < 16.7). Those are
held within rtol 2^-7 and atol 2^-4 (measured up to 0.039 on the Steane
DEM, 3% of the entries beyond the float32 standard); beside them the JAX test's
own contract (tests/test_dem_pallas.py:97-127): every converged lane
reproduces its syndrome, and on lanes both converge the bf16 posteriors are
within rtol 0.05 / atol 0.25 of the float32 ones. The comparisons hold on
graphs without checks of degree 1, where the Pallas kernel's phantom slots
(pinned to 1e9, rounded in bf16) and the port's (the rules' neutral
elements) send different messages.
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
from qldpc_tpu_torch.ops.bp_cuda import TANH_CLIP, round_bf16
from qldpc_tpu_torch.ops.dem_bp_cuda import (
    _check_messages,
    _fold,
    dem_bp,
    dem_bp_plain,
    summary_path,
)

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
    elif mode == "close-bf16":
        np.testing.assert_allclose(gv[agree], rv[agree], rtol=2**-7, atol=2**-4)


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
    # the bf16 streams carry over
    got = bp_config_from_reference(JaxBPConfig(backend="pallas", stream_dtype="bfloat16"))
    assert got == BPConfig(stream_dtype="bfloat16")


def test_dem_bp_refuses_unknown_devices():
    dec = BPDecoder(_random_irregular(np.random.default_rng(0)))
    meta = torch.zeros((2, dec.graph.m), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dem_bp(meta, meta[0, :1], dec.tables(), dec.config)


# ---- K3's summary path, rendered in plain torch ---------------------------
# Under the one-pass check rule every message R_j follows from the slot's own
# word and a per-(check, sample) summary (csrc/dem_bp.cu). These renderings
# repeat the kernel's expressions on the CPU; they must give the message
# path's R, and the whole decoder's outputs, bit for bit.

_SIGN = torch.tensor(-(2**31), dtype=torch.int32)
_ZERO = torch.tensor(0, dtype=torch.int32)


def _encode(Q, method):
    """Slot words: Q (min-sum), or |lt| with the sign bit where t < 0."""
    if method == "min-sum":
        return Q
    t = torch.tanh(Q * 0.5)
    lt = torch.log(torch.clamp(t.abs(), min=1e-15))
    return (lt.abs().view(torch.int32) | torch.where(t < 0, _SIGN, _ZERO)).view(torch.float32)


def _decode(w):
    """(lt, t < 0) of sum-product words; lt <= 0 comes back as -|w|."""
    return (w.view(torch.int32) | _SIGN).view(torch.float32), w.view(torch.int32) < 0


def _summaries(W, ssign, tables, method):
    """The two (B, m, 1) planes of every check's summary."""
    B, m, dc = W.shape[0], tables.m, tables.dc
    Wc = W.view(B, m, dc)
    mask = tables.slot_mask
    ss = ssign[..., None]
    if method == "sum-product":
        lt, neg = _decode(torch.where(mask, Wc, 0.0))  # phantoms: lt -0, t >= 0
        odd = neg.sum(-1, keepdim=True, dtype=torch.int32) % 2
        return _fold(lt), (1 - 2 * odd).to(W.dtype) * ss
    aq = torch.where(mask, Wc.abs(), torch.inf)
    nan = torch.isnan(aq)
    finite = torch.where(nan, torch.inf, aq)
    first = torch.arange(dc) == finite.argmin(-1, keepdim=True)
    min1 = torch.where(nan.any(-1, keepdim=True), torch.nan, finite.min(-1, keepdim=True).values)
    min2 = torch.where(first, torch.inf, finite).min(-1, keepdim=True).values
    odd = (mask & (Wc < 0)).sum(-1, keepdim=True, dtype=torch.int32) % 2
    flip = (odd == 1) != (ss < 0)
    return min1, (min2.view(torch.int32) | torch.where(flip, _SIGN, _ZERO)).view(torch.float32)


def _messages(W, summary, tables, cfg, alpha):
    """R (B, m*dc) from the words and the summaries, alpha last."""
    B, m, dc = W.shape[0], tables.m, tables.dc
    Wc = W.view(B, m, dc)
    a, s = summary
    if cfg.method == "sum-product":
        lt, neg = _decode(Wc)
        others = torch.exp(a - lt) * s * torch.where(neg, -1.0, 1.0)
        R = 2.0 * torch.atanh(torch.clamp(others, -TANH_CLIP, TANH_CLIP))
    else:
        neg = (s.view(torch.int32) < 0) != (Wc < 0)
        mags = torch.where(Wc.abs() == a, s.abs(), a)
        if cfg.offset:
            mags = torch.clamp(mags - cfg.offset, min=0.0)
        R = torch.where(neg, -1.0, 1.0) * mags
    if alpha != 1.0:
        R = R * alpha
    return R.reshape(B, m * dc)


def _summary_bp(syn, priors, tables, cfg):
    """dem_bp_plain's loop on slot words and summaries (no stored R). Under
    bf16 streams each R rounds in registers, and a word holds
    clip(rd(posterior) - R), as K3's summary path keeps it."""
    B = syn.shape[0]
    n, m, dc = tables.n, tables.m, tables.dc
    vos, var_slots = tables.var_of_slot.reshape(-1).long(), tables.var_slots.long()
    syn = syn.to(torch.int32)
    priors = priors.expand(B, n)
    ssign = (1 - 2 * syn).to(priors.dtype)
    bf16 = cfg.stream_dtype == "bfloat16"
    if bf16:
        Q0 = round_bf16(priors)[:, vos]
        if cfg.clip_llr is not None:
            Q0 = torch.clamp(Q0, -cfg.clip_llr, cfg.clip_llr)
    else:
        Q0 = priors[:, vos]
    W = _encode(Q0, cfg.method)
    values, hard = priors.clone(), torch.zeros((B, n), dtype=torch.int8)
    conv = torch.zeros(B, dtype=torch.bool)
    iters = torch.full((B,), cfg.max_iter - 1, dtype=torch.int32)
    for it in range(cfg.max_iter):
        act = torch.nonzero(~conv).flatten()
        if act.numel() == 0:
            break
        Wa = W[act]
        R = _messages(Wa, _summaries(Wa, ssign[act], tables, cfg.method), tables, cfg, cfg.alpha)
        if bf16:
            R = round_bf16(R)
        rv = torch.cat([R, torch.zeros((act.numel(), 1))], dim=1)[:, var_slots]
        vals = _fold(rv)[..., 0] + priors[act]
        Qn = (round_bf16(vals) if bf16 else vals)[:, vos] - R
        if cfg.damping != 1.0:  # min-sum only here: its word is Q
            Qn = cfg.damping * Qn + (1.0 - cfg.damping) * Wa
        if cfg.clip_llr is not None:
            Qn = torch.clamp(Qn, -cfg.clip_llr, cfg.clip_llr)
        h = (vals < 0).to(torch.int8)
        hs = torch.where(tables.slot_mask, h[:, vos].view(-1, m, dc), 0)
        ok = (hs.sum(dim=-1, dtype=torch.int32) % 2 == syn[act]).all(dim=-1)
        W[act] = _encode(Qn, cfg.method)
        values[act], hard[act], iters[act], conv[act] = vals, h, it, ok
    return values, conv, iters, hard


SUMMARY_CASES = {
    "sum-product": dict(),
    "sp-alpha-clip": dict(alpha=0.8, clip_llr=12.0),
    "min-sum": dict(method="min-sum"),
    "ms-alpha-offset-clip": dict(method="min-sum", alpha=0.75, offset=0.1, clip_llr=6.0),
    "ms-damped": dict(method="min-sum", damping=0.6),
}


def _steane_dem(degree_one: bool = False):
    """The Steane DEM (dc_max 75); optionally with a check of degree 1 on
    the first mechanism, whose min-sum message is an infinite magnitude."""
    dem = memory_experiment_dem(get_code("steane"), p=0.01, rounds=3)
    H, prior = dem.H, dem.llrs.astype(np.float32)
    if degree_one:
        H = np.vstack([H, np.eye(1, H.shape[1], dtype=H.dtype)])
    return H, prior


def test_slot_word_round_trip():
    Q = torch.tensor([0.0, -0.0, 1e-30, -1e-30, 0.3, -0.3, 9.0, -9.0, 17.0, -17.0,
                      40.0, -40.0, np.inf, -np.inf, np.nan])
    t = torch.tanh(Q * 0.5)
    lt = torch.log(torch.clamp(t.abs(), min=1e-15))
    got_lt, got_neg = _decode(_encode(Q, "sum-product"))
    assert torch.equal(got_neg, t < 0)
    torch.testing.assert_close(got_lt, lt, rtol=0, atol=0, equal_nan=True)
    saturated = t.abs() == 1.0  # |t| = 1: lt = +0 comes back as -0, the same number
    assert int(saturated.sum()) == 4 and bool((got_lt[saturated] == 0).all())
    assert torch.equal(_encode(Q, "min-sum").view(torch.int32), Q.view(torch.int32))


@pytest.mark.parametrize("case", list(SUMMARY_CASES))
def test_summary_messages_equal_check_messages_bit_for_bit(rng, case):
    """R from words and summaries against _check_messages on messages that
    include |t| = 1 (|Q| = 20), zeros, a NaN and infinities, on the Steane
    DEM with a check of degree 1."""
    cfg = BPConfig(max_iter=5, **SUMMARY_CASES[case])
    H, _ = _steane_dem(degree_one=True)
    dec = BPDecoder(H, cfg)
    tables = dec.tables()
    assert summary_path(tables, cfg) and tables.dc > 16 and int(tables.check_deg.min()) == 1
    B = 64
    Q = torch.from_numpy(rng.normal(0.0, 8.0, (B, tables.m * tables.dc)).astype(np.float32))
    Q[:, ::7] = 20.0 * torch.sign(Q[:, ::7])  # tanh(10) rounds to 1: lt = 0
    Q[:5, 3] = 0.0
    Q[5, 0], Q[6, 1], Q[7, 2] = np.nan, np.inf, -np.inf
    ssign = torch.from_numpy(1 - 2 * rng.integers(0, 2, (B, tables.m)).astype(np.float32))
    ref = _check_messages(Q, ssign, tables, cfg, cfg.alpha)
    W = _encode(Q, cfg.method)
    got = _messages(W, _summaries(W, ssign, tables, cfg.method), tables, cfg, cfg.alpha)
    real = tables.slot_mask.reshape(-1)
    assert bool(torch.isnan(ref[:, real]).any())
    torch.testing.assert_close(got[:, real], ref[:, real], rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("case", list(SUMMARY_CASES))
def test_summary_path_decodes_bit_for_bit_like_plain(rng, case):
    cfg = BPConfig(max_iter=30, **SUMMARY_CASES[case])
    H, syn, prior = _inputs(rng, "steane-dem", B=200)
    tables = BPDecoder(H, cfg).tables()
    args = (torch.from_numpy(syn), torch.from_numpy(prior), tables, cfg)
    ref = dem_bp_plain(*args)
    got = _summary_bp(*args)
    assert 0 < int(ref[1].sum()) < len(syn)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)


def test_summary_path_propagates_nan_from_a_degree_one_check(rng):
    H, prior = _steane_dem(degree_one=True)
    errors = (rng.random((128, H.shape[1])) < 0.01).astype(np.int64)
    syn = ((errors @ H.T) % 2).astype(np.int8)
    syn[:, -1] = 1
    cfg = BPConfig(max_iter=20, method="min-sum", offset=0.1, clip_llr=8.0)
    args = (torch.from_numpy(syn), torch.from_numpy(prior), BPDecoder(H, cfg).tables(), cfg)
    ref = dem_bp_plain(*args)
    assert bool(torch.isnan(ref[0]).any())
    for g, r in zip(_summary_bp(*args), ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)


def test_summary_path_rule():
    dem_tables = BPDecoder(_steane_dem()[0]).tables()
    small = BPDecoder(_random_irregular(np.random.default_rng(0))).tables()
    assert summary_path(dem_tables, BPConfig())
    assert summary_path(dem_tables, BPConfig(method="min-sum", damping=0.6))
    assert not summary_path(dem_tables, BPConfig(damping=0.7))  # needs the old Q
    assert not summary_path(small, BPConfig())  # dc <= 16: prefix x suffix
    assert not summary_path(small, BPConfig(method="min-sum"))


# ---- bf16 streams ----------------------------------------------------------


@pytest.mark.parametrize("kind", ["steane-dem", "random-irregular"])
@pytest.mark.parametrize("case", list(CONFIGS))
def test_bf16_streams_match_pallas(rng, kind, case):
    cfg = dict(max_iter=30, stream_dtype="bfloat16", **CONFIGS[case])
    H, syn, prior = _inputs(rng, kind, B=200)
    assert H.sum(1).min() >= 2  # no check of degree 1 (module docstring)
    ref = _jax(H, syn, prior, "pallas", **cfg)
    got = _port(H, syn, prior, **cfg)
    assert 0 < got[1].sum() < len(syn)
    mode = _mode(cfg, "pallas")
    _hold(got, ref, "close-bf16" if mode == "close" else mode)


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_bf16_streams_self_consistent(rng, method):
    """tests/test_dem_pallas.py:97-127's contract, on the port."""
    H, syn, prior = _inputs(rng, "steane-dem", B=96)
    f32 = _port(H, syn, prior, max_iter=15, method=method)
    bf16 = _port(H, syn, prior, max_iter=15, method=method, stream_dtype="bfloat16")
    conv, hard = bf16[1], bf16[3]
    assert conv.any()
    resid = (hard.astype(np.int64) @ H.T) % 2
    np.testing.assert_array_equal(resid[conv], syn[conv])
    both = conv & f32[1]
    np.testing.assert_allclose(bf16[0][both], f32[0][both], rtol=0.05, atol=0.25)


def test_bf16_streams_round_where_the_tpu_kernel_rounds(rng):
    """Every message the port keeps under bf16 streams is a bf16 number, and
    one iteration's posterior is the fold of the rounded R's plus the prior:
    BP(1) min-sum against the rule applied by hand."""
    H, syn, prior = _inputs(rng, "steane-dem", B=32)
    cfg = BPConfig(max_iter=1, method="min-sum", clip_llr=6.0, stream_dtype="bfloat16")
    tables = BPDecoder(H, cfg).tables()
    syn_t, prior_t = torch.from_numpy(syn), torch.from_numpy(prior)
    values, *_ = dem_bp_plain(syn_t, prior_t, tables, cfg)
    Q = torch.clamp(round_bf16(prior_t)[tables.var_of_slot.reshape(-1).long()], -6.0, 6.0)
    R = round_bf16(_check_messages(Q.expand(32, -1), (1 - 2 * syn_t).float(), tables, cfg, 1.0))
    rv = torch.cat([R, torch.zeros((32, 1))], dim=1)[:, tables.var_slots.long()]
    torch.testing.assert_close(values, _fold(rv)[..., 0] + prior_t, rtol=0, atol=0)
    assert not torch.equal(values, dem_bp_plain(syn_t, prior_t, tables,
                                                BPConfig(max_iter=1, method="min-sum",
                                                         clip_llr=6.0))[0])


BF16_SUMMARY_CASES = {
    "sum-product": dict(),
    "sp-alpha-clip": dict(alpha=0.8, clip_llr=12.0),
    "ms-alpha-offset-clip": dict(method="min-sum", alpha=0.75, offset=0.1, clip_llr=6.0),
}


@pytest.mark.parametrize("case", list(BF16_SUMMARY_CASES))
def test_bf16_summary_path_decodes_bit_for_bit_like_plain(rng, case):
    cfg = BPConfig(max_iter=30, stream_dtype="bfloat16", **BF16_SUMMARY_CASES[case])
    H, syn, prior = _inputs(rng, "steane-dem", B=200)
    tables = BPDecoder(H, cfg).tables()
    assert summary_path(tables, cfg)
    args = (torch.from_numpy(syn), torch.from_numpy(prior), tables, cfg)
    ref = dem_bp_plain(*args)
    got = _summary_bp(*args)
    assert 0 < int(ref[1].sum()) < len(syn)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("kind", ["steane-dem", "random-irregular"])
@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_bf16_streams_with_float64_dtype_run_as_jax(rng, kind, method):
    """bf16 streams with ``dtype="float64"``: the JAX kernel computes in
    float32 whatever dtype says, and so does the port (its float32 bf16
    run, bit for bit); held to the JAX decoder's float64 config by the bf16
    standards of ``test_bf16_streams_match_pallas``."""
    cfg = dict(max_iter=30, stream_dtype="bfloat16", method=method)
    H, syn, prior = _inputs(rng, kind, B=200)
    ref = _jax(H, syn, prior.astype(np.float64), "pallas", dtype="float64", **cfg)
    got = _port(H, syn, prior.astype(np.float64), dtype="float64", **cfg)
    assert got[0].dtype == np.float32 == ref[0].dtype
    for g, f in zip(got, _port(H, syn, prior, **cfg)):
        np.testing.assert_array_equal(g, f)
    mode = _mode(cfg, "pallas")
    _hold(got, ref, "close-bf16" if mode == "close" else mode)


@pytest.mark.parametrize("kind", ["steane-dem", "random-irregular"])
@pytest.mark.parametrize("case", list(DAMPED))
def test_mm_dtype_on_a_damped_irregular_graph_warns_and_runs_float32(rng, kind, case):
    """``mm_dtype="bfloat16"`` on a damped irregular graph: the JAX decoder
    warns and runs its float32 XLA path (the mode belongs to the fused
    kernel of check-regular graphs); the port warns and runs its float32
    path, equal to the same config without the mode, and held to the JAX
    run as ``test_damped_dem_bp_matches_xla`` holds it."""
    cfg = dict(max_iter=30, **DAMPED[case])
    H, syn, prior = _inputs(rng, kind, B=200)
    with pytest.warns(UserWarning, match="XLA backend"):
        ref = _jax(H, syn, prior, "pallas", mm_dtype="bfloat16", **cfg)
    with pytest.warns(UserWarning, match="mm_dtype applies to the fused flooding kernel"):
        got = _port(H, syn, prior, mm_dtype="bfloat16", **cfg)
    for g, f in zip(got, _port(H, syn, prior, **cfg)):
        np.testing.assert_array_equal(g, f)
    _hold(got, ref, _mode(cfg, "xla"))
    # undamped, both still refuse it
    with pytest.raises(ValueError, match="mm_dtype"):
        BPDecoder(H, BPConfig(max_iter=5, mm_dtype="bfloat16"))
