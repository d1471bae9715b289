"""The port's space-time module and structured BP against the JAX package.

Inputs come from numpy seeds (or one JAX key, for the sampler). The JAX side
runs ``SpaceTimeBPDecoder`` on its XLA path and ``PallasSpaceTimeBPKernel``
in interpret mode; the port runs ``st_bp_plain`` (the CPU path of
``SpaceTimeBPDecoder``). Both decode in float32.

Tolerances and why:
  * the matrix, the sampler (errors and detectors), the folding and the
    priors at the tested rates are bit-identical;
  * min-sum without alpha is exact arithmetic: against the XLA path every
    output, posteriors included, is bit-identical;
  * otherwise decisions (converged, iterations, hard) agree on every lane
    against the XLA path at these sizes (the flooding tests allow 2 lanes
    in 256), and the posteriors of converged lanes within rtol = atol =
    5e-3: XLA's CPU tanh/atanh polynomials and its contracted multiply-adds
    differ from torch's in the last ulp, and BP carries that through its
    iterations (measured: up to 0.0156 on a posterior of 18.3 of
    [[72,12,6]] sum-product after 20 iterations, 2.7e-3 on one of 1.0 with
    damping and clip). Lanes that never converge oscillate and drift
    further apart (up to 1.0) while agreeing in decision;
  * against the Pallas kernel (one-hot matmuls, atanh by its log identity)
    at most 1 lane in 32 may differ in decision, and agreeing lanes'
    posteriors stay within the rtol = atol = 0.05 that
    tests/test_spacetime_pallas.py holds it to against XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code
from qldpc_tpu.decoders import BPConfig as JaxBPConfig
from qldpc_tpu.decoders.spacetime_bp import SpaceTimeBPDecoder as JaxSTDecoder
from qldpc_tpu.noise import spacetime as jst
from qldpc_tpu.ops.spacetime_bp_pallas import PallasSpaceTimeBPKernel
from qldpc_tpu.ops.tanner import TannerGraph as JaxTannerGraph
from qldpc_tpu_torch.convert import key_from_reference
from qldpc_tpu_torch.decoders import BPConfig
from qldpc_tpu_torch.decoders.spacetime_bp import SpaceTimeBPDecoder
from qldpc_tpu_torch.noise import spacetime as st
from qldpc_tpu_torch.ops.spacetime_bp_cuda import st_bp, st_bp_plain

torch.set_num_threads(2)

CODES = ["steane", "[[72, 12, 6]]"]
CONFIGS = {
    "sum-product": dict(),
    "min-sum": dict(method="min-sum"),
    "ms-offset": dict(method="min-sum", alpha=0.8, offset=0.3),
    "sp-damped-clipped": dict(alpha=0.8, damping=0.7, clip_llr=25.0),
    "ms-damped-clipped": dict(method="min-sum", alpha=0.8, damping=0.7, clip_llr=25.0),
}
ROUNDS = {"steane": 3, "[[72, 12, 6]]": 2}


@pytest.mark.parametrize("code_name", CODES)
@pytest.mark.parametrize("T", [1, 3])
def test_space_time_matrix_matches_jax(code_name, T):
    H = get_code(code_name).Hx
    got = st.space_time_matrix(H, T)
    assert got.dtype == np.uint8
    assert np.array_equal(got, jst.space_time_matrix(H, T))


@pytest.mark.parametrize("code_name,q", [("steane", None), ("[[72, 12, 6]]", 0.01)])
def test_sampler_matches_jax_bit_for_bit(code_name, q):
    H = get_code(code_name).Hx
    key = jax.random.key(17)
    base, B, T, p = 96, 40, 3, 0.04
    ref_e, ref_d = jst.sample_space_time_counters(key, jnp.uint32(base), H, p, B, T, q=q)
    got_e, got_d = st.sample_space_time_counters(
        key_from_reference(jax.random.key_data(key)), base, H, p, B, T, q=q
    )
    assert got_e.dtype == torch.int8 and got_d.dtype == torch.int8
    assert np.array_equal(got_e.numpy(), np.asarray(ref_e))
    assert np.array_equal(got_d.numpy(), np.asarray(ref_d))
    assert got_e.any() and got_d.any()
    # the detectors are H_st times the errors
    Hst = st.space_time_matrix(H, T).astype(np.int64)
    assert np.array_equal((got_e.numpy().astype(np.int64) @ Hst.T) % 2, got_d.numpy())


def test_fold_data_correction_matches_jax(rng):
    n, m, T = 7, 3, 4
    v = rng.integers(0, 2, (5, T * (n + m))).astype(np.int8)
    got = st.fold_data_correction(torch.from_numpy(v), n, T)
    assert np.array_equal(got.numpy(), np.asarray(jst.fold_data_correction(jnp.asarray(v), n, T)))
    assert np.array_equal(got.numpy(), v[:, : T * n].reshape(5, T, n).sum(1) % 2)


@pytest.mark.parametrize("p,q", [(0.004, None), (0.008, None), (0.02, 0.01), (0.03, None)])
def test_priors_agree_at_the_tested_rates(p, q):
    ref = np.asarray(jst.space_time_prior_llr(5, 2, 3, jnp.float32(p),
                                              q=None if q is None else jnp.float32(q)))
    got = st.space_time_prior_llr(5, 2, 3, p, q=q)
    assert got.dtype == torch.float32 and got.shape == (21,)
    assert np.array_equal(got.numpy(), ref)


def _case(code_name, T, p, B, seed):
    """(H, detectors (B, T*m) int8, priors (T*(n + m),) float32)."""
    H = get_code(code_name).Hx
    m, n = H.shape
    rng = np.random.default_rng(seed)
    e = (rng.random((B, T, n)) < p).astype(np.int64)
    u = (rng.random((B, T, m)) < p).astype(np.int64)
    s = np.einsum("btn,mn->btm", e, H) % 2
    u_prev = np.concatenate([np.zeros_like(u[:, :1]), u[:, :-1]], axis=1)
    det = ((s + u + u_prev) % 2).reshape(B, T * m).astype(np.int8)
    priors = np.array(jst.space_time_prior_llr(n, m, T, jnp.float32(p)))
    return H, det, priors


def _port(H, T, det, priors, **kw):
    dec = SpaceTimeBPDecoder(H, T, BPConfig(**kw))
    return dec(torch.from_numpy(det), torch.from_numpy(priors))


def _differ(res, conv, iters, hard) -> np.ndarray:
    return ((res.converged.numpy() != np.asarray(conv))
            | (res.iterations.numpy() != np.asarray(iters))
            | (res.hard.numpy() != np.asarray(hard)).any(1))


@pytest.mark.parametrize("code_name", CODES)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_plain_matches_xla(code_name, config):
    kw = CONFIGS[config]
    T = ROUNDS[code_name]
    H, det, priors = _case(code_name, T, 0.03, 64, seed=5)
    ref = JaxSTDecoder(H, T, JaxBPConfig(max_iter=20, **kw))(det, priors)
    res = _port(H, T, det, priors, max_iter=20, **kw)
    assert res.llrs.dtype == torch.float32 and res.llrs.shape == (64, T * sum(H.shape))
    assert res.iterations.dtype == torch.int32
    assert 0 < int(res.converged.sum()) < 64 or code_name == "steane"
    assert not _differ(res, ref.converged, ref.iterations, ref.hard).any()
    if config == "min-sum":
        assert np.array_equal(res.llrs.numpy(), np.asarray(ref.llrs))
    else:
        conv = res.converged.numpy()
        np.testing.assert_allclose(res.llrs.numpy()[conv], np.asarray(ref.llrs)[conv],
                                   rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("code_name", CODES)
@pytest.mark.parametrize("config", ["sum-product", "min-sum", "ms-offset", "sp-damped-clipped"])
def test_plain_matches_pallas_interpret(code_name, config):
    kw = CONFIGS[config]
    T = ROUNDS[code_name]
    H, det, priors = _case(code_name, T, 0.02, 32, seed=6)
    kern = PallasSpaceTimeBPKernel(
        JaxTannerGraph.from_H(H), T, max_iter=15, method=kw.get("method", "sum-product"),
        alpha=kw.get("alpha", 1.0), offset=kw.get("offset", 0.0),
        damping=kw.get("damping", 1.0), clip_llr=kw.get("clip_llr"),
        batch_tile=32, interpret=True,
    )
    values, conv, iters = (np.asarray(x) for x in kern(det, priors))
    res = _port(H, T, det, priors, max_iter=15, **kw)
    differ = _differ(res, conv, iters, (values < 0).astype(np.int8))
    assert int(differ.sum()) <= 1
    np.testing.assert_allclose(res.llrs.numpy()[~differ], values[~differ], rtol=0.05, atol=0.05)


def test_converged_lanes_reproduce_their_detectors():
    H, det, priors = _case("[[72, 12, 6]]", 3, 0.01, 64, seed=7)
    res = _port(H, 3, det, priors, max_iter=40)
    conv = res.converged.numpy()
    assert conv.sum() > 32
    Hst = st.space_time_matrix(H, 3).astype(np.int64)
    s_hat = (res.hard.numpy().astype(np.int64) @ Hst.T) % 2
    assert np.array_equal(s_hat[conv], det[conv])


def test_decoder_refuses_what_the_jax_decoder_refuses():
    H = get_code("steane").Hx
    with pytest.raises(NotImplementedError, match="flooding"):
        SpaceTimeBPDecoder(H, 2, BPConfig(schedule="layered"))
    irregular = np.array([[1, 1, 0], [0, 1, 1], [1, 1, 1]], np.uint8)
    with pytest.raises(NotImplementedError, match="check-regular"):
        SpaceTimeBPDecoder(irregular, 2)
    with pytest.raises(ValueError, match="float32"):
        SpaceTimeBPDecoder(H, 2, BPConfig(dtype="float64"))
    dec = SpaceTimeBPDecoder(H, 2)
    assert dec.check_var.shape == (3, 4) and dec.n_vars == 2 * (7 + 3)
    meta = torch.zeros((1, 6), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        st_bp(meta, meta[0], dec.tables(), 2, BPConfig())


def test_alpha_argument_overrides_the_config():
    H, det, priors = _case("steane", 3, 0.03, 16, seed=8)
    dec = SpaceTimeBPDecoder(H, 3, BPConfig(max_iter=10, method="min-sum", alpha=0.5))
    got = st_bp_plain(torch.from_numpy(det), torch.from_numpy(priors), dec.tables(), 3,
                      BPConfig(max_iter=10, method="min-sum"), alpha=0.5)
    ref = dec(torch.from_numpy(det), torch.from_numpy(priors))
    assert torch.equal(got[0], ref.llrs) and torch.equal(got[2], ref.iterations)
