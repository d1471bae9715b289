"""The port's flooding BP against the JAX package and the numpy oracles.

Inputs come from numpy seeds. The JAX side runs its XLA path, and its Pallas
kernel in interpret mode; the port runs its plain torch version (the CPU
path of ``ops.bp_cuda.bp_flooding``).

Tolerances and why:
  * float64 decisions (converged, iterations, hard) equal the XLA path and
    tests/oracles.py exactly; LLRs are within 1e-6 of the oracles, as
    tests/test_bp.py holds the JAX package.
  * float64 LLRs against the XLA path: bit-identical where the arithmetic is
    exact (min-sum without alpha); otherwise within rtol 1e-7. XLA's CPU
    backend evaluates tanh, atanh and log with its own polynomials, which
    differ from torch's in the last ulp, and BP carries those differences
    through up to 30 iterations (measured: up to ~6e-9 relative).
  * float32 decisions: at most 2 of 256 lanes may differ from the XLA path
    and from the Pallas kernel, for the same reason, at the 25 iterations
    tests/test_pallas.py runs. The two JAX paths differ from each other by
    as many lanes at 50 iterations.
  * bf16 operands (``mm_dtype="bfloat16"``) against the Pallas kernel's, in
    interpret mode, held to the JAX test's contract
    (tests/test_pallas.py:159-182: every converged lane reproduces its
    syndrome and, for sum-product, the test's method, the converged count is
    within 8 lanes of the float32 kernel's; min-sum converges on far more
    lanes in bf16 than in float32, in both packages) and in decision.
    Min-sum is exact arithmetic after the same roundings: bit-identical
    (a sum of three bf16 messages is exact in float32 unless their exponents
    lie 16 apart, so the kernel's matmul order and the port's fold agree).
    Sum-product adds the last-ulp differences of the float32 tests, each of
    which can flip a message's rounding to bf16: at most 6 of 256 lanes
    differ in decision (measured: 2).
"""

import numpy as np
import pytest
import torch

import oracles
from qldpc_tpu.codes import get_code
from qldpc_tpu.decoders import BPConfig as JaxBPConfig
from qldpc_tpu.decoders import BPDecoder as JaxBPDecoder
from qldpc_tpu_torch.convert import bp_config_from_reference
from qldpc_tpu_torch.decoders import BPConfig, BPDecoder

torch.set_num_threads(2)

CONFIGS = {
    "sum-product": dict(),
    "min-sum": dict(method="min-sum"),
    "sp-damped-clipped": dict(alpha=0.8, damping=0.7, clip_llr=25.0),
    "ms-damped-clipped": dict(method="min-sum", alpha=0.8, damping=0.7, clip_llr=25.0),
    "ms-offset": dict(method="min-sum", alpha=0.8, offset=0.1),
}


def _batch(rng, code, p, B):
    H = code.Hx
    errors = (rng.random((B, code.n)) < p).astype(np.int8)
    syn = ((errors @ H.T) % 2).astype(np.int8)
    prior = np.full(code.n, np.log((1 - p) / p))
    return H, syn, prior


def _port(H, syn, prior, **cfg):
    dec = BPDecoder(H, BPConfig(**cfg))
    return dec(torch.from_numpy(syn), torch.from_numpy(prior))


def _decision_mismatches(a, b) -> int:
    hard_a, conv_a, iters_a = (np.asarray(x) for x in a)
    hard_b, conv_b, iters_b = (np.asarray(x) for x in b)
    return int(
        ((conv_a != conv_b) | (iters_a != iters_b) | (hard_a != hard_b).any(1)).sum()
    )


@pytest.mark.parametrize("code_name", ["steane", "[[72, 12, 6]]"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_float64_matches_xla_and_oracles(rng, code_name, config):
    code = get_code(code_name)
    kw = CONFIGS[config]
    B = 61  # ragged against every batch tile
    H, syn, prior = _batch(rng, code, 0.06, B)
    ref = JaxBPDecoder(H, JaxBPConfig(max_iter=30, dtype="float64", **kw))(syn, prior)
    res = _port(H, syn, prior, max_iter=30, dtype="float64", **kw)
    assert res.llrs.dtype == torch.float64
    assert res.iterations.dtype == torch.int32

    assert np.array_equal(res.converged.numpy(), np.asarray(ref.converged))
    assert np.array_equal(res.iterations.numpy(), np.asarray(ref.iterations))
    assert np.array_equal(res.hard.numpy(), np.asarray(ref.hard))
    exact = kw.get("method") == "min-sum" and "alpha" not in kw
    np.testing.assert_allclose(
        res.llrs.numpy(), np.asarray(ref.llrs), rtol=0 if exact else 1e-7, atol=0
    )

    oracle = oracles.bp_min_sum if kw.get("method") == "min-sum" else oracles.bp_sum_product
    okw = {k: v for k, v in kw.items() if k != "method"}
    for i in range(B):
        hard, conv, llrs, iters = oracle(H, syn[i], prior, max_iter=30, **okw)
        assert bool(res.converged[i]) == conv, f"sample {i}"
        assert int(res.iterations[i]) == iters, f"sample {i}"
        assert np.array_equal(res.hard[i].numpy(), hard), f"sample {i}"
        np.testing.assert_allclose(res.llrs[i].numpy(), llrs, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_float32_matches_xla_and_pallas(rng, method):
    code = get_code("[[72, 12, 6]]")
    H, syn, prior = _batch(rng, code, 0.05, 256)
    prior = prior.astype(np.float32)
    res = _port(H, syn, prior, max_iter=25, method=method)
    assert res.llrs.dtype == torch.float32
    got = (res.hard, res.converged, res.iterations)
    for backend in ("xla", "pallas"):
        ref = JaxBPDecoder(
            H, JaxBPConfig(max_iter=25, method=method, backend=backend, batch_tile=128)
        )(syn, prior)
        diff = _decision_mismatches(got, (ref.hard, ref.converged, ref.iterations))
        print(f"{method} vs {backend}: {diff} of 256 lanes differ in decision")
        assert diff <= 2, f"{diff} of 256 lanes differ from the {backend} path"


def test_converged_hard_reproduces_syndrome(rng):
    code = get_code("[[72, 12, 6]]")
    H, syn, prior = _batch(rng, code, 0.04, 128)
    res = _port(H, syn, prior.astype(np.float32), max_iter=50)
    conv = res.converged.numpy()
    assert conv.any()
    s_hat = (res.hard.numpy().astype(np.int64) @ H.T) % 2
    assert np.array_equal(s_hat[conv], syn[conv])


def test_config_conversion():
    ref = JaxBPConfig(
        max_iter=20, method="min-sum", alpha=0.7, offset=0.05, backend="pallas",
        batch_tile=512, dtype="float64", chunk_size=5,
    )
    got = bp_config_from_reference(ref)
    assert got == BPConfig(
        max_iter=20, method="min-sum", alpha=0.7, offset=0.05, dtype="float64"
    )
    assert bp_config_from_reference({"max_iter": 7}) == BPConfig(max_iter=7)
    # the bf16 modes carry over; beside a backend other than pallas they
    # raise, as the JAX BPConfig does
    assert bp_config_from_reference({"mm_dtype": "bfloat16"}) == BPConfig(mm_dtype="bfloat16")
    got = bp_config_from_reference(JaxBPConfig(backend="pallas", mm_dtype="bfloat16"))
    assert got == BPConfig(mm_dtype="bfloat16")
    for name in ("mm_dtype", "stream_dtype"):
        with pytest.raises(ValueError, match=name):
            JaxBPConfig(backend="xla", **{name: "bfloat16"})
        with pytest.raises(ValueError, match=name):
            bp_config_from_reference({name: "bfloat16", "backend": "xla"})
    # the layered schedule and its layer count change the result: they carry over
    got = bp_config_from_reference(JaxBPConfig(schedule="layered", n_layers=3, backend="pallas"))
    assert got == BPConfig(schedule="layered", n_layers=3)
    with pytest.raises(ValueError, match="no fields"):
        bp_config_from_reference({"not_a_field": 1})


def test_out_of_slice_features_raise():
    # the layered schedule is ported now; unknown schedules still raise
    assert BPConfig(schedule="layered").n_layers == 0
    with pytest.raises(ValueError, match="unknown schedule"):
        BPConfig(schedule="serial")
    # irregular checks are ported now: they take the check-slot layout
    H = np.array([[1, 1, 0], [0, 1, 1], [1, 1, 1]], np.uint8)
    dec = BPDecoder(H)
    assert dec.slot_layout
    r = dec(torch.tensor([[1, 0, 1]], dtype=torch.int8), torch.full((3,), 2.0))
    assert r.converged.all() and r.hard.tolist() == [[1, 0, 0]]


@pytest.mark.parametrize("shared_priors", [True, False])
@pytest.mark.parametrize("code_name", ["steane", "[[72, 12, 6]]", "[[144, 12, 12]]",
                                       "[[288, 12, 18]]"])
def test_k1_launch_warps_follow_the_shared_memory(code_name, shared_priors):
    """K1 runs a sample a warp: eight warps a block for every code the card
    tests cover, [[288,12,18]] included; larger graphs get what a block's
    shared memory holds, and a graph whose one sample does not fit raises."""
    from qldpc_tpu_torch.ops.bp_cuda import launch_warps

    H = get_code(code_name).Hx
    m, n = H.shape
    dc = int(H.sum(axis=1).max())
    warps = launch_warps(m, n, dc, shared_priors)
    assert warps == 8
    per_warp = 4 * (2 * m * dc + n * (1 if shared_priors else 2)) + m
    once = 4 * (n + 2 * m * dc) if shared_priors else 0  # priors, first-iteration table
    assert warps * per_warp + once <= 227 * 1024
    # samples with their own priors: two of 106,200 bytes; shared priors: one
    # of 101,400 beside the block's 100,800 (priors and table)
    assert launch_warps(600, 1200, 20, shared_priors) == (1 if shared_priors else 2)
    assert launch_warps(1000, 2000, 20, False) == 1  # 177,000 bytes a sample
    with pytest.raises(ValueError, match="exceeds a block's shared memory"):
        launch_warps(2000, 4000, 20, shared_priors)


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_mm_bf16_matches_pallas(rng, method):
    code = get_code("[[72, 12, 6]]")
    H, syn, prior = _batch(rng, code, 0.05, 256)
    prior = prior.astype(np.float32)
    cfg = dict(max_iter=25, method=method)
    got = _port(H, syn, prior, mm_dtype="bfloat16", **cfg)
    f32 = _port(H, syn, prior, **cfg)
    ref = JaxBPDecoder(H, JaxBPConfig(backend="pallas", batch_tile=128, mm_dtype="bfloat16",
                                      **cfg))(syn, prior)
    conv = got.converged.numpy()
    resid = (got.hard.numpy().astype(np.int64) @ H.T) % 2
    np.testing.assert_array_equal(resid[conv], syn[conv])
    diff = _decision_mismatches((got.hard, got.converged, got.iterations),
                                (ref.hard, ref.converged, ref.iterations))
    print(f"{method} bf16 operands: converged {conv.sum()} (float32 "
          f"{int(f32.converged.sum())}), {diff} of 256 lanes differ from pallas in decision")
    if method == "min-sum":
        np.testing.assert_array_equal(got.llrs.numpy(), np.asarray(ref.llrs))
        assert diff == 0
    else:
        assert abs(int(conv.sum()) - int(f32.converged.sum())) <= 8
        assert diff <= 6
    # the rounding changes the result: bf16 is not float32
    assert not torch.equal(got.llrs, f32.llrs)


def test_mm_bf16_rounds_where_the_tpu_kernel_rounds(rng):
    """One iteration with damping and clip against the rule applied by hand:
    Q0 = rd(prior), posterior = fold(rd(R)) + prior, and the second
    iteration's Q = clip(d (rd(posterior) - R) + (1 - d) rd(prior))."""
    from qldpc_tpu_torch.ops.bp_cuda import _check_messages, bp_flooding_plain, round_bf16

    code = get_code("[[72, 12, 6]]")
    H, syn, _ = _batch(rng, code, 0.05, 16)
    prior = torch.from_numpy(rng.uniform(1.0, 5.0, (16, code.n)).astype(np.float32))
    cfg = BPConfig(max_iter=2, alpha=0.8, damping=0.7, clip_llr=3.0, mm_dtype="bfloat16")
    t = BPDecoder(H, cfg).tables()
    voe, ve = t.check_var.reshape(-1).long(), t.var_edge.long()
    syn_t = torch.from_numpy(syn)
    ssign = (1 - 2 * syn_t.to(torch.int32)).float()

    def posterior(R):
        rv = torch.cat([round_bf16(R), torch.zeros((16, 1))], dim=1)[:, ve]
        return rv[..., 0] + rv[..., 1] + rv[..., 2] + prior

    Q0 = round_bf16(prior)[:, voe]
    R1 = _check_messages(Q0, ssign, t, cfg, 0.8)
    v1 = posterior(R1)
    Q1 = torch.clamp(0.7 * (round_bf16(v1)[:, voe] - R1) + (1.0 - 0.7) * Q0, -3.0, 3.0)
    v2 = posterior(_check_messages(Q1, ssign, t, cfg, 0.8))
    values, conv, iters, _ = bp_flooding_plain(syn_t, prior, t, cfg)
    want = torch.where((conv & (iters == 0))[:, None], v1, v2)
    torch.testing.assert_close(values, want, rtol=0, atol=0)


_IRREGULAR = np.array([[1, 1, 0, 0], [0, 1, 1, 1], [1, 0, 1, 1]], np.uint8)


@pytest.mark.parametrize("case", [
    "stream-on-regular", "stream-layered-irregular", "stream-damped-irregular",
    "mm-irregular", "mm-layered",
])
def test_bf16_mode_guards_match_jax(case):
    """Each refusal of the bf16 modes is one the JAX decoder makes
    (qldpc_tpu/decoders/bp.py:94-110 and :545-580); on an irregular graph
    both refuse the layered schedule before its stream dtype."""
    regular = get_code("[[72, 12, 6]]").Hx
    H, kw, pattern = {
        "stream-on-regular": (regular, dict(stream_dtype="bfloat16"), "stream_dtype"),
        "stream-layered-irregular": (
            _IRREGULAR, dict(stream_dtype="bfloat16", schedule="layered"), "check-regular"),
        "stream-damped-irregular": (
            _IRREGULAR, dict(stream_dtype="bfloat16", damping=0.7), "stream_dtype"),
        "mm-irregular": (_IRREGULAR, dict(mm_dtype="bfloat16"), "mm_dtype"),
        "mm-layered": (regular, dict(mm_dtype="bfloat16", schedule="layered"), "mm_dtype"),
    }[case]
    with pytest.raises(ValueError, match=pattern):
        JaxBPDecoder(H, JaxBPConfig(max_iter=5, backend="pallas", **kw))
    with pytest.raises(ValueError, match=pattern):
        BPDecoder(H, BPConfig(max_iter=5, **kw))


def test_bf16_modes_accepted_where_jax_accepts_and_refused_in_float64():
    """The bf16 modes run wherever the JAX decoder runs them, with
    ``dtype="float64"`` too: its kernels compute in float32 whatever dtype
    says, and so does the port (no refusal beyond the JAX package's)."""
    regular = get_code("[[72, 12, 6]]").Hx
    for H, kw in ((regular, dict(mm_dtype="bfloat16", damping=0.7, clip_llr=20.0)),
                  (_IRREGULAR, dict(stream_dtype="bfloat16", clip_llr=20.0))):
        JaxBPDecoder(H, JaxBPConfig(max_iter=5, backend="pallas", **kw))
        BPDecoder(H, BPConfig(max_iter=5, **kw))
        JaxBPDecoder(H, JaxBPConfig(max_iter=5, backend="pallas", dtype="float64", **kw))
        assert BPDecoder(H, BPConfig(max_iter=5, dtype="float64", **kw)).dtype == torch.float32
    with pytest.raises(ValueError, match="unknown"):
        BPConfig(stream_dtype="float16")


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_mm_bf16_with_float64_dtype_runs_as_jax(rng, method):
    """bf16 operands with ``dtype="float64"``: the JAX kernel's float32
    arithmetic, as the port's float32 bf16 run gives it bit for bit, held to
    the JAX decoder's float64 config by ``test_mm_bf16_matches_pallas``'s
    standard."""
    code = get_code("[[72, 12, 6]]")
    H, syn, prior = _batch(rng, code, 0.05, 256)
    cfg = dict(max_iter=25, method=method, mm_dtype="bfloat16")
    got = _port(H, syn, prior, dtype="float64", **cfg)
    f32 = _port(H, syn, prior.astype(np.float32), **cfg)
    for g, f in zip(got, f32):
        assert torch.equal(g, f)
    ref = JaxBPDecoder(H, JaxBPConfig(backend="pallas", batch_tile=128, dtype="float64",
                                      **cfg))(syn, prior)
    assert got.llrs.dtype == torch.float32 and np.asarray(ref.llrs).dtype == np.float32
    diff = _decision_mismatches((got.hard, got.converged, got.iterations),
                                (ref.hard, ref.converged, ref.iterations))
    if method == "min-sum":
        np.testing.assert_array_equal(got.llrs.numpy(), np.asarray(ref.llrs))
        assert diff == 0
    else:
        assert diff <= 6
