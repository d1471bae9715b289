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
    with pytest.raises(ValueError, match="mm_dtype"):
        bp_config_from_reference({"mm_dtype": "bfloat16"})
    with pytest.raises(ValueError, match="stream_dtype"):
        bp_config_from_reference({"stream_dtype": "bfloat16"})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bp_config_from_reference(JaxBPConfig(schedule="layered"))
    with pytest.raises(ValueError, match="no fields"):
        bp_config_from_reference({"not_a_field": 1})


def test_out_of_slice_features_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BPConfig(schedule="layered")
    H = np.array([[1, 1, 0], [0, 1, 1], [1, 1, 1]], np.uint8)  # irregular checks
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BPDecoder(H)
