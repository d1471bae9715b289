"""The port's check messages and Alvarado alpha fit against the JAX package.

``BPDecoder.check_messages`` is held to the JAX decoder's on the same
numpy-seeded syndromes: the [[72,12,6]] code (edge layout) and the Steane
memory DEM (check-slot layout, mapped back to edge order), at_iter 0 and 2,
float32 and float64. Min-sum without alpha is exact arithmetic: identical.
With alpha = 0.8 after two iterations the messages round in each package's
order: within 1e-5 absolute in float32 (measured 1.1e-6, where a posterior
cancels its message) and 1e-14 in float64 (measured 4.4e-16). Sum-product goes
through XLA's and torch's own tanh/atanh: within 1e-3 absolute in float32
(measured 1.8e-4 at |R| up to 8.7) and 1e-11 in float64 (measured 2e-12).

``estimate_alpha`` draws its errors with the keyed ``jax.random.bernoulli``
bit for bit: float32 draws as the JAX package makes them without x64, and
float64 draws as it makes them with x64. Min-sum alphas are identical;
sum-product alphas agree within 1e-6 relative (measured 7.6e-8).
"""

import jax
import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code
from qldpc_tpu.decoders import BPConfig as JaxBPConfig
from qldpc_tpu.decoders import BPDecoder as JaxBPDecoder
from qldpc_tpu.decoders.alvarado import estimate_alpha as jax_estimate_alpha
from qldpc_tpu.noise.circuit import memory_experiment_dem
from qldpc_tpu_torch.decoders import BPConfig, BPDecoder
from qldpc_tpu_torch.decoders.alvarado import estimate_alpha

torch.set_num_threads(2)

C72 = "[[72, 12, 6]]"


@pytest.fixture(scope="module")
def steane_dem():
    return memory_experiment_dem(get_code("steane"), p=0.01, rounds=3)


def _graph(kind, dem):
    if kind == "72":
        H = get_code(C72).Hx
        return H, np.full(H.shape[1], np.log(19.0))
    return dem.H, dem.llrs


@pytest.mark.parametrize("kind", ["72", "steane-dem"])
@pytest.mark.parametrize("method", ["min-sum", "sum-product"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("at_iter", [0, 2])
def test_check_messages_match_jax(kind, method, dtype, at_iter, steane_dem):
    H, prior = _graph(kind, steane_dem)
    rng = np.random.default_rng(7)
    e = (rng.random((32, H.shape[1])) < 0.05).astype(np.int64)
    syn = ((e @ H.T) % 2).astype(np.int8)
    prior = prior.astype(dtype)
    for alpha in (1.0, 0.8):
        ref = np.asarray(JaxBPDecoder(H, JaxBPConfig(
            max_iter=1, method=method, alpha=alpha, dtype=dtype)).check_messages(
                syn, prior, at_iter=at_iter))
        dec = BPDecoder(H, BPConfig(max_iter=1, method=method, alpha=alpha, dtype=dtype))
        got = dec.check_messages(torch.from_numpy(syn), torch.from_numpy(prior),
                                 at_iter=at_iter).numpy()
        assert got.shape == ref.shape == (32, dec.graph.num_edges) and got.dtype == ref.dtype
        if method == "sum-product":
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-3 if dtype == "float32" else 1e-11)
        elif alpha == 1.0 or at_iter == 0:
            assert np.array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-5 if dtype == "float32" else 1e-14)


def test_first_iteration_min_sum_is_the_check_rule_in_edge_order():
    """One min-sum pass from the prior: each edge's message is the product
    of the other edges' signs times the smaller of the others' magnitudes."""
    H = get_code("steane").Hx
    m, n = H.shape
    prior = np.full(n, np.log(19.0))
    rng = np.random.default_rng(1)
    syn = (((rng.random((8, n)) < 0.05).astype(np.int64) @ H.T) % 2).astype(np.int8)
    dec = BPDecoder(H, BPConfig(max_iter=1, method="min-sum", dtype="float64"))
    R = dec.check_messages(torch.from_numpy(syn), torch.from_numpy(prior)).numpy()
    g = dec.graph
    want = (1 - 2 * syn[:, g.check_of_edge]) * prior[0]  # every |Q| is the prior
    assert np.array_equal(R, want)


@pytest.mark.parametrize("x64", [False, True])
@pytest.mark.parametrize("p", [0.03, 0.06])
def test_min_sum_alpha_equals_jax(x64, p):
    H = get_code(C72).Hx
    with jax.enable_x64(x64):
        ref = jax_estimate_alpha(H, p, trials=3000, seed=5)
    got = estimate_alpha(H, p, trials=3000, seed=5, device="cpu",
                         draw_dtype=torch.float64 if x64 else torch.float32)
    assert got == ref
    assert 0.1 < got < 1.2


@pytest.mark.parametrize("x64", [False, True])
def test_sum_product_alpha_within_tolerance(x64):
    H = get_code(C72).Hx
    with jax.enable_x64(x64):
        ref = jax_estimate_alpha(H, 0.03, trials=2048, seed=1, method="sum-product")
    got = estimate_alpha(H, 0.03, trials=2048, seed=1, method="sum-product", device="cpu",
                         draw_dtype=torch.float64 if x64 else torch.float32)
    assert abs(got - ref) <= 1e-6 * abs(ref)


def test_alpha_deterministic_for_seed_and_runs_on_the_card_by_default(monkeypatch):
    H = get_code("steane").Hx
    a1 = estimate_alpha(H, 0.08, trials=1000, seed=3, device="cpu")
    a2 = estimate_alpha(H, 0.08, trials=1000, seed=3, device="cpu")
    assert a1 == a2
    assert estimate_alpha(H, 0.08, trials=1000, seed=4, device="cpu") != a1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        estimate_alpha(H, 0.08, trials=16)
