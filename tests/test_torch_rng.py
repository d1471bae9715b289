"""The port's counter-mode threefry RNG against JAX: bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpc_tpu.noise import channels as jax_channels
from qldpc_tpu.utils.rng import counter_uniform as jax_counter_uniform
from qldpc_tpu_torch.convert import key_from_reference
from qldpc_tpu_torch.noise import channels
from qldpc_tpu_torch.utils import rng

torch.set_num_threads(2)

SEEDS = [0, 1, 7, 12345, 2**31 - 1, 2**32 + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in(seed):
    k = jax.random.key(seed)
    assert np.array_equal(rng.key(seed).numpy(), np.asarray(jax.random.key_data(k)))
    for data in (0, 1, 3, 2**31 - 1):
        ref = np.asarray(jax.random.key_data(jax.random.fold_in(k, data)))
        assert np.array_equal(rng.fold_in(rng.key(seed), data).numpy(), ref)


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("stride", [7, 72, 144, 145])
@pytest.mark.parametrize("base", [0, 3, 4096])
def test_counter_uniform(seed, stride, base):
    kj = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), 11), 2)
    kt = rng.fold_in(rng.fold_in(rng.key(seed), 11), 2)
    ref = np.asarray(jax_counter_uniform(kj, jnp.uint32(base), 37, stride))
    got = rng.counter_uniform(kt, base, 37, stride)
    assert got.dtype == torch.float32 and got.shape == (37, stride)
    assert np.array_equal(got.numpy(), ref)


def test_key_from_reference():
    k = jax.random.fold_in(jax.random.key(3), 9)
    kt = key_from_reference(np.asarray(jax.random.key_data(k)))
    assert np.array_equal(kt.numpy(), rng.fold_in(rng.key(3), 9).numpy())
    with pytest.raises(ValueError):
        key_from_reference(np.zeros(3, np.uint32))


@pytest.mark.parametrize("p", [0.01, 0.05, 0.050119, 0.1])
def test_channels_draw_the_same_errors(p):
    kj = jax.random.fold_in(jax.random.key(5), 1)
    kt = rng.fold_in(rng.key(5), 1)
    p32 = jnp.float32(p)
    n, m, B = 72, 36, 64
    assert np.array_equal(
        channels.code_capacity(kt, 0, p, B, n).numpy(),
        np.asarray(jax_channels.code_capacity(kj, jnp.uint32(0), p32, B, n)),
    )
    assert np.array_equal(
        channels.doubled_channel(kt, 0, p, B, n).numpy(),
        np.asarray(jax_channels.doubled_channel(kj, jnp.uint32(0), p32, B, n)),
    )
    e_t, f_t = channels.phenomenological(kt, 0, p, B, n, m, q=0.02)
    e_j, f_j = jax_channels.phenomenological(kj, jnp.uint32(0), p32, B, n, m, q=0.02)
    assert np.array_equal(e_t.numpy(), np.asarray(e_j))
    assert np.array_equal(f_t.numpy(), np.asarray(f_j))
