"""The port's counter-mode threefry RNG against JAX: bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from qldpc_tpu.noise import channels as jax_channels
from qldpc_tpu.utils.rng import counter_uniform as jax_counter_uniform
from qldpc_tpu_torch.convert import key_from_reference
from qldpc_tpu_torch.noise import channels
from qldpc_tpu_torch.utils import rng

torch.set_num_threads(2)

SEEDS = [0, 1, 7, 12345, 2**31 - 1, 2**32 + 5]
# batch indices up to the top of the uint32 counter word
FOLD_DATA = (0, 1, 3, 2**16 + 3, 10**6, 2**31 - 1, 2**31 + 7, 2**32 - 1)
# the benchmark's rates: the engines key batch b of rate p as
# fold_in(fold_in(key(seed), hash(p) % 2**31), b)
CELL_RATES = (0.001, 0.003, 0.014360, 0.050119, 0.004)


@pytest.mark.parametrize("seed", SEEDS + [2**31 + 12345, 3_000_000_019])
def test_key_and_fold_in(seed):
    k = jax.random.key(seed)
    assert np.array_equal(rng.key(seed).numpy(), np.asarray(jax.random.key_data(k)))
    for data in FOLD_DATA:
        ref = np.asarray(jax.random.key_data(jax.random.fold_in(k, data)))
        got = rng.fold_in(rng.key(seed), data)
        assert got.dtype == torch.int64 and got.shape == (2,)
        assert np.array_equal(got.numpy(), ref)
    for p in CELL_RATES:
        kp, kpt = jax.random.fold_in(k, hash(p) % 2**31), rng.fold_in(rng.key(seed), hash(p) % 2**31)
        for b in (0, 1, 977, 2**20 + 1):
            ref = np.asarray(jax.random.key_data(jax.random.fold_in(kp, b)))
            assert np.array_equal(rng.fold_in(kpt, b).numpy(), ref)


def test_fold_in_is_one_host_block():
    """A batch key is one threefry2x32 block on Python ints: the only torch
    operator it dispatches is the one that builds the output tensor."""

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    kp = rng.fold_in(rng.key(2**31 + 12345), hash(0.014360) % 2**31)
    with Count() as counter:
        rng.fold_in(kp, 10**6)
    assert len(counter.ops) <= 3, counter.ops


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


# ----------------------------------------------------------- keyed draws
# jax.random as JAX 0.9 draws it with jax_threefry_partitionable on (the
# flattened iota's high and low words as counters); the tests run JAX with
# x64 on, so a Python float p is compared in float64, and in float32 under
# jax.enable_x64(False), as the JAX CLI draws it.

KEYED_SEEDS = [0, 7, 12345, 2**31 - 1, 2**32 + 5]
SHAPES = [(1,), (5,), (3, 7), (2, 3, 5), (4, 145)]


@pytest.mark.parametrize("seed", KEYED_SEEDS)
@pytest.mark.parametrize("num", [2, 3, 8])
def test_split(seed, num):
    k = jax.random.fold_in(jax.random.key(seed), 1)
    kt = rng.fold_in(rng.key(seed), 1)
    ref = np.asarray(jax.random.key_data(jax.random.split(k, num)))
    assert np.array_equal(rng.split(kt, num).numpy(), ref)
    # a (batch, 2) tensor of keys splits as jax.vmap(split) does
    ks = jax.random.split(k, 5)
    ref = np.asarray(jax.random.key_data(jax.vmap(lambda kk: jax.random.split(kk, num))(ks)))
    assert np.array_equal(rng.split(rng.split(kt, 5), num).numpy(), ref)


@pytest.mark.parametrize("seed", KEYED_SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_and_bits(seed, shape):
    k = jax.random.key(seed)
    kt = rng.key(seed)
    got = rng.uniform(kt, shape)
    assert got.dtype == torch.float32 and got.shape == shape
    assert np.array_equal(got.numpy(), np.asarray(jax.random.uniform(k, shape, jnp.float32)))
    assert np.array_equal(rng.uniform(kt, shape, torch.float64).numpy(),
                          np.asarray(jax.random.uniform(k, shape, jnp.float64)))
    assert np.array_equal(rng.random_bits(kt, shape).numpy(),
                          np.asarray(jax.random.bits(k, shape, jnp.uint32)).astype(np.int64))
    assert np.array_equal(rng.random_bits(kt, shape, 64).numpy().view(np.uint64),
                          np.asarray(jax.random.bits(k, shape, jnp.uint64)))
    # per-sample keys draw what jax.vmap over the keys draws
    ks = jax.random.split(k, 3)
    ref = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, shape, jnp.float32))(ks))
    assert np.array_equal(rng.uniform(rng.split(kt, 3), shape).numpy(), ref)


@pytest.mark.parametrize("seed", KEYED_SEEDS[:4])
@pytest.mark.parametrize("p", [0.001, 0.01, 0.05, 0.3, 0.5])
def test_bernoulli(seed, p):
    k = jax.random.fold_in(jax.random.key(seed), 2)
    kt = rng.fold_in(rng.key(seed), 2)
    shape = (37, 145)
    ref64 = np.asarray(jax.random.bernoulli(k, p, shape)).astype(np.int8)
    got64 = rng.bernoulli(kt, p, shape, torch.float64)
    assert got64.dtype == torch.int8 and np.array_equal(got64.numpy(), ref64)
    with jax.enable_x64(False):
        ref32 = np.asarray(jax.random.bernoulli(k, p, shape)).astype(np.int8)
    assert np.array_equal(rng.bernoulli(kt, p, shape).numpy(), ref32)


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("code_name,T,q", [("steane", 3, None), ("[[72, 12, 6]]", 4, 0.02)])
def test_sample_space_time_keyed(per_sample, code_name, T, q):
    from qldpc_tpu.codes import get_code
    from qldpc_tpu.noise import spacetime as jax_st
    from qldpc_tpu_torch.noise import spacetime as st

    H = get_code(code_name).Hx
    B, p = 11, 0.03
    k, kt = jax.random.key(9), rng.key(9)
    if per_sample:
        k, kt = jax.random.split(k, B), rng.split(kt, B)
    for x64, dtype in ((True, torch.float64), (False, torch.float32)):
        with jax.enable_x64(x64):
            e_ref, d_ref = jax_st.sample_space_time(k, H, p, B, T, q=q)
        e, d = st.sample_space_time(kt, H, p, B, T, q=q, dtype=dtype)
        assert e.dtype == d.dtype == torch.int8
        assert np.array_equal(e.numpy(), np.asarray(e_ref))
        assert np.array_equal(d.numpy(), np.asarray(d_ref))
