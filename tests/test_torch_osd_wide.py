"""The port's wide-system OSD-0 (transform elimination) against the JAX
package.

Inputs come from numpy seeds: the Steane memory-experiment DEM of the JAX
tests (18 detectors x 267 mechanisms: 9 words against 1, so the transform
path) with BP(8) posteriors as LLRs, and a random wide system. The JAX side
runs its XLA transform elimination (``_eliminate_lanes_T``) and its Pallas
kernel in interpret mode; the port runs its plain torch versions. Every
comparison is bit for bit:

  * without the b-exit, T, b, rank and piv_col equal the batched JAX runs;
  * with the b-exit, a sample stops at its own 32-column boundary, where
    the JAX paths stop their whole batch or lane tile: the port equals the
    JAX elimination vmapped over single samples and the Pallas kernel with
    one-lane tiles and 32-column chunks, and the solutions equal the batched
    runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code
from qldpc_tpu.decoders import BPConfig as JaxBPConfig
from qldpc_tpu.decoders import BPDecoder as JaxBPDecoder
from qldpc_tpu.decoders.osd import OSDConfig as JaxOSDConfig
from qldpc_tpu.decoders.osd import OSDDecoder as JaxOSDDecoder
from qldpc_tpu.noise.circuit import memory_experiment_dem
from qldpc_tpu.ops.osd_transform_pallas import eliminate_transform_pallas
from qldpc_tpu_torch.decoders import OSDDecoder
from qldpc_tpu_torch.ops import osd_transform_cuda as otc

torch.set_num_threads(2)


def _as_u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def steane_dem():
    return memory_experiment_dem(get_code("steane"), p=0.01, rounds=3)


def _random_wide(rng, m=40, n=700):
    """Columns of weight 1-3: rank-deficient wide systems with repeats."""
    H = np.zeros((m, n), np.uint8)
    for j in range(n):
        H[rng.choice(m, size=rng.integers(1, 4), replace=False), j] = 1
    H[-1] = H[0] ^ H[1]  # a dependent row
    return H


def _inputs(rng, kind, dem, B):
    """(H, syndromes, llrs, hard) with BP(8) outputs for the DEM."""
    if kind == "steane-dem":
        H, prob = dem.H, dem.priors
        mech = (rng.random((B, H.shape[1])) < prob).astype(np.int8)
        syn = ((mech.astype(np.int64) @ H.T) % 2).astype(np.int8)
        r = JaxBPDecoder(H, JaxBPConfig(max_iter=8))(jnp.asarray(syn),
                                                      jnp.asarray(dem.llrs, jnp.float32))
        return H, syn, np.array(r.llrs), np.array(r.hard)
    H = _random_wide(rng)
    e = (rng.random((B, H.shape[1])) < 0.02).astype(np.int8)
    syn = ((e.astype(np.int64) @ H.T) % 2).astype(np.int8)
    llrs = rng.normal(2.0, 2.0, (B, H.shape[1])).astype(np.float32)
    llrs[:, ::7] = 1.5  # exact ties: the stable sort decides them
    return H, syn, llrs, (llrs < 0).astype(np.int8)


def _system(H, syn, llrs, hard):
    """The JAX decoder, the permutation and residual both packages eliminate."""
    dec = JaxOSDDecoder(H, JaxOSDConfig(order=0, backend="lanes"))
    assert dec._use_transform
    order = np.array(jnp.argsort(jnp.abs(jnp.asarray(llrs)), axis=1, stable=True))
    resid = (syn.astype(np.int64) + (hard.astype(np.int64) @ H.T)) % 2
    return dec, order, resid


def _port(H, order, resid, b_exit):
    T, b, rank, piv = otc.eliminate_transform(
        torch.from_numpy(order), torch.from_numpy(resid.astype(np.int32)),
        torch.from_numpy(otc.pack_columns(H)), int(JaxOSDDecoder(H)._H_rank), b_exit,
    )
    return _as_u32(T), _as_u32(b), rank.numpy(), piv.numpy()


def _assert_equal(got, ref):
    for name, g, r in zip(("T", "b", "rank", "piv_col"), got, ref):
        assert np.array_equal(g, r), name


@pytest.mark.parametrize("kind", ["steane-dem", "random-wide"])
def test_pack_columns_and_identity_match_jax(rng, steane_dem, kind):
    H = _inputs(rng, kind, steane_dem, 4)[0]
    dec = JaxOSDDecoder(H, JaxOSDConfig(order=0))
    assert np.array_equal(otc.pack_columns(H).view(np.uint32), np.asarray(dec._Hc))
    T0 = otc._identity(2, dec.m, dec.m_words, "cpu")
    assert np.array_equal(_as_u32(T0[1]), np.asarray(dec._T0))


@pytest.mark.parametrize("kind", ["steane-dem", "random-wide"])
def test_transform_elimination_matches_lanes_and_pallas(rng, steane_dem, kind):
    H, syn, llrs, hard = _inputs(rng, kind, steane_dem, 96)
    dec, order, resid = _system(H, syn, llrs, hard)
    b = jnp.asarray(resid.T, jnp.uint32)
    T1, b1, r1, p1 = dec._eliminate_lanes_T(jnp.asarray(order), b)
    ref = (np.asarray(T1).transpose(2, 0, 1), np.asarray(b1).T, np.asarray(r1), np.asarray(p1).T)
    got = _port(H, order, resid, b_exit=False)
    _assert_equal(got, ref)
    assert (got[2] == dec._H_rank).all()
    pal = JaxOSDDecoder(H, JaxOSDConfig(order=0, backend="pallas"))
    T2, b2, r2, p2 = pal._eliminate_lanes_T_pallas(jnp.asarray(order), b)
    _assert_equal(got, (np.asarray(T2).transpose(2, 0, 1), np.asarray(b2).T,
                        np.asarray(r2), np.asarray(p2).T))


@pytest.mark.parametrize("kind", ["steane-dem", "random-wide"])
def test_b_exit_matches_jax_per_sample(rng, steane_dem, kind):
    H, syn, llrs, hard = _inputs(rng, kind, steane_dem, 96)
    dec, order, resid = _system(H, syn, llrs, hard)
    # what OSD sees: samples with a residual syndrome (the BP failures)
    live = resid.any(axis=1)
    order, resid = order[live][:24], resid[live][:24]
    assert len(resid) >= 8
    got = _port(H, order, resid, b_exit=True)
    assert (got[2] < dec._H_rank).any()  # some samples left early

    def one(o, b):
        T, bb, r, p = dec._eliminate_lanes_T(o[None], b[:, None], b_exit=True)
        return T[..., 0], bb[:, 0], r[0], p[:, 0]

    ref = jax.jit(jax.vmap(one))(jnp.asarray(order), jnp.asarray(resid, jnp.uint32))
    _assert_equal(got, tuple(np.asarray(x) for x in ref))

    # the Pallas kernel, one lane per tile and 32-column chunks (it checks
    # its exits after each chunk, not before the first, which only lanes
    # with b = 0 at the start could tell apart)
    n_pad = -(-dec.n // 32) * 32
    hcp = jnp.pad(dec._Hc.T[:, jnp.asarray(order).T], ((0, 0), (0, n_pad - dec.n), (0, 0)))
    T3, b3, r3, p3 = eliminate_transform_pallas(
        hcp, jnp.asarray(resid.T, jnp.uint32), dec._T0, n=dec.n, h_rank=dec._H_rank,
        b_exit=True, col_chunk=32, batch_tile=1, interpret=True,
    )
    _assert_equal(got, (np.asarray(T3).transpose(2, 0, 1), np.asarray(b3).T,
                        np.asarray(r3)[0], np.asarray(p3).T))


@pytest.mark.parametrize("kind", ["steane-dem", "random-wide"])
def test_wide_osd_solutions_match_jax(rng, steane_dem, kind):
    H, syn, llrs, hard = _inputs(rng, kind, steane_dem, 96)
    got = OSDDecoder(H)(torch.from_numpy(syn), torch.from_numpy(llrs),
                        torch.from_numpy(hard))
    assert got.dtype == torch.int8
    for backend in ("lanes", "pallas"):
        ref = JaxOSDDecoder(H, JaxOSDConfig(order=0, backend=backend))(syn, llrs, hard)
        assert np.array_equal(got.numpy(), np.asarray(ref)), backend
    # solutions reproduce every syndrome in the image of H
    s_hat = (got.numpy().astype(np.int64) @ H.T) % 2
    assert (s_hat == syn).all(axis=1).mean() > 0.9


def test_wide_decoder_tables(steane_dem):
    dec = OSDDecoder(steane_dem.H)
    assert dec.wide and dec.m_words == 1 and dec.h_rank == JaxOSDDecoder(steane_dem.H)._H_rank
    assert not hasattr(dec, "Hf")  # no dense H for wide systems
    hard = torch.zeros((3, dec.n), dtype=torch.int32)
    hard[1, 5] = hard[2, 100] = 1
    syn = torch.zeros((3, dec.m), dtype=torch.int8)
    expect = (hard.numpy() @ steane_dem.H.T) % 2
    assert np.array_equal(dec._residual(syn, hard).numpy(), expect)


def test_k4_refuses_what_it_cannot_hold():
    assert otc.smem_bytes(432) < otc.SMEM_LIMIT  # [[72,12,6]] DEM: 30 KB
    assert otc.smem_bytes(1728) > otc.SMEM_LIMIT  # [[144,12,12]] DEM: 385 KB
    cpu = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs its operands on one CUDA device"):
        otc.eliminate_transform_cuda(cpu, cpu, cpu, 1)
    meta = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        otc.eliminate_transform(meta, meta, meta, 1)
