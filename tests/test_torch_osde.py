"""The port's OSD-e (order > 0) against the JAX package's ``lanes`` decoder.

Inputs come from numpy seeds; BP posteriors come from the port's plain BP
(min-sum) so that the LLRs hold the magnitudes BP gives, ties included. The
JAX decoder runs its lanes path on the CPU (its XLA elimination, and its XLA
transform elimination on wide systems); the port runs its plain torch
versions: the row elimination with K2's packed-rows loader's plain version
on the searched samples, and the transform elimination.

Solutions are held bit for bit, save at ties. The JAX search sums its
costs in float32, in XLA's order; the port sums the same float32 LLRs in
float64, exactly in any order, so that patterns of equal cost tie on every
device and the first one wins. Min-sum posteriors repeat magnitudes, so two
patterns can flip the same multiset of LLRs: where JAX's float32 rounding
then prefers the later one, the two packages differ. ``hold`` accepts a
differing sample when the float64 costs of the two choices are within
float32 rounding of each other (relative 2^-20), and at most
``MAX_NEAR_TIES`` of them in a test (measured: 2 of 40 in
``test_inconsistent_rows_path_matches_jax[4-6-40-7-1]``, exact ties, and
none elsewhere; ROADMAP.md Queue 3). Every OSD-e cost is at most the OSD-0
cost of its sample, which the zero pattern (listed first) is.
"""

import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code
from qldpc_tpu.decoders.osd import OSDConfig as JaxOSDConfig
from qldpc_tpu.decoders.osd import OSDDecoder as JaxOSDDecoder
from qldpc_tpu.decoders.osd import make_flip_patterns as jax_patterns
from qldpc_tpu.noise.circuit import memory_experiment_dem
from qldpc_tpu_torch.decoders import BPConfig, BPDecoder, OSDConfig, OSDDecoder
from qldpc_tpu_torch.decoders.osd import make_flip_patterns
from qldpc_tpu_torch.noise.spacetime import space_time_matrix

torch.set_num_threads(2)

C72 = "[[72, 12, 6]]"
MAX_NEAR_TIES = 2  # differing samples allowed in a test (measured: 2 of 40 in one)
TIE_RTOL = 2.0**-20  # float32 rounding of a cost


def cost(H_sol: np.ndarray, llrs: np.ndarray, hard: np.ndarray) -> np.ndarray:
    """The search's cost of each solution in float64: sum over the bits it
    flips from ``hard`` of |llr| * (1 - 2 * hard)."""
    w = np.abs(llrs.astype(np.float64)) * (1.0 - 2.0 * hard)
    return ((H_sol.astype(np.int64) ^ hard.astype(np.int64)) * w).sum(axis=1)


def hold(got: np.ndarray, ref: np.ndarray, llrs, hard) -> None:
    """Solutions identical, save near-ties as the module docstring says."""
    differ = np.flatnonzero((got != ref).any(axis=1))
    cg, cr = cost(got[differ], llrs[differ], hard[differ]), cost(ref[differ], llrs[differ],
                                                                 hard[differ])
    far = np.abs(cg - cr) > TIE_RTOL * np.maximum(np.abs(cg), np.abs(cr))
    assert not far.any(), f"samples {differ[far]} differ by more than a near-tie"
    assert len(differ) <= MAX_NEAR_TIES, f"{len(differ)} near-ties: {differ}"


def bp_outputs(H, syn, p, max_iter=8):
    n = H.shape[1]
    res = BPDecoder(H, BPConfig(max_iter=max_iter, method="min-sum"))(
        torch.from_numpy(syn), torch.full((n,), float(np.float32(np.log((1 - p) / p)))))
    return res.llrs.numpy(), res.hard.numpy()


def flipped(rng, H, p, B, flips=1):
    """Syndromes of code-capacity errors with ``flips`` bits flipped each."""
    m, n = H.shape
    e = (rng.random((B, n)) < p).astype(np.int64)
    syn = (e @ H.T) % 2
    for _ in range(flips):
        syn[np.arange(B), rng.integers(0, m, B)] ^= 1
    return syn.astype(np.int8)


def both(H, syn, llrs, hard, **cfg):
    ref = np.asarray(JaxOSDDecoder(H, JaxOSDConfig(backend="lanes", **cfg))(syn, llrs, hard))
    dec = OSDDecoder(H, OSDConfig(**cfg))
    got = dec(torch.from_numpy(syn), torch.from_numpy(llrs), torch.from_numpy(hard)).numpy()
    osd0 = OSDDecoder(H, OSDConfig(order=0))(
        torch.from_numpy(syn), torch.from_numpy(llrs), torch.from_numpy(hard)).numpy()
    return dec, got, ref, osd0


def consistent(H, syn, sol):
    return ((sol.astype(np.int64) @ H.T) % 2 == syn).all(axis=1)


@pytest.mark.parametrize("t,order,max_comb", [(4, 2, None), (6, 3, 5), (17, 7, None),
                                               (12, 4, 300), (3, 5, None), (5, 2, 0)])
def test_flip_patterns_equal_the_jax_ones(t, order, max_comb):
    assert np.array_equal(make_flip_patterns(t, order, max_comb), jax_patterns(t, order, max_comb))


def test_consistent_systems_return_osd0_bit_for_bit():
    """In-image syndromes: OSD-e(7) is OSD-0 untouched, as in the JAX package."""
    H = get_code(C72).Hx
    rng = np.random.default_rng(3)
    e = (rng.random((48, 72)) < 0.06).astype(np.int64)
    syn = ((e @ H.T) % 2).astype(np.int8)
    llrs, hard = bp_outputs(H, syn, 0.06, max_iter=5)
    dec, got, ref, osd0 = both(H, syn, llrs, hard, order=7)
    assert dec.elimination == "rows" and dec.num_test == 17
    assert np.array_equal(got, osd0)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("order,extra,max_comb,chunk,flips", [
    (2, 10, None, 64, 1), (3, 4, None, 5, 2), (7, 10, None, 16, 1), (4, 6, 40, 7, 1)])
def test_inconsistent_rows_path_matches_jax(order, extra, max_comb, chunk, flips):
    """Flipped syndrome bits on [[72,12,6]] (rank 30 of 36 rows): the search
    runs on K2's packed rows of the inconsistent samples."""
    H = get_code(C72).Hx
    rng = np.random.default_rng(order * 10 + flips)
    syn = flipped(rng, H, 0.05, 40, flips)
    llrs, hard = bp_outputs(H, syn, 0.05)
    dec, got, ref, osd0 = both(H, syn, llrs, hard, order=order, extra_positions=extra,
                               max_combinations=max_comb, chunk=chunk)
    assert dec.elimination == "rows"
    hold(got, ref, llrs, hard)
    inconsistent = ~consistent(H, syn, osd0)
    assert inconsistent.sum() >= 20  # the search ran on most samples
    assert (got != osd0).any(axis=1).sum() > 0  # and moved some
    assert np.array_equal(got[~inconsistent], osd0[~inconsistent])
    assert (cost(got, llrs, hard) <= cost(osd0, llrs, hard) + 1e-9).all()


def test_float64_llrs_match_jax():
    """float64 LLRs (JAX promotes its float32 patterns to them)."""
    H = get_code(C72).Hx
    rng = np.random.default_rng(5)
    syn = flipped(rng, H, 0.05, 24)
    llrs = rng.normal(1.0, 2.0, (24, 72))
    hard = (llrs < 0).astype(np.int8)
    _, got, ref, osd0 = both(H, syn, llrs, hard, order=3)
    hold(got, ref, llrs, hard)
    assert (got != osd0).any(axis=1).sum() > 0


def _random_wide(rng, m=40, n=700):
    """Columns of weight 1-3 and six dependent rows: a wide system of rank
    34, where a flipped bit on 18 of the 40 rows leaves the image."""
    H = np.zeros((m, n), np.uint8)
    for j in range(n):
        H[rng.choice(m, size=rng.integers(1, 4), replace=False), j] = 1
    H[-6:] = H[:6] ^ H[6:12]
    return H


def test_inconsistent_transform_path_matches_jax():
    """A wide system (22 words against 2: the transform elimination) of rank
    34 of 40 rows: the search reads the RREF bits as parity(T & Hc)."""
    rng = np.random.default_rng(8)
    H = _random_wide(rng)
    syn = flipped(rng, H, 0.02, 32)
    llrs, hard = bp_outputs(H, syn, 0.02)
    dec, got, ref, osd0 = both(H, syn, llrs, hard, order=3, chunk=8)
    assert dec.wide and dec.elimination == "transform" and dec.h_rank == 34
    hold(got, ref, llrs, hard)
    inconsistent = ~consistent(H, syn, osd0)
    assert inconsistent.sum() >= 10 and (got != osd0).any(axis=1).sum() > 0
    assert np.array_equal(got[~inconsistent], osd0[~inconsistent])
    assert (cost(got, llrs, hard) <= cost(osd0, llrs, hard) + 1e-9).all()


def test_steane_dem_transform_path_matches_jax():
    """The Steane memory DEM (18 x 267, the transform elimination) has full
    row rank: every flipped detector set is still consistent, so OSD-e(3)
    returns OSD-0 there, as in the JAX decoder."""
    dem = memory_experiment_dem(get_code("steane"), p=0.01, rounds=3)
    H = dem.H
    rng = np.random.default_rng(4)
    mech = (rng.random((32, H.shape[1])) < dem.priors).astype(np.int64)
    syn = ((mech @ H.T) % 2).astype(np.int8)
    syn[np.arange(32), rng.integers(0, H.shape[0], 32)] ^= 1
    res = BPDecoder(H, BPConfig(max_iter=8))(torch.from_numpy(syn),
                                            torch.from_numpy(dem.llrs.astype(np.float32)))
    llrs, hard = res.llrs.numpy(), res.hard.numpy()
    dec, got, ref, osd0 = both(H, syn, llrs, hard, order=3)
    assert dec.elimination == "transform" and dec.h_rank == H.shape[0]
    assert np.array_equal(got, ref) and np.array_equal(got, osd0)


def test_space_time_matrix_transform_path_matches_jax():
    """H_st of [[144,12,12]] at T = 12 (864 x 2,592: the transform
    elimination) has full row rank: with syndrome bits flipped every system
    is still consistent and OSD-e(2) is OSD-0, as in the JAX decoder."""
    Hst = space_time_matrix(get_code("[[144, 12, 12]]").Hx, 12)
    rng = np.random.default_rng(12)
    syn = flipped(rng, Hst, 0.005, 6)
    llrs = rng.normal(4.0, 3.0, (6, Hst.shape[1])).astype(np.float32)
    hard = (llrs < 0).astype(np.int8)
    dec, got, ref, osd0 = both(Hst, syn, llrs, hard, order=2)
    assert dec.elimination == "transform" and dec.h_rank == 864
    assert np.array_equal(got, ref) and np.array_equal(got, osd0)
    assert consistent(Hst, syn, got).all()


def test_factored_and_past_the_transform_block_refuse():
    """backend="factored" refuses OSD-e, as in JAX; past K4's block ``auto``
    no longer refuses it (``tests/test_torch_osde_wide.py`` holds the route
    to the JAX decoder)."""
    wide = np.zeros((8, 32 * 5 + 1), np.uint8)
    wide[np.arange(8), np.arange(8)] = 1
    # OSD-0 takes the factored elimination when asked; OSD-e cannot, as in JAX
    assert OSDDecoder(wide, OSDConfig(backend="factored")).elimination == "factored"
    with pytest.raises(ValueError, match="OSD-0 only"):
        OSDDecoder(wide, OSDConfig(order=1, backend="factored"))
    # a 1,300-row wide system: its transform exceeds K4's block, so OSD-0
    # and OSD-e take the factored elimination, then the transform where a
    # sample passes its budget or OSD-e searches; every syndrome is in H's
    # image here
    m = 1300
    big = np.zeros((m, 32 * 4 * 41 * 2), np.uint8)
    big[np.arange(m), np.arange(m)] = 1
    assert OSDDecoder(big).elimination == "factored+transform"
    dec = OSDDecoder(big, OSDConfig(order=1))
    assert dec.elimination == "factored+transform"
    rng = np.random.default_rng(1)
    syn = torch.from_numpy(rng.integers(0, 2, (2, m)).astype(np.int8))
    # H's nonzero columns the least reliable: within the column budget
    llrs = rng.uniform(5.0, 9.0, (2, big.shape[1])).astype(np.float32)
    llrs[:, :m] = rng.normal(0.5, 1.0, (2, m))
    llrs = torch.from_numpy(llrs)
    hard = (llrs < 0).to(torch.int8)
    got = dec(syn, llrs, hard)
    assert torch.equal(got, OSDDecoder(big)(syn, llrs, hard))
    assert consistent(big, syn.numpy(), got.numpy()).all()
    with pytest.raises(ValueError):
        OSDConfig(order=1, chunk=0)
