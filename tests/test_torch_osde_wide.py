"""The port's OSD past K4's block against the JAX package's ``lanes`` decoder.

Past the transform's block (``smem_bytes(m) > SMEM_LIMIT``: the [[144,12,12]]
and [[288,12,18]] DEMs, [[288,12,18]] space-time at T = 18) ``auto`` takes
the route ``"factored+transform"`` at every order: the factored
elimination's OSD-0 on every sample, the transform elimination on those out
of the column budget; with OSD-e also its (b, pivoted) for the consistency
test, the transform on the inconsistent samples, then the search. The JAX
decoder runs its XLA transform on every sample.

Small wide systems reach the route by lowering the decoder module's
``SMEM_LIMIT`` (and the budget's ``BUDGET_SLACK``) in the test alone; one
test runs a 1,300-row system past the real block. Inputs come from numpy
seeds; solutions are held as ``test_torch_osde.hold`` holds them: bit for
bit, save at most ``MAX_NEAR_TIES`` float32 cost ties a test, each within
float32 rounding in float64.
"""

import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code
from qldpc_tpu.decoders import BPConfig as JaxBPConfig
from qldpc_tpu.decoders.osd import OSDConfig as JaxOSDConfig
from qldpc_tpu.decoders.osd import OSDDecoder as JaxOSDDecoder
from qldpc_tpu.mc import DEMEngine as JaxDEMEngine
from qldpc_tpu.mc import DEMEngineConfig as JaxDEMEngineConfig
from qldpc_tpu.noise.circuit import parametric_memory_dem
from qldpc_tpu.parallel import make_mesh
from qldpc_tpu_torch.convert import dem_engine_config_from_reference, dem_from_reference
from qldpc_tpu_torch.decoders import OSDConfig, OSDDecoder
from qldpc_tpu_torch.decoders import osd as osd_module
from qldpc_tpu_torch.mc import DEMEngine
from qldpc_tpu_torch.ops.osd_factored_cuda import eliminate_factored_plain
from qldpc_tpu_torch.ops import osd_transform_cuda as otc
from qldpc_tpu_torch.ops.osd_transform_cuda import eliminate_transform_plain
from test_torch_cuda import _rank_deficient_wide
from test_torch_osde import _random_wide, bp_outputs, both, consistent, cost, flipped, hold

torch.set_num_threads(2)

# clusters of 16 K4g blocks an H100 runs at once (the card's own count,
# ``osd_transform_cuda.wide_clusters``)
H100_WIDE_CLUSTERS = 7


@pytest.fixture
def past_the_block(monkeypatch):
    """Every system wide enough for the transform counts as past K4's block."""
    monkeypatch.setattr(osd_module, "SMEM_LIMIT", 0)


def _wide_case(seed: int, B: int = 32, p: float = 0.02):
    rng = np.random.default_rng(seed)
    H = _random_wide(rng)
    syn = flipped(rng, H, p, B)
    llrs, hard = bp_outputs(H, syn, p)
    return H, syn, llrs, hard


def _consistency(H, syn, llrs, hard, max_cols):
    """The factored elimination's verdict and overflow, and the transform
    elimination's verdict, on the decoder's own inputs."""
    dec = OSDDecoder(H)
    hard_t = torch.from_numpy(hard).to(torch.int32)
    resid = dec._residual(torch.from_numpy(syn), hard_t)
    order = torch.argsort(torch.from_numpy(llrs).abs(), dim=1, stable=True)
    Hc = torch.from_numpy(osd_module.factored_columns(H))
    b, pivoted, _, overflow = eliminate_factored_plain(order, resid, Hc, dec.h_rank, max_cols)
    factored = ~((pivoted == 0) & (b != 0)).any(dim=1)
    _, bt, _, pt = eliminate_transform_plain(order, resid, Hc[:H.shape[1]], dec.h_rank,
                                             b_exit=True)
    transform = ~((pt < 0) & (bt != 0)).any(dim=1)
    return factored.numpy(), overflow.numpy(), transform.numpy()


@pytest.mark.parametrize("seed,order,chunk", [(8, 3, 8), (11, 2, 64), (13, 4, 5)])
def test_inconsistent_samples_match_jax(past_the_block, seed, order, chunk):
    """Flipped syndrome bits on a rank-34 system of 40 rows: the searched
    samples equal the JAX lanes decoder's, the consistent ones OSD-0's."""
    H, syn, llrs, hard = _wide_case(seed)
    dec, got, ref, osd0 = both(H, syn, llrs, hard, order=order, chunk=chunk)
    assert dec.elimination == "factored+transform" and dec.h_rank == 34
    hold(got, ref, llrs, hard)
    inconsistent = ~consistent(H, syn, osd0)
    assert inconsistent.sum() >= 8 and (got != osd0).any(axis=1).sum() > 0
    assert np.array_equal(got[~inconsistent], osd0[~inconsistent])
    assert (cost(got, llrs, hard) <= cost(osd0, llrs, hard) + 1e-9).all()


@pytest.mark.parametrize("seed,flips", [(8, 1), (21, 2), (34, 0)])
def test_factored_consistency_equals_the_transforms(seed, flips):
    """Within the column budget, a row without a pivot carrying a syndrome
    bit after the factored elimination marks the same samples as after the
    transform elimination with the b-exit, sample by sample."""
    rng = np.random.default_rng(seed)
    H = _random_wide(rng)
    syn = flipped(rng, H, 0.03, 48, flips)
    llrs, hard = bp_outputs(H, syn, 0.03)
    factored, overflow, transform = _consistency(H, syn, llrs, hard, max_cols=2048)
    assert not overflow.any()
    assert np.array_equal(factored, transform)
    assert factored.any() and (flips == 0 or (~factored).sum() >= 10)


def _late_columns_case(seed: int, B: int = 48):
    """A rank-deficient wide system whose columns touching row 0 are the
    most reliable, so that they come last in every sample's order: within a
    budget of one block (128 columns) no sample reaches rank(H), and a
    sample whose syndrome needs one of them runs out of budget. Syndromes of
    random errors, a third of them with a flipped bit; hard decisions 0."""
    rng = np.random.default_rng(seed)
    H = _random_wide(rng)
    late = H[0] == 1
    m, n = H.shape
    llrs = np.where(late, rng.uniform(20.0, 30.0, (B, n)),
                    rng.uniform(0.5, 5.0, (B, n))).astype(np.float32)
    e = (rng.random((B, n)) < 0.01).astype(np.int64)
    syn = (e @ H.T) % 2
    third = np.arange(B) % 3 == 0
    syn[third, rng.integers(0, m, int(third.sum()))] ^= 1
    return H, syn.astype(np.int8), llrs, np.zeros((B, n), np.int8)


def test_out_of_budget_samples_take_the_transform(past_the_block, monkeypatch):
    """Samples that exhaust the factored column budget (cut to one block by
    the test) take the transform elimination: consistent ones its OSD-0
    solution, which the JAX path, with no budget, gives too; inconsistent
    ones the search."""
    monkeypatch.setattr(osd_module, "BUDGET_SLACK", 0)
    H, syn, llrs, hard = _late_columns_case(5)
    dec, got, ref, _ = both(H, syn, llrs, hard, order=2, max_elim_cols=1)
    assert dec.elimination == "factored+transform" and dec.max_cols == dec.h_rank
    factored, overflow, transform = _consistency(H, syn, llrs, hard, dec.max_cols)
    assert overflow.sum() >= 10 and (overflow & transform).sum() >= 3
    assert (overflow & ~transform).sum() >= 3
    assert np.array_equal(factored[~overflow], transform[~overflow])
    hold(got, ref, llrs, hard)
    # the transform's solution resolves the consistent ones; OSD-0 on the
    # factored elimination alone returns them unchanged
    solved = consistent(H, syn, got)
    assert solved[overflow & transform].all() and not solved[overflow & ~transform].any()
    osd0 = OSDDecoder(H, OSDConfig(max_elim_cols=1, backend="factored"))(
        *[torch.from_numpy(x) for x in (syn, llrs, hard)]).numpy()
    assert np.array_equal(osd0[overflow], hard[overflow])


@pytest.mark.parametrize("seed", [5, 9])
def test_osd0_out_of_budget_samples_match_jax_lanes(past_the_block, monkeypatch, seed):
    """OSD-0 past K4's block: the samples that exhaust the factored column
    budget (cut to rank(H) by the test) take the transform elimination, so
    that ``auto`` returns the JAX lanes path's solution on every sample, bit
    for bit, and solves each consistent one; ``backend="factored"`` returns
    ``hard`` on them, as the JAX factored backend does, and the same
    solution on the others."""
    monkeypatch.setattr(osd_module, "BUDGET_SLACK", 0)
    H, syn, llrs, hard = _late_columns_case(seed)
    args = [torch.from_numpy(x) for x in (syn, llrs, hard)]
    dec = OSDDecoder(H, OSDConfig(max_elim_cols=1))
    assert dec.elimination == "factored+transform" and dec.max_cols == dec.h_rank
    got = dec(*args).numpy()
    ref = np.asarray(JaxOSDDecoder(H, JaxOSDConfig(order=0, backend="lanes"))(syn, llrs, hard))
    assert np.array_equal(got, ref)
    _, overflow, transform = _consistency(H, syn, llrs, hard, dec.max_cols)
    assert overflow.sum() >= 10 and (overflow & transform).sum() >= 3
    assert consistent(H, syn, got)[overflow & transform].all()
    factored = OSDDecoder(H, OSDConfig(max_elim_cols=1, backend="factored"))(*args).numpy()
    assert np.array_equal(factored[overflow], hard[overflow])
    assert np.array_equal(factored[~overflow], got[~overflow])


@pytest.mark.parametrize("route", ["rows", "transform", "factored+transform"])
def test_search_chunk_of_one_equals_chunk_of_64(monkeypatch, route):
    """The samples a search step takes change no solution."""
    if route == "rows":
        H = get_code("[[72, 12, 6]]").Hx
        rng = np.random.default_rng(2)
        syn = flipped(rng, H, 0.05, 24)
        llrs, hard = bp_outputs(H, syn, 0.05)
    else:
        if route == "factored+transform":
            monkeypatch.setattr(osd_module, "SMEM_LIMIT", 0)
        H, syn, llrs, hard = _wide_case(3, B=24)
    args = [torch.from_numpy(x) for x in (syn, llrs, hard)]
    one = OSDDecoder(H, OSDConfig(order=3, chunk=1))
    many = OSDDecoder(H, OSDConfig(order=3, chunk=64))
    assert one.elimination == route
    got = one(*args)
    assert torch.equal(got, many(*args))
    assert (got != OSDDecoder(H)(*args)).any(dim=1).sum() > 0


def test_search_steps_follow_the_workspace_budget(monkeypatch):
    """A step takes at most ``chunk`` samples, and no more than fit
    ``SEARCH_BYTES`` of float64 piv_vals."""
    H, syn, llrs, hard = _wide_case(8)
    dec = OSDDecoder(H, OSDConfig(order=3, chunk=8))
    per_sample = dec.patterns.shape[0] * dec.m * 8
    steps = []
    search_chunk = dec._search_chunk

    def counted(R, *rest):
        steps.append(R.shape[0])
        return search_chunk(R, *rest)

    monkeypatch.setattr(dec, "_search_chunk", counted)
    args = [torch.from_numpy(x) for x in (syn, llrs, hard)]
    ref = dec(*args)
    assert max(steps) == 8 and sum(steps) >= 10
    steps.clear()
    monkeypatch.setattr(osd_module, "SEARCH_BYTES", 3 * per_sample + 1)
    assert torch.equal(dec(*args), ref)
    assert max(steps) == 3


def test_real_size_past_the_block_matches_jax():
    """A 1,300-row wide system (1,300 x 5,400, rank 1,290: its transform is
    past K4's block) with flipped syndrome bits: OSD-e(3) equals the JAX
    lanes decoder's, in-image samples OSD-0's. The inconsistent samples do
    not reach rank(H) within the factored column budget (2,048), so OSD-0
    returns their hard decisions and OSD-e sends them to the transform."""
    rng = np.random.default_rng(1300)
    H = _rank_deficient_wide(rng, 1300, 5400, dependent=10)
    B = 6
    e = (rng.random((B, H.shape[1])) < 0.002).astype(np.int64)
    syn = (e @ H.T) % 2
    # a flipped bit on a dependent row leaves H's image
    syn[np.arange(0, B, 2), rng.integers(1290, 1300, B // 2)] ^= 1
    syn = syn.astype(np.int8)
    llrs = rng.normal(4.0, 2.0, (B, H.shape[1])).astype(np.float32)
    hard = (llrs < 0).astype(np.int8)
    dec, got, ref, osd0 = both(H, syn, llrs, hard, order=3)
    assert dec.elimination == "factored+transform" and dec.m_words == 41
    assert dec.h_rank == 1290 and dec.max_cols == 2048
    hold(got, ref, llrs, hard)
    inconsistent = ~consistent(H, syn, got)  # OSD-e solves every consistent one
    assert np.array_equal(inconsistent, np.arange(B) % 2 == 0)
    assert np.array_equal(got[~inconsistent], osd0[~inconsistent])
    # OSD-0 sends the inconsistent ones, past the budget, through the
    # transform: the JAX lanes path's OSD-0, not their hard decisions
    ref0 = np.asarray(JaxOSDDecoder(H, JaxOSDConfig(backend="lanes"))(syn, llrs, hard))
    assert np.array_equal(osd0, ref0)
    assert (osd0[inconsistent] != hard[inconsistent]).any(axis=1).all()


def test_dem_engine_with_osde_past_the_block_matches_jax(past_the_block):
    """The slice end to end: the Steane memory DEM's engine with OSD-e(7),
    its config carried over from the JAX one by ``convert``, on the route
    past K4's block (the syndromes are in H's image: OSD-e is OSD-0 after
    the factored consistency test), against the JAX DEM engine's lanes
    OSD-e: identical counters (min-sum BP, exact arithmetic)."""
    dem = parametric_memory_dem(get_code("steane"), basis="z", rounds=3)
    cfg = JaxDEMEngineConfig(bp=JaxBPConfig(max_iter=30, method="min-sum"),
                             osd=JaxOSDConfig(order=7), batch_size=256)
    port = DEMEngine(dem_from_reference(dem), dem_engine_config_from_reference(cfg), device="cpu")
    assert port.osd.elimination == "factored+transform" and port.osd.config.order == 7
    ref = JaxDEMEngine(dem, cfg, mesh=make_mesh(1)).run(shots=512, seed=3, p=0.006)
    got = port.run(shots=512, seed=3, p=0.006)
    assert got["BPs_fault"] > 0
    assert got.keys() == ref.keys()
    assert all(np.array_equal(got[k], ref[k]) for k in ref), [
        k for k in ref if not np.array_equal(got[k], ref[k])]


@pytest.mark.parametrize("m,B,shape", [
    (1249, 1, (16, True, 1)),      # the first size past K4's 1,248 rows
    (1249, 4, (16, True, 1)),
    (1249, 128, (1, False, 1)),    # many lanes: a block a sample, T in global memory
    (1300, 48, (2, True, 1)),
    (1728, 1, (16, True, 1)),      # the [[144]] DEM
    (1728, 4, (16, True, 1)),
    (1728, 128, (1, False, 1)),    # phase 14c's lanes
    (1728, 1024, (1, False, 8)),
    (2592, 1, (16, True, 1)),      # [[288]] space-time at T = 18
    (2592, 4, (16, True, 1)),
    (2592, 32, (4, False, 1)),     # phase 24's H_st lanes
    (2592, 128, (1, False, 1)),    # T needs 8 blocks: a block a sample, T in global memory
    (2592, 512, (1, False, 4)),
    (5184, 1, (16, False, 1)),     # the [[288]] DEM: T in global memory at every width
    (5184, 4, (16, False, 1)),     # phase 23b's lanes
    (5184, 18, (4, False, 1)),     # phase 23's batch past the factored budget
    (5184, 128, (1, False, 1)),
    (5184, 1024, (1, False, 8)),
    (9312, 1, (16, False, 1)),     # the most rows of the shared layout
    (9216, 128, (16, False, 16)),  # the per-row state needs 16 blocks
    (7000, 256, (2, False, 4)),
    (9313, 2, (16, False, 1)),     # the spilled layout: the first size past it
    (9313, 200, (1, False, 2)),    # 17 bytes a slot: a block holds the sample
    (12288, 2, (16, False, 1)),
    (20736, 2, (16, False, 1)),    # a [[288]] DEM of 72 rounds
    (20736, 19, (4, False, 1)),    # the samples of 1 GiB of its T
    (32768, 2, (16, False, 1)),
    (92672, 1, (16, False, 1)),    # the largest one-sample T within 1 GiB
    (92672, 40, (8, False, 3)),    # the per-slot state needs 8 blocks
])
def test_k4g_launch_shape_follows_the_shapes(m, B, shape):
    """Past K4's block (1,248 rows) the transform elimination launches K4g:
    a cluster of C blocks of 1,024 threads a sample, a block an SM, on 132
    SMs; C as wide as one wave of clusters allows (16 where the card runs
    every sample's cluster of 16 at once, 7 on an H100, else at most 8),
    wider where the per-row state needs it; T in the cluster's shared memory
    wherever it fits, never past 9,312 rows (the spilled layout); the grid a
    multiple of C; every block within 227 KB of shared memory."""
    assert osd_module.smem_bytes(m) > osd_module.SMEM_LIMIT >= osd_module.smem_bytes(1248)
    C, t_smem, waves = otc.global_launch_shape(m, B, 132, H100_WIDE_CLUSTERS)
    assert (C, t_smem, waves) == shape
    assert otc.launch_shape(m, B, 132, H100_WIDE_CLUSTERS) == (otc._GLOBAL_THREADS, 1, waves)
    grid = B * C
    assert grid % C == 0 and waves == -(-grid // 132)
    assert otc.global_smem_bytes(m, C, t_smem) + otc._GLOBAL_STATIC_SMEM <= 227 * 1024
    assert t_smem == (not otc.global_spills(m)
                      and otc.global_smem_bytes(m, C, True) <= otc.GLOBAL_SMEM_LIMIT)
    assert otc.global_launch_shape(m, B, 132, H100_WIDE_CLUSTERS, cluster=8)[:2] == (
        8, not otc.global_spills(m) and otc.global_smem_bytes(m, 8, True) <= otc.GLOBAL_SMEM_LIMIT)
    assert otc.t_bytes(m) == m * -(-m // 32) * 4
    # the spilled layout's workspace: the pairs, their places and U of each
    # block, the leader's list of each sample
    m_pad = -(-m // 32) * 32
    assert otc.global_workspace_words(m, B, C) == (
        3 * m_pad * (B * C + B) if otc.global_spills(m) else 0)


def test_k4g_refuses_what_it_does_not_take():
    """K4g's wrapper takes CUDA tensors only (the CPU path is the plain
    version, through ``eliminate_transform``), no cluster wider than 16, and
    no system whose per-slot state passes one block's shared memory (less
    the 1 KB its static scratch may take) at the widest cluster: past
    217,808 rows, beyond every system whose one-sample T fits the
    decoder's 1 GiB group (92,672 rows). The shared layout takes
    up to 9,312 rows (6,240 in one block); past them the spilled one."""
    cpu = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs its operands on one CUDA device"):
        otc.eliminate_transform_global_cuda(cpu, cpu, cpu, 1)
    assert otc.global_smem_bytes(9216, 16) <= otc.GLOBAL_SMEM_LIMIT
    assert not otc.global_spills(9312) and otc.global_spills(9313)
    assert otc.global_smem_bytes(9312, 16) <= otc.GLOBAL_SMEM_LIMIT
    assert otc.global_smem_bytes(6240) <= otc.GLOBAL_SMEM_LIMIT < otc.global_smem_bytes(6241)
    # widened until the per-row state fits a block
    assert otc.global_smem_bytes(7000, 1) > otc.GLOBAL_SMEM_LIMIT >= otc.global_smem_bytes(7000, 2)
    assert otc.global_launch_shape(7000, 256, 132, H100_WIDE_CLUSTERS)[0] == 2
    # spilled: 17 bytes a slot, 32-bit slots past 65,536 rows
    assert otc.global_smem_bytes(20736, 16) == 17 * 1296
    assert otc.t_bytes(92672) <= osd_module.T_BYTES < otc.t_bytes(92673)
    for m in (9313, 12288, 20736, 32768, 65537, 92672, 217808):
        assert otc.global_fits(m), m
    assert not otc.global_fits(217809)
    assert otc.global_smem_bytes(217809, 16) > otc.GLOBAL_SMEM_LIMIT
    assert otc.global_smem_bytes(217809, 16, True) > otc.GLOBAL_SMEM_LIMIT  # T never in it
    with pytest.raises(ValueError, match="cluster width"):
        otc.global_launch_shape(1728, 4, 132, H100_WIDE_CLUSTERS, cluster=32)
    # K4g's shape needs the card's count of clusters of 16; K4's does not
    with pytest.raises(ValueError, match="wide_clusters"):
        otc.launch_shape(1728, 4, 132)
    assert otc.launch_shape(1248, 4, 132)[0] == 512


@pytest.mark.parametrize("mw,step", [(1, 5), (2, 3), (7, 4), (54, 64), (163, 9)])
def test_folded_column_bits_equal_the_word_loop(mw, step):
    """The card's halving fold of the RREF bits (every word width, odd or
    even, and chunks of rows that do not divide the rows) equals the word
    loop the CPU runs, bit for bit."""
    rng = np.random.default_rng(mw)
    T = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 40, mw), dtype=np.int64).astype(np.int32))
    Hc = torch.from_numpy(rng.integers(-2**31, 2**31, (90, mw), dtype=np.int64).astype(np.int32))
    cols = torch.from_numpy(rng.integers(0, 90, (3, 32)))
    want = otc.column_bits(T, Hc, cols)
    assert torch.equal(otc._column_bits_folded(T, Hc[cols], step), want)


def test_synthetic_wide_systems_pack_the_dense_ones():
    """chip_smoke.py's packed construction of the synthetic systems past
    9,312 rows equals the dense one the card tests use, packed; its lanes'
    residuals are H (e + hard), the even ones off H's image."""
    import chip_smoke

    for m, n, dependent in ((70, 400, 3), (300, 1300, 8)):
        H = _rank_deficient_wide(np.random.default_rng(m), m, n, dependent)
        Hc = chip_smoke.synthetic_wide(m, n, dependent, m)
        assert np.array_equal(Hc, otc.pack_columns(H))
        order, resid = chip_smoke.synthetic_lanes(Hc, m, 4, 5)
        rng = np.random.default_rng(5)
        e = rng.random((4, n)) < 0.002
        llrs = rng.normal(4.0, 2.0, (4, n)).astype(np.float32)
        want = ((e ^ (llrs < 0)).astype(np.int64) @ H.T.astype(np.int64)) % 2
        want[::2, -1] ^= 1
        assert np.array_equal(resid, want)
        assert np.array_equal(order, np.argsort(np.abs(llrs), axis=1, kind="stable"))


def test_decoder_refuses_a_system_k4g_does_not_take(monkeypatch):
    """OSD past K4's block on a system K4g's widest cluster does not hold
    (past 217,808 rows) is refused when the decoder moves to the card, with
    a clear error, not at its first call; the CPU decodes it. Reached on a
    small wide system by lowering both limits in the test alone."""
    monkeypatch.setattr(osd_module, "SMEM_LIMIT", 0)
    monkeypatch.setattr(otc, "GLOBAL_SMEM_LIMIT", 0)
    H = _random_wide(np.random.default_rng(0))
    for order in (2, 0):  # OSD-0 sends the samples past the budget to K4g too
        dec = OSDDecoder(H, OSDConfig(order=order)).to("cpu")
        assert dec.elimination == "factored+transform" and not otc.global_fits(dec.m)
        with pytest.raises(ValueError, match="needs K4g, whose cluster of 16 blocks"):
            dec._check_device("cuda")
        dec._check_device("cpu")
    # the JAX factored backend's OSD-0 (out-of-budget samples returned as
    # hard) needs no K4g
    OSDDecoder(H, OSDConfig(backend="factored"))._check_device("cuda")
