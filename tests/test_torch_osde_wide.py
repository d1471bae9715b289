"""The port's OSD-e past K4's block against the JAX package's ``lanes`` decoder.

Past the transform's block (``smem_bytes(m) > SMEM_LIMIT``: the [[144,12,12]]
and [[288,12,18]] DEMs, [[288,12,18]] space-time at T = 18) ``auto`` takes
the route ``"factored+transform"``: the factored elimination's OSD-0 on
every sample, its (b, pivoted) for the consistency test, and the transform
elimination on the inconsistent samples and those out of the column budget,
then the search. The JAX decoder runs its XLA transform on every sample.

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
    osd0 = OSDDecoder(H, OSDConfig(max_elim_cols=1))(
        *[torch.from_numpy(x) for x in (syn, llrs, hard)]).numpy()
    assert np.array_equal(osd0[overflow], hard[overflow])


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
    assert np.array_equal(osd0[inconsistent], hard[inconsistent])


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
    (9312, 1, (16, False, 1)),     # the most rows K4g takes
    (9216, 128, (16, False, 16)),  # the per-row state needs 16 blocks
    (7000, 256, (2, False, 4)),
])
def test_k4g_launch_shape_follows_the_shapes(m, B, shape):
    """Past K4's block (1,248 rows) the transform elimination launches K4g:
    a cluster of C blocks of 1,024 threads a sample, a block an SM, on 132
    SMs; C as wide as one wave of clusters allows (16 for at most 7
    samples, else at most 8), wider where the per-row state needs it; T in
    the cluster's shared memory wherever it fits; the grid a multiple of C;
    every block within 227 KB of shared memory."""
    assert osd_module.smem_bytes(m) > osd_module.SMEM_LIMIT >= osd_module.smem_bytes(1248)
    C, t_smem, waves = otc.global_launch_shape(m, B, 132)
    assert (C, t_smem, waves) == shape
    assert otc.launch_shape(m, B, 132) == (otc._GLOBAL_THREADS, 1, waves)
    grid = B * C
    assert grid % C == 0 and waves == -(-grid // 132)
    assert otc.global_smem_bytes(m, C, t_smem) + otc._GLOBAL_STATIC_SMEM <= 227 * 1024
    assert t_smem == (otc.global_smem_bytes(m, C, True) <= otc.GLOBAL_SMEM_LIMIT)
    assert otc.global_launch_shape(m, B, 132, cluster=8)[:2] == (
        8, otc.global_smem_bytes(m, 8, True) <= otc.GLOBAL_SMEM_LIMIT)
    assert otc.t_bytes(m) == m * -(-m // 32) * 4


def test_k4g_refuses_what_it_does_not_take():
    """K4g's wrapper takes CUDA tensors only (the CPU path is the plain
    version, through ``eliminate_transform``), and no system whose per-row
    state passes one block's shared memory at the widest cluster (past
    9,312 rows, so at least the 9,216 of the one-block design; 6,240 fit a
    block), nor a cluster wider than 16."""
    cpu = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs its operands on one CUDA device"):
        otc.eliminate_transform_global_cuda(cpu, cpu, cpu, 1)
    assert otc.global_smem_bytes(9216, 16) <= otc.GLOBAL_SMEM_LIMIT
    assert otc.global_smem_bytes(9312, 16) <= otc.GLOBAL_SMEM_LIMIT < otc.global_smem_bytes(9313, 16)
    assert otc.global_fits(9312) and not otc.global_fits(9313)
    assert otc.global_smem_bytes(6240) <= otc.GLOBAL_SMEM_LIMIT < otc.global_smem_bytes(6241)
    # widened until the per-row state fits a block
    assert otc.global_smem_bytes(7000, 1) > otc.GLOBAL_SMEM_LIMIT >= otc.global_smem_bytes(7000, 2)
    assert otc.global_launch_shape(7000, 256, 132)[0] == 2
    with pytest.raises(ValueError, match="cluster width"):
        otc.global_launch_shape(1728, 4, 132, cluster=32)


def test_decoder_refuses_a_system_k4g_does_not_take(monkeypatch):
    """OSD-e past K4's block on a system K4g's widest cluster does not hold
    is refused when the decoder moves to the card, with a clear error, not
    at its first call; the CPU decodes it. Reached on a small wide system by
    lowering both limits in the test alone."""
    monkeypatch.setattr(osd_module, "SMEM_LIMIT", 0)
    monkeypatch.setattr(otc, "GLOBAL_SMEM_LIMIT", 0)
    H = _random_wide(np.random.default_rng(0))
    dec = OSDDecoder(H, OSDConfig(order=2)).to("cpu")
    assert dec.elimination == "factored+transform" and not otc.global_fits(dec.m)
    with pytest.raises(ValueError, match="needs K4g, whose cluster of 16 blocks"):
        dec._check_device("cuda")
    dec._check_device("cpu")
    OSDDecoder(H, OSDConfig(order=0))._check_device("cuda")  # OSD-0: the factored elimination
