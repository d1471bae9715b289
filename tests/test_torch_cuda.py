"""The CUDA kernels against their plain torch versions, on the card.

These need an NVIDIA GPU and nvcc, and skip without them. On the card run
them with ``python -m pytest tests/test_torch_cuda.py -q --noconftest``. The
tolerances are those of chip_smoke.py: K1 may differ in decision
(converged, iterations, hard) on at most 1 lane in 10^4 and K3 on at most 1
lane in 1024, with posteriors within rtol = atol = 1e-5 on the other lanes;
K3, K6 and K7 under min-sum, K2, K4 and K5a-d are bit-identical; K6 and K7
under sum-product are held to K1's rule (at least 1 lane allowed); K1, K3,
K6 and K7 propagate a NaN message as the plain versions do. K3's summary
path (the one-pass check rule) equals its message path bit for bit. K5d is
also held on synthetic edge blocks (block 0, no pivot, dense G) at four row
widths, K5c (block 0, no pivot, dense W, each launch geometry) at four and
K5a (empty, heavy and sentinel columns; scur 128, a ragged tile and 2,176)
at four (row tiles of 128, 64 and 32 rows), K5b (C zero, one bit, sparse
and dense; scur 0, 128 and 2,176; empty, heavy and sentinel columns) at
m_pad 32, 1,728 and 5,184 and at every tile of rows, and K2's two
instances and two loaders from Steane to a 673 x 2,656 system, with
rank-deficient systems and an early stop; K6 at cluster widths 1 and
above, rounds that do not divide evenly and a width above T, where every
width gives the default width's bits. K5a-d are also held at every block
of one OSD call on the [[288,12,18]] space-time matrix at T = 18, the
experiments CLI on the card to the same CLI run on the CPU (min-sum:
identical counters), a checkpointed run resumed on the card to an
uninterrupted one, OSD-e on the card (rows and transform paths, and the
route past K4's block) to the CPU bit for bit, and the card's min-sum
Alvarado alpha to the CPU's exactly. K4g (a cluster of blocks a sample) is
held to the plain version at the [[72]] DEM and on systems of 1,249 to 9,312
rows past K4's block, at cluster widths 1 to 16, T in shared and in global
memory, with and without the b-exit, in its spilled layout at 9,313 to
32,768 rows, and the entry point takes it past the block.
K1's bf16-operand instances (``mm_dtype="bfloat16"``) and K3's bf16-stream
instances (``stream_dtype="bfloat16"``, summary and message paths) are held
to their plain versions in bf16 by the same standards, and K3's two bf16
paths to each other bit for bit.
K8 (the sampler's threefry2x32 stream) is bit-identical to the plain int64
``counter_uniform_plain`` at every engine's shape, a counter that wraps past
2^32 and key words with bit 31 set, and each engine's ``_sample`` on the card
equals the CPU's.
``test_k6_geometry_follows_the_state_size`` needs no card.
"""

import ctypes
import math
from dataclasses import replace as dataclasses_replace

import numpy as np
import pytest
import torch

from qldpc_tpu_torch.codes import get_code, gf2
from qldpc_tpu_torch.decoders import BPConfig, BPDecoder, OSDConfig, OSDDecoder
from qldpc_tpu_torch.mc import (
    DEMEngine,
    DEMEngineConfig,
    EngineConfig,
    MonteCarloEngine,
    counters_to_dict,
)
from qldpc_tpu_torch.decoders.spacetime_bp import SpaceTimeBPDecoder
from qldpc_tpu_torch.noise.circuit import memory_experiment_dem, parametric_memory_dem
from qldpc_tpu_torch.noise.spacetime import space_time_matrix, space_time_prior_llr
from qldpc_tpu_torch.ops import osd_cuda, osd_transform_cuda, threefry_cuda
from qldpc_tpu_torch.ops.bp_cuda import bp_flooding_cuda, bp_flooding_plain
from qldpc_tpu_torch.ops.bp_layered_cuda import bp_layered_cuda, bp_layered_plain
from qldpc_tpu_torch.ops.spacetime_bp_cuda import launch_shape, st_bp_cuda, st_bp_plain
from qldpc_tpu_torch.ops.dem_bp_cuda import dem_bp_cuda, dem_bp_plain, summary_path
from qldpc_tpu_torch.ops.osd_cuda import (
    eliminate_rows_cuda,
    eliminate_rows_plain,
    pack_rows,
)
from qldpc_tpu_torch.ops import osd_factored_cuda as ofc
from qldpc_tpu_torch.utils import profiling, rng
from qldpc_tpu_torch.ops.osd_transform_cuda import (
    eliminate_transform_cuda,
    eliminate_transform_plain,
)

pytestmark = pytest.mark.cuda

CODES = ["steane", "[[72, 12, 6]]"]
BP_CASES = {
    "sum-product": BPConfig(max_iter=50),
    "min-sum": BPConfig(max_iter=50, method="min-sum"),
    "min-sum-alpha-offset": BPConfig(max_iter=50, method="min-sum", alpha=0.8, offset=0.1),
    "damped-clipped": BPConfig(max_iter=50, alpha=0.8, damping=0.7, clip_llr=25.0),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _syndromes(code_name, p, B, seed):
    code = get_code(code_name)
    rng = np.random.default_rng(seed)
    errors = (rng.random((B, code.n)) < p).astype(np.int64)
    return code.Hx, ((errors @ code.Hx.T) % 2).astype(np.uint8)


@pytest.mark.parametrize("code_name", CODES)
@pytest.mark.parametrize("case", list(BP_CASES))
def test_k1_matches_plain(cuda, code_name, case):
    cfg = BP_CASES[case]
    B, p = 16384, 0.05
    H, syn_np = _syndromes(code_name, p, B, seed=0)
    dec = BPDecoder(H, cfg).to(cuda)
    syn = torch.from_numpy(syn_np).to(cuda)
    prior = torch.full((H.shape[1],), math.log((1 - p) / p), dtype=torch.float32, device=cuda)
    kv, kc, ki, kh = bp_flooding_cuda(syn, prior, dec.tables(), cfg)
    rv, rc, ri, rh = bp_flooding_plain(syn, prior, dec.tables(), cfg)
    torch.cuda.synchronize()
    differ = (kc != rc) | (ki != ri) | (kh != rh).any(1)
    assert int(differ.sum()) <= 1e-4 * B
    agree = ~differ
    torch.testing.assert_close(kv[agree], rv[agree], rtol=1e-5, atol=1e-5)
    s_hat = (kh.double() @ torch.from_numpy(H.astype(np.float64)).to(cuda).T) % 2
    assert bool((s_hat[kc] == syn[kc].double()).all())


@pytest.mark.parametrize("code_name", CODES)
def test_k2_matches_plain(cuda, code_name):
    B = 4096
    H, syn_np = _syndromes(code_name, 0.1, B, seed=1)
    osd = OSDDecoder(H).to(cuda)
    rng = np.random.default_rng(2)
    order = torch.from_numpy(np.stack([rng.permutation(osd.n) for _ in range(B)])).to(cuda)
    A = pack_rows(torch.from_numpy(H).to(cuda)[:, order].permute(1, 0, 2))
    b = torch.from_numpy(syn_np.astype(np.int32)).to(cuda)
    for max_rank in (None, osd.h_rank):
        got = eliminate_rows_cuda(A, b, osd.n, max_rank)
        ref = eliminate_rows_plain(A, b, osd.n, max_rank)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def _k2_system(case: str, B: int, seed: int):
    """(H, order (B, n), b (B, m)) for a K2 case: a code's Hx, the [[144]]
    code with every row doubled (rank-deficient, m = 144), random systems
    of the shared instance (m = 300 x n = 600, and 673 x 2,656, the widest
    whose column store would not fit a block), each with random column
    orders and a random b."""
    rng = np.random.default_rng(seed)
    if case == "[[144]] doubled rows":
        Hx = get_code("[[144, 12, 12]]").Hx
        H = np.concatenate([Hx, Hx[::-1]])
    elif case.startswith("random"):
        m, n = map(int, case.split()[1].split("x"))
        H = (rng.random((m, n)) < 0.05).astype(np.uint8)
        H[m // 2] = H[0] ^ H[1]  # a dependent row
    else:
        H = get_code(case).Hx
    m, n = H.shape
    order = np.stack([rng.permutation(n) for _ in range(B)])
    b = (rng.random((B, m)) < 0.5).astype(np.int32)
    return H, torch.from_numpy(order), torch.from_numpy(b)


K2_CASES = {  # case: (samples, instance: index of REG_INSTANCES or -1, the shared one)
    "steane": (4096, 0), "[[72, 12, 6]]": (4096, 1), "[[90, 8, 10]]": (2048, 1),
    "[[144, 12, 12]]": (4583, 2), "[[288, 12, 18]]": (1024, 3),
    "[[144]] doubled rows": (1024, 3), "random 300x600": (257, -1), "random 673x2656": (9, -1),
}


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_instances_and_loaders_match_plain(cuda, case):
    """Both K2 instances and both loaders: the packed-rows entry's A, b and
    piv_col against the plain version, the ordered loader's (b, piv_col)
    against the packed-rows entry's and its own plain version, at rank(H)
    and at an early stop below it; nonzero bits beyond column n in the
    packed rows are carried along as the plain version carries them."""
    B, instance = K2_CASES[case]
    H, order, b = _k2_system(case, B, seed=40 + len(case))
    m, n = H.shape
    nw = -(-n // 32)
    assert osd_cuda.launch_instance(m, nw) == instance
    Hc = torch.from_numpy(osd_transform_cuda.pack_columns(H)).to(cuda)
    order, b = order.to(cuda), b.to(cuda)
    A = pack_rows(torch.from_numpy(H).to(cuda)[:, order].permute(1, 0, 2))
    if n % 32:
        A[:, :, -1] |= torch.randint(0, 2, A.shape[:2], device=cuda, dtype=torch.int32) << 31
    rank = int(gf2.rank(H))
    for max_rank in (rank, rank // 2):
        got = eliminate_rows_cuda(A, b, n, max_rank)
        ref = eliminate_rows_plain(A, b, n, max_rank)
        ordered = osd_cuda.eliminate_ordered_cuda(order, b, Hc, max_rank)
        ordered_ref = osd_cuda.eliminate_ordered_plain(order, b, Hc, max_rank)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        assert torch.equal(ordered[0], got[1]) and torch.equal(ordered[1], got[2])
        for g, r in zip(ordered, ordered_ref):
            assert torch.equal(g, r)
        assert int((got[2] >= 0).sum(1).max()) == max_rank


def test_osd_rows_path_launches_the_ordered_loader(cuda):
    """The OSD decoder's rows path runs K2 through its ordered loader alone,
    and its solutions equal the CPU decoder's."""
    H, syn_np = _syndromes("[[144, 12, 12]]", 0.06, 512, seed=5)
    rng = np.random.default_rng(6)
    llrs = np.round(rng.normal(size=(512, H.shape[1])), 1).astype(np.float32)
    hard = (rng.random((512, H.shape[1])) < 0.05).astype(np.int8)
    osd_cuda.eliminate_rows_cuda.launches = osd_cuda.eliminate_ordered_cuda.launches = 0
    args = [torch.from_numpy(x) for x in (syn_np, llrs, hard)]
    got = OSDDecoder(H).to(cuda)(*[x.to(cuda) for x in args])
    ref = OSDDecoder(H)(*args)
    assert osd_cuda.eliminate_ordered_cuda.launches == 1
    assert osd_cuda.eliminate_rows_cuda.launches == 0
    assert torch.equal(got.cpu(), ref)


MIN_SUM = BPConfig(max_iter=30, method="min-sum")
ENGINE_CASES = {
    "osd": dict(bp=MIN_SUM),
    "osd-overflow": dict(bp=MIN_SUM, osd_fraction=0.05),
    "bp-only": dict(bp=MIN_SUM, osd=None),
    "phenomenological-z": dict(bp=MIN_SUM, channel="phenomenological", basis="z"),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_on_card_matches_cpu_engine(cuda, case):
    """Min-sum without alpha is exact arithmetic, so the engine through K1
    and K2 must count exactly what the CPU engine counts through the plain
    versions."""
    cfg = EngineConfig(**{"osd": OSDConfig(), "batch_size": 512, **ENGINE_CASES[case]})
    code = get_code("[[72, 12, 6]]")
    got = counters_to_dict(MonteCarloEngine(code, cfg, device=cuda).run_rate(0.06, 1000, seed=2))
    ref = counters_to_dict(MonteCarloEngine(code, cfg, device="cpu").run_rate(0.06, 1000, seed=2))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_kernels_refuse_what_they_do_not_take(cuda):
    H, syn_np = _syndromes("steane", 0.1, 8, seed=3)
    dec = BPDecoder(H, BPConfig(dtype="float64")).to(cuda)
    with pytest.raises(TypeError, match="float32"):
        dec(torch.from_numpy(syn_np).to(cuda), torch.zeros(7, dtype=torch.float64))
    A = torch.zeros((2, 3, 1), dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        eliminate_rows_cuda(A, torch.zeros((2, 3), dtype=torch.int32, device=cuda), 7)


DEM_BP_CASES = {
    "sum-product": BPConfig(max_iter=50),
    "min-sum": BPConfig(max_iter=50, method="min-sum"),
    "min-sum-alpha-offset-clip": BPConfig(max_iter=50, method="min-sum", alpha=0.8,
                                          offset=0.1, clip_llr=8.0),
    "damped-clipped": BPConfig(max_iter=50, alpha=0.8, damping=0.7, clip_llr=25.0),
}


def _dem_inputs(name, B, seed):
    """(DEM, syndromes, mechanism LLRs) for the Steane DEM (dc_max 75: the
    one-pass check rule) or a [[72,12,6]] DEM cut to 2 rounds (dc <= 16 on
    most checks is not reached there either, so both take the large rule)."""
    dem = (memory_experiment_dem(get_code("steane"), p=0.01, rounds=3) if name == "steane"
           else memory_experiment_dem(get_code("[[72, 12, 6]]"), p=0.002, rounds=2))
    rng = np.random.default_rng(seed)
    mech = (rng.random((B, dem.H.shape[1])) < dem.priors).astype(np.int64)
    syn = ((mech @ dem.H.T) % 2).astype(np.uint8)
    return dem, syn, dem.llrs.astype(np.float32)


def _small_irregular(B, seed):
    """An irregular graph with every check of degree 2..16: the
    prefix/suffix check rule."""
    rng = np.random.default_rng(seed)
    while True:
        H = (rng.random((40, 200)) < 0.04).astype(np.uint8)
        H[:, rng.choice(200, 8, replace=False)] = 0  # mechanisms in no detector
        # a check of degree 1 would send min-sum's infinite magnitude
        if 2 <= H.sum(1).min() and H.sum(1).max() <= 16:
            break
    prob = rng.uniform(0.01, 0.06, 200)
    mech = (rng.random((B, 200)) < prob).astype(np.int64)
    syn = ((mech @ H.T) % 2).astype(np.uint8)
    return H, syn, np.log((1 - prob) / prob).astype(np.float32)


@pytest.mark.parametrize("graph", ["steane", "[[72, 12, 6]]", "small-irregular"])
@pytest.mark.parametrize("case", list(DEM_BP_CASES))
def test_k3_matches_plain(cuda, graph, case):
    cfg = DEM_BP_CASES[case]
    B = 1024
    if graph == "small-irregular":
        H, syn_np, prior_np = _small_irregular(B, seed=4)
    else:
        dem, syn_np, prior_np = _dem_inputs(graph, B, seed=4)
        H = dem.H
    dec = BPDecoder(H, cfg).to(cuda)
    assert dec.slot_layout
    syn = torch.from_numpy(syn_np).to(cuda)
    prior = torch.from_numpy(prior_np).to(cuda)
    kv, kc, ki, kh = dem_bp_cuda(syn, prior, dec.tables(), cfg)
    rv, rc, ri, rh = dem_bp_plain(syn, prior, dec.tables(), cfg)
    torch.cuda.synchronize()
    if cfg.method == "min-sum":
        for g, r in ((kv, rv), (kc, rc), (ki, ri), (kh, rh)):
            assert torch.equal(g, r)
        return
    differ = (kc != rc) | (ki != ri) | (kh != rh).any(1)
    assert int(differ.sum()) <= B / 1024
    agree = ~differ
    torch.testing.assert_close(kv[agree], rv[agree], rtol=1e-5, atol=1e-5)


def test_k3_per_sample_priors_and_alpha(cuda):
    dem, syn_np, _ = _dem_inputs("steane", 256, seed=5)
    cfg = BPConfig(max_iter=30, method="min-sum")
    dec = BPDecoder(dem.H, cfg).to(cuda)
    rng = np.random.default_rng(6)
    prior = torch.from_numpy(rng.uniform(1.0, 9.0, (256, dem.H.shape[1])).astype(np.float32)).to(cuda)
    syn = torch.from_numpy(syn_np).to(cuda)
    got = dem_bp_cuda(syn, prior, dec.tables(), cfg, alpha=0.5)
    ref = dem_bp_plain(syn, prior, dec.tables(), cfg, alpha=0.5)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


SUMMARY_CASES = {
    "sum-product": BPConfig(max_iter=50),
    "sum-product-alpha-clip": BPConfig(max_iter=50, alpha=0.8, clip_llr=12.0),
    "min-sum": BPConfig(max_iter=50, method="min-sum"),
    "min-sum-alpha-offset-clip": BPConfig(max_iter=50, method="min-sum", alpha=0.8,
                                          offset=0.1, clip_llr=8.0),
    "min-sum-damped": BPConfig(max_iter=50, method="min-sum", damping=0.6),
}


@pytest.mark.parametrize("graph", ["steane", "[[72, 12, 6]]"])
@pytest.mark.parametrize("case", list(SUMMARY_CASES))
@pytest.mark.parametrize("B", [1024, 1022])  # four samples a thread, and one
def test_k3_summary_path_equals_message_path(cuda, graph, case, B):
    cfg = SUMMARY_CASES[case]
    dem, syn_np, prior_np = _dem_inputs(graph, B, seed=16)
    dec = BPDecoder(dem.H, cfg).to(cuda)
    assert summary_path(dec.tables(), cfg)
    syn = torch.from_numpy(syn_np).to(cuda)
    prior = torch.from_numpy(prior_np).to(cuda)
    got = dem_bp_cuda(syn, prior, dec.tables(), cfg)
    msg = dem_bp_cuda(syn, prior, dec.tables(), cfg, _store_r=True)
    ref = dem_bp_plain(syn, prior, dec.tables(), cfg)
    torch.cuda.synchronize()
    _assert_same(got, msg)
    kv, kc, ki, kh = got
    rv, rc, ri, rh = ref
    if cfg.method == "min-sum":
        _assert_same(got, ref)
        return
    differ = (kc != rc) | (ki != ri) | (kh != rh).any(1)
    assert int(differ.sum()) <= max(1, B // 1024)
    torch.testing.assert_close(kv[~differ], rv[~differ], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_k3_summary_path_per_sample_priors(cuda, method):
    dem, syn_np, _ = _dem_inputs("steane", 512, seed=17)
    cfg = BPConfig(max_iter=30, method=method, alpha=0.7)
    dec = BPDecoder(dem.H, cfg).to(cuda)
    rng = np.random.default_rng(18)
    prior = torch.from_numpy(rng.uniform(1.0, 9.0, (512, dem.H.shape[1])).astype(np.float32)).to(cuda)
    syn = torch.from_numpy(syn_np).to(cuda)
    got = dem_bp_cuda(syn, prior, dec.tables(), cfg, alpha=0.5)
    _assert_same(got, dem_bp_cuda(syn, prior, dec.tables(), cfg, alpha=0.5, _store_r=True))
    if method == "min-sum":
        _assert_same(got, dem_bp_plain(syn, prior, dec.tables(), cfg, alpha=0.5))


def test_k3_summary_path_propagates_nan_from_a_degree_one_check(cuda):
    """The Steane DEM (dc_max 75) with a check of degree 1 added."""
    dem, syn_np, prior_np = _dem_inputs("steane", 512, seed=19)
    H = np.vstack([dem.H, np.eye(1, dem.H.shape[1], dtype=dem.H.dtype)])
    syn_np = np.hstack([syn_np, np.ones((512, 1), np.uint8)])
    cfg = BPConfig(max_iter=20, method="min-sum", offset=0.1, clip_llr=8.0)
    dec = BPDecoder(H, cfg).to(cuda)
    assert summary_path(dec.tables(), cfg)
    syn, prior = torch.from_numpy(syn_np).to(cuda), torch.from_numpy(prior_np).to(cuda)
    got = dem_bp_cuda(syn, prior, dec.tables(), cfg)
    ref = dem_bp_plain(syn, prior, dec.tables(), cfg)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref[0]).any())
    _assert_same(got, ref)


BF16_DEM_CASES = {name: dataclasses_replace(cfg, stream_dtype="bfloat16")
                  for name, cfg in DEM_BP_CASES.items() if cfg.damping == 1.0}


def _dem_graph(graph, B, seed):
    if graph == "small-irregular":
        return _small_irregular(B, seed)
    dem, syn_np, prior_np = _dem_inputs(graph, B, seed)
    return dem.H, syn_np, prior_np


def _hold_k3(got, ref, method: str, B: int):
    """K3's standard: min-sum bit for bit; sum-product at most 1 lane in 1024
    differing in decision, posteriors of the rest within 1e-5."""
    if method == "min-sum":
        _assert_same(got, ref)
        return
    kv, kc, ki, kh = got
    rv, rc, ri, rh = ref
    differ = (kc != rc) | (ki != ri) | (kh != rh).any(1)
    assert int(differ.sum()) <= max(1, B // 1024)
    torch.testing.assert_close(kv[~differ], rv[~differ], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("graph", ["steane", "[[72, 12, 6]]", "small-irregular"])
@pytest.mark.parametrize("case", list(BF16_DEM_CASES))
def test_k3_bf16_streams_match_plain(cuda, graph, case):
    """Both paths where the summary path applies (their bits equal), the
    message path alone on the prefix x suffix rule."""
    cfg = BF16_DEM_CASES[case]
    B = 1024
    H, syn_np, prior_np = _dem_graph(graph, B, seed=21)
    dec = BPDecoder(H, cfg).to(cuda)
    syn, prior = torch.from_numpy(syn_np).to(cuda), torch.from_numpy(prior_np).to(cuda)
    launched = dem_bp_cuda.bf16_launches
    got = dem_bp_cuda(syn, prior, dec.tables(), cfg)
    assert dem_bp_cuda.bf16_launches == launched + 1
    ref = dem_bp_plain(syn, prior, dec.tables(), cfg)
    torch.cuda.synchronize()
    _hold_k3(got, ref, cfg.method, B)
    if summary_path(dec.tables(), cfg):
        _assert_same(got, dem_bp_cuda(syn, prior, dec.tables(), cfg, _store_r=True))
    # bf16 streams are not float32 streams
    f32 = dem_bp_cuda(syn, prior, dec.tables(), dataclasses_replace(cfg, stream_dtype="float32"))
    assert not torch.equal(got[0], f32[0])


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
@pytest.mark.parametrize("B", [1022, 1024])  # one sample a thread, and four
def test_k3_bf16_summary_path_per_sample_priors(cuda, method, B):
    dem, syn_np, _ = _dem_inputs("steane", B, seed=22)
    cfg = BPConfig(max_iter=30, method=method, alpha=0.7, clip_llr=7.0, stream_dtype="bfloat16")
    dec = BPDecoder(dem.H, cfg).to(cuda)
    rng = np.random.default_rng(23)
    prior = torch.from_numpy(rng.uniform(1.0, 9.0, (B, dem.H.shape[1])).astype(np.float32)).to(cuda)
    syn = torch.from_numpy(syn_np).to(cuda)
    got = dem_bp_cuda(syn, prior, dec.tables(), cfg, alpha=0.5)
    _assert_same(got, dem_bp_cuda(syn, prior, dec.tables(), cfg, alpha=0.5, _store_r=True))
    _hold_k3(got, dem_bp_plain(syn, prior, dec.tables(), cfg, alpha=0.5), method, B)


def test_k3_bf16_propagates_nan_from_a_degree_one_check(cuda):
    H, syn_np, prior_np = _small_irregular(512, seed=8)
    H = np.vstack([H, np.eye(1, H.shape[1], k=int(np.flatnonzero(H.sum(0))[0]), dtype=np.uint8)])
    syn_np = np.hstack([syn_np, np.ones((512, 1), np.uint8)])
    cfg = BPConfig(max_iter=20, method="min-sum", offset=0.1, clip_llr=8.0,
                   stream_dtype="bfloat16")
    dec = BPDecoder(H, cfg).to(cuda)
    syn, prior = torch.from_numpy(syn_np).to(cuda), torch.from_numpy(prior_np).to(cuda)
    got = dem_bp_cuda(syn, prior, dec.tables(), cfg)
    ref = dem_bp_plain(syn, prior, dec.tables(), cfg)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref[0]).any())
    _assert_same(got, ref)


def test_k3_bf16_streams_refuse_damping(cuda):
    dem, syn_np, prior_np = _dem_inputs("steane", 32, seed=24)
    tables = BPDecoder(dem.H).to(cuda).tables()
    cfg = BPConfig(max_iter=5, damping=0.7, stream_dtype="bfloat16")
    with pytest.raises(ValueError, match="damping"):
        dem_bp_cuda(torch.from_numpy(syn_np).to(cuda), torch.from_numpy(prior_np).to(cuda),
                    tables, cfg)


BF16_BP_CASES = {name: dataclasses_replace(cfg, mm_dtype="bfloat16")
                 for name, cfg in BP_CASES.items()}


@pytest.mark.parametrize("code_name", CODES)
@pytest.mark.parametrize("case", list(BF16_BP_CASES))
@pytest.mark.parametrize("priors", ["shared", "per-sample"])
def test_k1_bf16_operands_match_plain(cuda, code_name, case, priors):
    """K1's bf16 instances (the BB codes' compile-time degrees on [[72]],
    the run-time instance on Steane; the block's first-iteration table with
    shared priors) against the plain version in bf16, K1's standard."""
    cfg = BF16_BP_CASES[case]
    B, p = 16384, 0.05
    H, syn_np = _syndromes(code_name, p, B, seed=25)
    dec = BPDecoder(H, cfg).to(cuda)
    syn = torch.from_numpy(syn_np).to(cuda)
    llr = math.log((1 - p) / p)
    if priors == "shared":
        prior = torch.full((H.shape[1],), llr, dtype=torch.float32, device=cuda)
    else:
        rng = np.random.default_rng(26)
        prior = torch.from_numpy(
            rng.uniform(0.5 * llr, 1.5 * llr, (B, H.shape[1])).astype(np.float32)).to(cuda)
    launched = bp_flooding_cuda.bf16_launches
    got = bp_flooding_cuda(syn, prior, dec.tables(), cfg)
    assert bp_flooding_cuda.bf16_launches == launched + 1
    ref = bp_flooding_plain(syn, prior, dec.tables(), cfg)
    torch.cuda.synchronize()
    _hold_bp(got, ref, cfg.method, B)
    kc, kh = got[1], got[3]
    s_hat = (kh.double() @ torch.from_numpy(H.astype(np.float64)).to(cuda).T) % 2
    assert bool((s_hat[kc] == syn[kc].double()).all())
    f32 = bp_flooding_cuda(syn, prior, dec.tables(), dataclasses_replace(cfg, mm_dtype="float32"))
    assert not torch.equal(got[0], f32[0])


@pytest.mark.parametrize("graph", ["steane", "[[72, 12, 6]]"])
@pytest.mark.parametrize("b_exit", [False, True])
def test_k4_matches_plain(cuda, graph, b_exit):
    dem, syn_np, prior_np = _dem_inputs(graph, 512, seed=7)
    cfg = BPConfig(max_iter=10)
    bp = BPDecoder(dem.H, cfg).to(cuda)
    osd = OSDDecoder(dem.H).to(cuda)
    assert osd.wide
    syn = torch.from_numpy(syn_np).to(cuda)
    r = bp(syn, torch.from_numpy(prior_np).to(cuda))
    fail = ~r.converged
    assert int(fail.sum()) > 8
    resid = osd._residual(syn[fail], r.hard[fail].to(torch.int32))
    order = torch.argsort(r.llrs[fail].abs(), dim=1, stable=True)
    got = eliminate_transform_cuda(order, resid, osd.Hc, osd.h_rank, b_exit)
    ref = eliminate_transform_plain(order, resid, osd.Hc, osd.h_rank, b_exit)
    torch.cuda.synchronize()
    for g, r_ in zip(got, ref):
        assert torch.equal(g, r_)


def _rank_deficient_wide(rng, m: int, n: int, dependent: int):
    """Columns of weight 3-6 (a DEM's mechanisms flip a few detectors) on
    the first m - dependent rows; the last ``dependent`` rows are XORs of
    pairs of earlier rows."""
    H = np.zeros((m, n), np.uint8)
    rows = rng.integers(0, m - dependent, (n, 6))
    weight = rng.integers(3, 7, n)
    for k in range(6):
        on = weight > k
        H[rows[on, k], np.flatnonzero(on)] ^= 1
    H[m - dependent:] = H[:dependent] ^ H[dependent:2 * dependent]
    return H


# rows, columns and dependent rows of the synthetic systems past K4's block
# (1,249: the first size past it; 1,728, 2,592 and 5,184: the [[144]] DEM's,
# [[288]] space-time's and the [[288]] DEM's row counts; 9,000: a cluster of
# 16 whose last block holds fewer slots and whose T, in global memory, is
# put in order in several rounds; 9,312: the most K4g's shared layout takes)
K4G_WIDE = {"wide-1249": (1249, 5200, 7), "wide-1300": (1300, 5400, 10),
            "wide-1728": (1728, 7200, 6), "wide-2592": (2592, 10400, 12),
            "wide-5184": (5184, 20800, 6), "wide-9000": (9000, 36200, 8),
            "wide-9312": (9312, 37400, 8)}


@pytest.mark.parametrize("graph", ["[[72, 12, 6]]", *K4G_WIDE])
@pytest.mark.parametrize("b_exit", [False, True])
def test_k4g_matches_plain(cuda, graph, b_exit):
    """K4g against the plain version, bit for bit on T, b, rank and piv: at
    the [[72]] DEM, where K4 also runs, and past K4's block on systems of
    1,249 to 9,312 rows with flipped syndrome bits (half the lanes outside
    H's image), at every cluster width 1 to 16 whose blocks hold the
    per-row state, T in the cluster's shared memory where it fits and in
    global memory; the kernel's shared memory per block equals
    ``global_smem_bytes``."""
    if graph in K4G_WIDE:
        m, n, dependent = K4G_WIDE[graph]
        H = _rank_deficient_wide(np.random.default_rng(m), m, n, dependent)
        rng = np.random.default_rng(5)
        lanes = 48 if m <= 1300 else 8 if m <= 5184 else 4
        e = (rng.random((lanes, H.shape[1])) < 0.002).astype(np.float32)
        syn = ((e @ H.T.astype(np.float32)) % 2).astype(np.int8)
        syn[::2, -1] ^= 1  # a dependent row: outside H's image
        llrs = torch.from_numpy(rng.normal(4.0, 2.0, e.shape).astype(np.float32)).to(cuda)
        hard = (llrs < 0).to(torch.int8)
        syn = torch.from_numpy(syn).to(cuda)
    else:
        dem, syn_np, prior_np = _dem_inputs(graph, 256, seed=7)
        H = dem.H
        syn = torch.from_numpy(syn_np).to(cuda)
        r = BPDecoder(H, BPConfig(max_iter=10)).to(cuda)(syn, torch.from_numpy(prior_np).to(cuda))
        syn, llrs, hard = syn[~r.converged], r.llrs[~r.converged], r.hard[~r.converged]
    osd = OSDDecoder(H).to(cuda)
    resid = osd._residual(syn, hard.to(torch.int32))
    order = torch.argsort(llrs.abs(), dim=1, stable=True)
    Hc = torch.from_numpy(osd_transform_cuda.pack_columns(H)).to(cuda)
    ref = eliminate_transform_plain(order, resid, Hc, osd.h_rank, b_exit)
    k4g = osd_transform_cuda.eliminate_transform_global_cuda
    m = H.shape[0]
    shapes = []
    for C in (1, 2, 4, 8, 16):
        for t_smem in (True, False):
            if osd_transform_cuda.global_smem_bytes(m, C, t_smem) <= \
                    osd_transform_cuda.GLOBAL_SMEM_LIMIT:
                shapes.append((C, t_smem))
    lib = osd_transform_cuda._GLOBAL_LIB.lib
    for C, t_smem in shapes:
        assert lib.gf2_transform_elim_global_smem_bytes(
            m, Hc.shape[1], C, int(t_smem), 0) == osd_transform_cuda.global_smem_bytes(m, C, t_smem)
        got = k4g(order, resid, Hc, osd.h_rank, b_exit, _cluster=C, _t_smem=t_smem)
        torch.cuda.synchronize()
        for name, g, r_ in zip(("T", "b", "rank", "piv"), got, ref):
            assert torch.equal(g, r_), (C, t_smem, name)
    if graph in K4G_WIDE:
        assert bool((ref[2][::2] == osd.h_rank).all())  # the inconsistent ones
    got = k4g(order, resid, Hc, osd.h_rank, b_exit)  # launch_shape's own choice
    assert all(torch.equal(g, r_) for g, r_ in zip(got, ref))


# the synthetic systems past the 9,312 rows of K4g's shared layout (rows,
# columns, dependent rows): chip_smoke.py's WIDE_SIZES and 32,768
K4G_SPILLED = {"wide-9313": (9313, 37400, 8), "wide-12288": (12288, 49300, 8),
               "wide-20736": (20736, 83000, 8), "wide-32768": (32768, 131100, 8)}


@pytest.mark.parametrize("graph", list(K4G_SPILLED))
def test_k4g_matches_plain_past_9312_rows(cuda, graph):
    """K4g's spilled layout (the panel's pairs, U and the leader's list in
    a global workspace, 32-bit slots) against the plain version, bit for bit
    on T, b, rank and piv, with the b-exit, on 2 lanes (one outside H's
    image, walking to rank(H)) of synthetic systems past 9,312 rows (built
    packed by chip_smoke.py), at its launch shape's cluster and at 4 and 8
    blocks; the kernel's shared memory and workspace equal the Python
    mirrors'."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    m, n, dependent = K4G_SPILLED[graph]
    Hc_np = chip_smoke.synthetic_wide(m, n, dependent, m)
    order, resid = (torch.from_numpy(x).to(cuda) for x in chip_smoke.synthetic_lanes(Hc_np, m, 2, 5))
    Hc = torch.from_numpy(Hc_np).to(cuda)
    otc = osd_transform_cuda
    args = (order, resid, Hc, m - dependent, True)
    ref = otc.eliminate_transform_plain(*args)
    assert otc.global_spills(m) and int(ref[2][0]) == m - dependent
    lib = otc._GLOBAL_LIB.lib
    for C in (None, 4, 8):
        got = otc.eliminate_transform_global_cuda(*args, _cluster=C)
        torch.cuda.synchronize()
        for name, g, r_ in zip(("T", "b", "rank", "piv"), got, ref):
            assert torch.equal(g, r_), (C, name)
    for C in (4, 16):
        assert lib.gf2_transform_elim_global_smem_bytes(m, Hc.shape[1], C, 0, 1) == \
            otc.global_smem_bytes(m, C)
    lib.gf2_transform_elim_global_workspace_words.restype = ctypes.c_longlong
    assert lib.gf2_transform_elim_global_workspace_words(2, m, 16, 1) == \
        otc.global_workspace_words(m, 2, 16)
    assert otc.wide_clusters(cuda, m) >= 1
    # every instance's static shared memory within what the mirrors reserve
    for ts, sp in ((1, 0), (0, 0), (0, 1)):
        assert 0 < lib.gf2_transform_elim_global_static_smem(ts, sp) <= otc._GLOBAL_STATIC_SMEM


def test_osde_refuses_what_k4g_does_not_take_on_the_card(cuda, monkeypatch):
    """OSD past K4's block on a system K4g's widest cluster does not hold
    (both limits lowered in the test alone) is refused as the decoder moves
    to the card; with ``backend="factored"`` OSD-0 needs no K4g and moves."""
    from qldpc_tpu_torch.decoders import osd as osd_module

    monkeypatch.setattr(osd_module, "SMEM_LIMIT", 0)
    monkeypatch.setattr(osd_transform_cuda, "GLOBAL_SMEM_LIMIT", 0)
    H = _rank_deficient_wide(np.random.default_rng(2), 40, 700, 4)
    for order in (2, 0):
        with pytest.raises(ValueError, match="needs K4g, whose cluster of 16 blocks"):
            OSDDecoder(H, OSDConfig(order=order)).to(cuda)
    assert OSDDecoder(H, OSDConfig(backend="factored")).to(cuda).elimination == "factored"


def test_eliminate_transform_takes_k4g_past_the_block(cuda):
    """The entry point launches K4 where T fits a block and K4g past it."""
    k4 = osd_transform_cuda.eliminate_transform_cuda
    k4g = osd_transform_cuda.eliminate_transform_global_cuda
    for m, kernel in ((1200, k4), (1300, k4g)):
        H = _rank_deficient_wide(np.random.default_rng(m), m, 4 * 32 * (-(-m // 32)) + 64, 4)
        Hc = torch.from_numpy(osd_transform_cuda.pack_columns(H)).to(cuda)
        rng = np.random.default_rng(m)
        order = torch.from_numpy(np.argsort(rng.random((4, H.shape[1])), axis=1)).to(cuda)
        resid = torch.from_numpy(rng.integers(0, 2, (4, m)).astype(np.int32)).to(cuda)
        before = (k4.launches, k4g.launches)
        osd_transform_cuda.eliminate_transform(order, resid, Hc, m - 4, b_exit=True)
        torch.cuda.synchronize()
        launched = (k4.launches - before[0], k4g.launches - before[1])
        assert launched == ((1, 0) if kernel is k4 else (0, 1))


def test_osde_past_the_block_on_the_card_equals_the_cpu(cuda, monkeypatch):
    """OSD-e on the route past K4's block (the factored elimination, then
    K4g and the search on the inconsistent samples), reached on a small wide
    system by lowering both modules' limits, and on the 1,300-row one at
    the real limits: the card's solutions equal the CPU's bit for bit."""
    from qldpc_tpu_torch.decoders import osd as osd_module

    big = _rank_deficient_wide(np.random.default_rng(6), 1300, 5400, 10)
    rng = np.random.default_rng(8)
    small = np.zeros((40, 700), np.uint8)
    for j in range(700):
        small[rng.choice(40, size=rng.integers(1, 4), replace=False), j] = 1
    small[-6:] = small[:6] ^ small[6:12]
    for H, order, B, patched in ((small, 3, 128, True), (big, 3, 12, False)):
        if patched:
            monkeypatch.setattr(osd_module, "SMEM_LIMIT", 0)
            monkeypatch.setattr(osd_transform_cuda, "SMEM_LIMIT", 0)
        syn, llrs, hard = _flipped_case(H, B, seed=3, p=0.05 if patched else 0.002)
        if not patched:
            syn[::2, -1] ^= 1  # a dependent row: outside H's image
        cpu = OSDDecoder(H, OSDConfig(order=order))
        card = OSDDecoder(H, OSDConfig(order=order)).to(cuda)
        assert card.elimination == "factored+transform"
        k4g = osd_transform_cuda.eliminate_transform_global_cuda
        before = k4g.launches
        got = card(syn.to(cuda), llrs.to(cuda), hard.to(cuda)).cpu()
        assert k4g.launches > before
        assert torch.equal(got, cpu(syn, llrs, hard))
        monkeypatch.undo()


def test_dem_engine_on_card_matches_cpu_engine(cuda):
    dem = parametric_memory_dem(get_code("steane"), basis="z", rounds=3)
    cfg = DEMEngineConfig(bp=MIN_SUM, osd=OSDConfig(), batch_size=512)
    got = DEMEngine(dem, cfg, device=cuda).run(1000, seed=2, p=0.01)
    ref = DEMEngine(dem, cfg, device="cpu").run(1000, seed=2, p=0.01)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _assert_same(got, ref):
    """Bit for bit, a NaN equal to a NaN."""
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("method", ["min-sum", "min-sum-offset-clip"])
def test_k3_propagates_nan_from_a_degree_one_check(cuda, method):
    """Min-sum on a check of degree 1 sends an infinite magnitude; the
    variable side's inf - inf is NaN, which every later check that reads it
    spreads, through min, the offset clamp and the clip."""
    H, syn_np, prior_np = _small_irregular(512, seed=8)
    H = np.vstack([H, np.eye(1, H.shape[1], k=int(np.flatnonzero(H.sum(0))[0]), dtype=np.uint8)])
    syn_np = np.hstack([syn_np, np.ones((512, 1), np.uint8)])
    cfg = (BPConfig(max_iter=20, method="min-sum") if method == "min-sum"
           else BPConfig(max_iter=20, method="min-sum", offset=0.1, clip_llr=8.0))
    dec = BPDecoder(H, cfg).to(cuda)
    syn, prior = torch.from_numpy(syn_np).to(cuda), torch.from_numpy(prior_np).to(cuda)
    got = dem_bp_cuda(syn, prior, dec.tables(), cfg)
    ref = dem_bp_plain(syn, prior, dec.tables(), cfg)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref[0]).any())
    _assert_same(got, ref)


def test_k1_propagates_nan_from_degree_one_checks(cuda):
    """A check-regular graph of degree 1 (every check reads one variable)."""
    H = np.zeros((6, 12), np.uint8)
    H[np.arange(6), 2 * np.arange(6)] = 1
    cfg = BPConfig(max_iter=10, method="min-sum", offset=0.1, clip_llr=8.0)
    dec = BPDecoder(H, cfg).to(cuda)
    rng = np.random.default_rng(9)
    syn = torch.from_numpy((rng.random((256, 6)) < 0.5).astype(np.uint8)).to(cuda)
    prior = torch.full((12,), 2.0, device=cuda)
    got = bp_flooding_cuda(syn, prior, dec.tables(), cfg)
    ref = bp_flooding_plain(syn, prior, dec.tables(), cfg)
    torch.cuda.synchronize()
    _assert_same(got, ref)


def _factored_inputs(cuda, graph, B, seed):
    """(OSD decoder, order, resid) on the BP(10) failures of a DEM."""
    dem, syn_np, prior_np = _dem_inputs(graph, B, seed)
    bp = BPDecoder(dem.H, BPConfig(max_iter=10)).to(cuda)
    osd = OSDDecoder(dem.H, OSDConfig(backend="factored")).to(cuda)
    syn = torch.from_numpy(syn_np).to(cuda)
    r = bp(syn, torch.from_numpy(prior_np).to(cuda))
    fail = ~r.converged
    assert int(fail.sum()) > 8
    resid = osd._residual(syn[fail], r.hard[fail].to(torch.int32))
    order = torch.argsort(r.llrs[fail].abs(), dim=1, stable=True)
    return osd, order, resid


@pytest.mark.parametrize("graph", ["steane", "[[72, 12, 6]]"])
@pytest.mark.parametrize("budget", ["decoder", "one-block"])
def test_k5_matches_plain(cuda, graph, budget):
    osd, order, resid = _factored_inputs(cuda, graph, 512, seed=10)
    max_cols = osd.max_cols if budget == "decoder" else ofc.BLOCK_COLS
    got = ofc.eliminate_factored_cuda(order, resid, osd.Hc, osd.h_rank, max_cols)
    ref = ofc.eliminate_factored_plain(order, resid, osd.Hc, osd.h_rank, max_cols)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


K5 = ("factored_y", "factored_w", "factored_panel_elim", "factored_resolve")


def test_each_k5_kernel_matches_plain_at_every_block(cuda, monkeypatch):
    """Each kernel against its plain version on the state the elimination
    hands it, outputs and in-place state both."""
    osd, order, resid = _factored_inputs(cuda, "[[72, 12, 6]]", 256, seed=11)
    _k5_checked_at_every_block(osd, order, resid, monkeypatch)


def test_k5_matches_plain_at_every_block_on_the_288_h_st(cuda, monkeypatch):
    """K5a-d on the [[288,12,18]] space-time matrix at T = 18 (2,592 x
    7,776), a narrow system the factored elimination takes, on the BP
    failures of the space-time engine at p = 0.008; and the OSD-0 solutions
    equal the plain factored elimination's."""
    eng = MonteCarloEngine(
        get_code("[[288, 12, 18]]"),
        EngineConfig(bp=BPConfig(max_iter=100), channel="space-time", batch_size=256),
        device=cuda,
    )
    assert eng.osd.elimination == "factored+transform" and (eng.m_checks, eng.n_vars) == (2592, 7776)
    from qldpc_tpu_torch.utils import rng

    _, syn, priors = eng._sample(rng.key(4), 0.008)
    r = eng.bp(syn, priors)
    fail = ~r.converged
    assert int(fail.sum()) >= 8
    resid = eng.osd._residual(syn[fail], r.hard[fail].to(torch.int32))
    order = torch.argsort(r.llrs[fail].abs(), dim=1, stable=True)
    _k5_checked_at_every_block(eng.osd, order, resid, monkeypatch)
    got = ofc.eliminate_factored_cuda(order, resid, eng.osd.Hc, eng.osd.h_rank, eng.osd.max_cols)
    ref = ofc.eliminate_factored_plain(order, resid, eng.osd.Hc, eng.osd.h_rank, eng.osd.max_cols)
    for g, x in zip(got, ref):
        assert torch.equal(g, x)


def _k5_checked_at_every_block(osd, order, resid, monkeypatch):
    calls = dict.fromkeys(K5, 0)

    def checked(name, kernel, plain):
        def run(*a):
            kargs = [x.clone() if torch.is_tensor(x) else x for x in a]
            pargs = [x.clone() if torch.is_tensor(x) else x for x in a]
            kout, pout = kernel(*kargs), plain(*pargs)
            torch.cuda.synchronize()
            if kout is not None:
                assert torch.equal(kout, pout), name
            for x, y in zip(kargs, pargs):
                if torch.is_tensor(x):
                    assert torch.equal(x, y), name
            calls[name] += 1
            return kernel(*a)
        run.launches = 0  # the wrapper counts under its module name: here
        return run

    for name in K5:
        monkeypatch.setattr(ofc, f"{name}_cuda", checked(
            name, getattr(ofc, f"{name}_cuda"), getattr(ofc, f"{name}_plain")))
    ofc.eliminate_factored_cuda(order, resid, osd.Hc, osd.h_rank, osd.max_cols)
    assert all(c >= 1 for c in calls.values())


def _resolve_state(mw: int, blk: int, case: str, seed: int, B: int = 48):
    """A K5d input in the port's layout: random P rows, C words with bits
    above D's diagonal, distinct pivot rows (a fifth without a pivot, or
    all of them for "no-pivot"), on 32 of B samples. "sparse" sets about
    0.6% of C's bits (the [[144]] DEM sets under 1%); "dense" half of them,
    so that G references every P row and the staging runs several tiles."""
    rng = np.random.default_rng(seed)
    K, m_pad = ofc.BLOCK_COLS, 32 * mw
    s_max = (blk + 2) * K
    u32 = lambda *shape: rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    P = u32(B, s_max, mw)
    C = u32(B, s_max // 32, m_pad)
    if case != "dense":
        C = np.where(rng.random(C.shape) < 0.05, C & u32(*C.shape) & u32(*C.shape), 0).astype(np.uint32)
    prow = np.stack([rng.permutation(m_pad)[:K] for _ in range(32)]).astype(np.int32)
    prow[rng.random(prow.shape) < 0.2] = m_pad
    if case == "no-pivot":
        prow[:] = m_pad
    lanes = np.sort(rng.choice(B, 32, replace=False)).astype(np.int32)
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x).view(np.int32))
    return to(P), to(C), to(lanes), to(prow)


@pytest.mark.parametrize("mw", [5, 54, 100, 162])  # 4-, 8- and 16-byte copies; 8-64 rows a thread
@pytest.mark.parametrize("blk,case", [(0, "sparse"), (3, "sparse"), (2, "no-pivot"), (4, "dense")])
def test_k5d_matches_plain_on_edge_blocks(cuda, mw, blk, case):
    """Block 0 (no G.P), a block where no column has a pivot, D with bits
    above its diagonal (masked as the JAX kernel masks them), and a dense G
    whose referenced P rows span several staged tiles."""
    P, C, lanes, prow = (t.to(cuda) for t in _resolve_state(mw, blk, case, seed=30 + blk + mw))
    got, ref = P.clone(), P.clone()
    ofc.factored_resolve_cuda(got, C, lanes, prow, blk)
    ofc.factored_resolve_plain(ref, C, lanes, prow, blk)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _u32(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _i32(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


K5C_N = 1000  # column ids below it are real, K5C_N is the sentinel


def _elim_state(mw: int, case: str, seed: int, A: int):
    """A K5c input on A of B = A + 19 samples: W (A, m_pad, 4) of rows half
    set ("dense": 7 in 8), b and pivoted flags (a quarter pivoted), C with
    room for blocks 0-2, ids with a sentinel now and then ("no-pivot": all
    sentinels)."""
    rng = np.random.default_rng(seed)
    K, m_pad, B = ofc.BLOCK_COLS, 32 * mw, A + 19
    W = _u32(rng, A, m_pad, K // 32)
    if case == "dense":
        W |= _u32(rng, *W.shape) | _u32(rng, *W.shape)
    b = _u32(rng, B, mw)
    piv = _u32(rng, B, mw) & _u32(rng, B, mw)
    C = _u32(rng, B, 3 * K // 32, m_pad)
    ids = rng.integers(0, K5C_N + 1, size=(A, K)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.05] = K5C_N
    if case == "no-pivot":
        ids[:] = K5C_N
    lanes = np.sort(rng.choice(B, A, replace=False)).astype(np.int32)
    return tuple(_i32(x) for x in (W, b, piv, C, lanes, ids))


# the samples each case runs, from the card's SM count: the launcher gives
# a sample four warps up to 2 x SMs samples, one warp beyond, and stacks
# samples in a block only past one a SM (on 132 SMs: 29, 198 and 1,017)
K5C_SAMPLES = {"block-0": lambda sms: 29, "no-pivot": lambda sms: 29, "dense": lambda sms: 29,
               "pairs": lambda sms: sms + sms // 2, "stacked": lambda sms: 8 * sms - 39}


@pytest.mark.parametrize("mw", [5, 54, 100, 200])  # one, two, four and eight words a lane
@pytest.mark.parametrize("blk,case", [(0, "block-0"), (1, "no-pivot"), (2, "dense"), (1, "pairs"),
                                      (2, "stacked")])
def test_k5c_matches_plain_on_edge_blocks(cuda, mw, blk, case):
    """Block 0, a block where no column has a pivot, dense W rows, two
    samples of four warps in a block, and up to eight samples of one warp
    in a block (the last block part-full), each at the sample count that
    makes the launcher choose that geometry: b, the pivoted flags, C and
    the pivot rows bit for bit."""
    A = K5C_SAMPLES[case](torch.cuda.get_device_properties(cuda).multi_processor_count)
    state = [t.to(cuda) for t in _elim_state(mw, case, seed=70 + 3 * blk + mw, A=A)]
    got, ref = [t.clone() for t in state], [t.clone() for t in state]
    prow = ofc.factored_panel_elim_cuda(*got[:4], *got[4:], K5C_N, blk)
    prow_ref = ofc.factored_panel_elim_plain(*ref[:4], *ref[4:], K5C_N, blk)
    torch.cuda.synchronize()
    assert torch.equal(prow, prow_ref)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    pivots = int((prow < 32 * mw).sum())
    assert (pivots == 0) == (case == "no-pivot")


def _y_state(mw: int, s_max: int, seed: int, B: int = 24, A: int = 17):
    """A K5a input: P (B, s_max, mw) random, H's packed columns with about
    7 bits each (the [[144]] DEM's mean), an empty column 0, a heavy column
    1 (every bit set) and the zero sentinel column n; ids over all of them,
    the empty, heavy and sentinel columns in every sample."""
    rng = np.random.default_rng(seed)
    n, K, m_pad = 600, ofc.BLOCK_COLS, 32 * mw
    H = np.zeros((n + 1, m_pad), np.uint8)
    for c in range(2, n):
        H[c, rng.choice(m_pad, min(7, m_pad), replace=False)] = 1
    H[1] = 1
    Hc = np.packbits(H.reshape(n + 1, mw, 32), axis=-1, bitorder="little").view(np.uint32)[..., 0]
    ids = rng.integers(0, n + 1, size=(A, K)).astype(np.int32)
    ids[:, :3] = [0, 1, n]
    ids[:, 64:67] = [n, 1, 0]
    lanes = np.sort(rng.choice(B, A, replace=False)).astype(np.int32)
    return tuple(_i32(x) for x in (_u32(rng, B, s_max, mw), lanes, ids, Hc))


# row tiles of 128 (mw 5 and 54), 64 (mw 128) and 32 rows (mw 162): the
# largest whose two buffers fit beside the supports; scur: the first block
# K5a runs, a ragged tile, the [[144]] budget's last
@pytest.mark.parametrize("mw", [5, 54, 128, 162])
@pytest.mark.parametrize("scur", [128, 200, 2176])
def test_k5a_matches_plain_on_edge_blocks(cuda, mw, scur):
    """Empty, heavy and sentinel columns in every sample, at the first
    block, at a scur that ends inside a tile and at the largest scur of the
    [[144]] DEM's budget (2,304 columns)."""
    P, lanes, ids, Hc = (t.to(cuda) for t in _y_state(mw, s_max=2304, seed=90 + mw))
    got = ofc.factored_y_cuda(P, lanes, ids, Hc, scur)
    ref = ofc.factored_y_plain(P, lanes, ids, Hc, scur)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    bits = ofc._unpack(got)
    assert not bits[..., [0, 2, 64, 66]].any() and bool(bits[..., 1].any())


def _w_state(mw: int, scur: int, c_case: str, seed: int, B: int = 24, A: int = 17):
    """A K5b input on A of B samples: C (B, cw, 32 mw) with room for scur
    columns, all zero, one set bit a sample, dense (half the bits) or
    sparse (0.2%, the [[144]] DEM's); Y (A, scur, 4) random; the block
    columns of ``_y_state`` (empty, heavy and sentinel columns in every
    sample)."""
    rng = np.random.default_rng(seed)
    m_pad = 32 * mw
    cw = max(scur // 32, 1) + 2
    _, lanes, ids, Hc = _y_state(mw, s_max=32, seed=seed, B=B, A=A)
    C = np.zeros((B, cw, m_pad), np.uint32)
    sw = scur // 32
    if sw and c_case == "dense":
        C[:, :sw] = _u32(rng, B, sw, m_pad)
    elif sw and c_case == "sparse":  # a sample at a time: the draws of one (B, ...) call
        for s in range(B):
            bits = rng.random((sw, m_pad, 32)) < 0.002
            C[s, :sw] = np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)[..., 0]
    elif sw and c_case == "one-bit":
        for s in range(B):
            C[s, rng.integers(sw), rng.integers(m_pad)] = np.uint32(1) << np.uint32(rng.integers(32))
    C[:, sw:] = _u32(rng, B, cw - sw, m_pad)  # words past scur are never read
    Y = _u32(rng, A, scur, ofc.BLOCK_COLS // 32)
    return _i32(C), lanes, ids, Hc, _i32(Y)


@pytest.mark.parametrize("mw", [1, 54, 162])  # m_pad 32, 1,728 ([[144]] DEM), 5,184 ([[288]])
@pytest.mark.parametrize("scur", [0, 128, 2176])
@pytest.mark.parametrize("c_case", ["zero", "one-bit", "sparse", "dense"])
def test_k5b_matches_plain_on_edge_blocks(cuda, mw, scur, c_case):
    """K5b bit for bit against its plain version on 17 of 24 samples:
    C all zero, one bit, sparse and dense, at the first block, the second
    and the [[144]] budget's last, with empty, heavy and sentinel block
    columns in every sample, at the tile the launcher picks."""
    C, lanes, ids, Hc, Y = (t.to(cuda) for t in _w_state(mw, scur, c_case, seed=110 + mw + scur))
    got = ofc.factored_w_cuda(C, lanes, ids, Hc, Y, scur)
    ref = ofc.factored_w_plain(C, lanes, ids, Hc, Y, scur)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if scur == 0 or c_case == "zero":  # W is H's bits: column 0 empty, column 1 heavy
        assert not bool((got[..., 0] & 1).any()) and bool(((got[..., 0] >> 1) & 1).all())


def _k5b_samples(rows: int, m_pad: int, sms: int) -> int:
    """The fewest running samples for which the launcher picks ``rows``:
    ``w_tile_rows`` takes the largest tile that still gives 2 blocks an SM
    (on 132 SMs at m_pad 1,728: 264, 132, 66, 38, 19, 10 and 5 samples)."""
    return -(-2 * sms // -(-m_pad // rows))


@pytest.mark.parametrize("rows", ofc.W_TILE_ROWS)
@pytest.mark.parametrize("mw", [54, 162])
def test_k5b_matches_plain_at_every_tile(cuda, rows, mw):
    """Every tile of rows K5b can take (R = 1, 2 and 4 rows a thread from
    512 rows, slices of C's words below; tiles ending inside the sample),
    each at the sample count that makes the launcher choose it, on sparse C
    at the [[144]] budget's last block."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    A = _k5b_samples(rows, 32 * mw, sms)
    assert ofc.w_tile_rows(A, 32 * mw, sms) == rows
    C, lanes, ids, Hc, Y = (t.to(cuda) for t in _w_state(mw, 2176, "sparse", seed=150 + mw,
                                                         B=A + 7, A=A))
    got = ofc.factored_w_cuda(C, lanes, ids, Hc, Y, 2176)
    ref = ofc.factored_w_plain(C, lanes, ids, Hc, Y, 2176)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_factored_osd_solutions_match_transform(cuda):
    dem, syn_np, prior_np = _dem_inputs("[[72, 12, 6]]", 512, seed=12)
    bp = BPDecoder(dem.H, BPConfig(max_iter=10)).to(cuda)
    syn = torch.from_numpy(syn_np).to(cuda)
    r = bp(syn, torch.from_numpy(prior_np).to(cuda))
    fail = ~r.converged
    args = (syn[fail], r.llrs[fail], r.hard[fail])
    got = OSDDecoder(dem.H, OSDConfig(backend="factored")).to(cuda)(*args)
    ref = OSDDecoder(dem.H, OSDConfig(backend="transform")).to(cuda)(*args)
    assert torch.equal(got, ref)


def test_dem_engine_factored_on_card_matches_cpu_engine(cuda):
    dem = parametric_memory_dem(get_code("steane"), basis="z", rounds=3)
    cfg = DEMEngineConfig(bp=MIN_SUM, osd=OSDConfig(backend="factored"), batch_size=512)
    got = DEMEngine(dem, cfg, device=cuda).run(1000, seed=2, p=0.01)
    ref = DEMEngine(dem, cfg, device="cpu").run(1000, seed=2, p=0.01)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _hold_bp(got, ref, method: str, B: int):
    """Min-sum bit for bit; sum-product K1's rule: at most 1 lane in 10^4
    (at least 1) differing in decision, posteriors of the rest within 1e-5."""
    kv, kc, ki, kh = got
    rv, rc, ri, rh = ref
    if method == "min-sum":
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        return
    differ = (kc != rc) | (ki != ri) | (kh != rh).any(1)
    assert int(differ.sum()) <= max(1, 1e-4 * B)
    agree = ~differ
    torch.testing.assert_close(kv[agree], rv[agree], rtol=1e-5, atol=1e-5)


def _st_detectors(H, T, p, B, seed):
    m, n = H.shape
    rng = np.random.default_rng(seed)
    e = (rng.random((B, T, n)) < p).astype(np.int64)
    u = (rng.random((B, T, m)) < p).astype(np.int64)
    s = np.einsum("btn,mn->btm", e, H) % 2
    u_prev = np.concatenate([np.zeros_like(u[:, :1]), u[:, :-1]], axis=1)
    return ((s + u + u_prev) % 2).reshape(B, T * m).astype(np.uint8)


ST_CASES = [("steane", 3), ("[[72, 12, 6]]", 6), ("[[144, 12, 12]]", 12)]


@pytest.mark.parametrize("code_name,T", ST_CASES)
@pytest.mark.parametrize("case", list(BP_CASES))
def test_k6_matches_plain(cuda, code_name, T, case):
    cfg = dataclasses_replace(BP_CASES[case], max_iter=40)
    H = get_code(code_name).Hx
    B, p = 512, 0.008
    dec = SpaceTimeBPDecoder(H, T, cfg).to(cuda)
    det = torch.from_numpy(_st_detectors(H, T, p, B, seed=13)).to(cuda)
    priors = space_time_prior_llr(H.shape[1], H.shape[0], T, p, device=cuda)
    got = st_bp_cuda(det, priors, dec.tables(), T, cfg)
    ref = st_bp_plain(det, priors, dec.tables(), T, cfg)
    torch.cuda.synchronize()
    _hold_bp(got, ref, cfg.method, B)
    Hst = torch.from_numpy(space_time_matrix(H, T).astype(np.float32)).to(cuda)
    kc, kh = got[1], got[3]
    assert bool(((kh.float() @ Hst.T) % 2 == det.float())[kc].all())


# (code, T, cluster width): C = 1 and C > 1, T not divisible by C, T < C
K6_CLUSTERS = [("[[144, 12, 12]]", 12, 1), ("[[144, 12, 12]]", 12, 4),
               ("[[144, 12, 12]]", 12, 5), ("[[72, 12, 6]]", 6, 4), ("steane", 3, 2),
               ("steane", 3, 4)]


@pytest.mark.parametrize("code_name,T,C", K6_CLUSTERS)
@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_k6_cluster_widths_match_plain(cuda, code_name, T, C, method):
    """Every cluster width gives the bits of the default width (the same
    operations in the same order) and holds to the plain version."""
    cfg = BPConfig(max_iter=40, method=method)
    H = get_code(code_name).Hx
    B, p = 256, 0.01
    dec = SpaceTimeBPDecoder(H, T, cfg).to(cuda)
    det = torch.from_numpy(_st_detectors(H, T, p, B, seed=21)).to(cuda)
    priors = space_time_prior_llr(H.shape[1], H.shape[0], T, p, device=cuda)
    got = st_bp_cuda(det, priors, dec.tables(), T, cfg, _cluster=C)
    default = st_bp_cuda(det, priors, dec.tables(), T, cfg)
    ref = st_bp_plain(det, priors, dec.tables(), T, cfg)
    torch.cuda.synchronize()
    _assert_same(got, default)
    _hold_bp(got, ref, method, B)


def test_k6_geometry_follows_the_state_size():
    """C from T and a sample's state: [[144]] T = 12 over 4 blocks of three
    rounds, [[288]] T = 18 over 6, small samples several to a block."""
    def shape(code_name, T, **kw):
        dec = SpaceTimeBPDecoder(get_code(code_name).Hx, T, BPConfig(max_iter=10))
        return launch_shape(dec.tables(), T, **kw)

    assert shape("[[144, 12, 12]]", 12) == (1, 4, 448)
    assert shape("[[288, 12, 18]]", 18) == (1, 6, 512)
    assert shape("steane", 3)[:2] == (16, 1)
    assert shape("[[72, 12, 6]]", 6)[:2] == (4, 1)
    assert shape("steane", 3, cluster=4)[:2] == (1, 3)  # clamped to T


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
@pytest.mark.parametrize("C", [None, 1])
def test_k6_mixed_batch_of_early_and_late_samples(cuda, method, C):
    """Samples that converge at once (no errors), early (light errors) and
    samples that run all iterations (heavy errors), shuffled, in a batch
    that is no multiple of the samples a block."""
    cfg = BPConfig(max_iter=30, method=method)
    H, T = get_code("[[144, 12, 12]]").Hx, 12
    rng = np.random.default_rng(22)
    B = 301
    ps = rng.choice([0.0, 0.003, 0.06], size=B, p=[0.3, 0.5, 0.2])
    det = np.concatenate([_st_detectors(H, T, p, 1, seed=100 + i) for i, p in enumerate(ps)])
    det = torch.from_numpy(det).to(cuda)
    priors = space_time_prior_llr(H.shape[1], H.shape[0], T, 0.005, device=cuda)
    dec = SpaceTimeBPDecoder(H, T, cfg).to(cuda)
    got = st_bp_cuda(det, priors, dec.tables(), T, cfg, _cluster=C)
    ref = st_bp_plain(det, priors, dec.tables(), T, cfg)
    torch.cuda.synchronize()
    _hold_bp(got, ref, method, B)
    iters = got[2].cpu().numpy()
    assert (iters == 0).sum() > 10 and (iters == cfg.max_iter - 1).sum() > 10
    assert int((~got[1]).sum()) > 10


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_k6_matches_plain_at_the_288_shape(cuda, method):
    """[[288,12,18]] at T = 18: 207 KB of state a sample, over six blocks."""
    cfg = BPConfig(max_iter=40, method=method)
    H, T, B, p = get_code("[[288, 12, 18]]").Hx, 18, 64, 0.006
    dec = SpaceTimeBPDecoder(H, T, cfg).to(cuda)
    assert launch_shape(dec.tables(), T)[1] == 6
    det = torch.from_numpy(_st_detectors(H, T, p, B, seed=23)).to(cuda)
    priors = space_time_prior_llr(H.shape[1], H.shape[0], T, p, device=cuda)
    got = st_bp_cuda(det, priors, dec.tables(), T, cfg)
    ref = st_bp_plain(det, priors, dec.tables(), T, cfg)
    torch.cuda.synchronize()
    _hold_bp(got, ref, method, B)
    Hst = torch.from_numpy(space_time_matrix(H, T).astype(np.float32)).to(cuda)
    kc, kh = got[1], got[3]
    assert bool(((kh.float() @ Hst.T) % 2 == det.float())[kc].all())


def test_k6_propagates_nan_from_infinite_measurement_priors(cuda):
    """Checks of degree 1 in pairs on one variable, and measurement priors
    of +inf (q = 0): from round 1 on a variable gets +inf and -inf from its
    two checks, and the NaN spreads through min, the offset clamp and the
    clip."""
    H = np.zeros((6, 12), np.uint8)
    H[np.arange(6), 2 * (np.arange(6) // 2)] = 1
    T = 3
    cfg = BPConfig(max_iter=10, method="min-sum", offset=0.1, clip_llr=8.0)
    dec = SpaceTimeBPDecoder(H, T, cfg).to(cuda)
    rng = np.random.default_rng(9)
    det = torch.from_numpy((rng.random((256, 18)) < 0.5).astype(np.uint8)).to(cuda)
    priors = space_time_prior_llr(12, 6, T, 0.05, q=0.0, device=cuda)
    got = st_bp_cuda(det, priors, dec.tables(), T, cfg)
    ref = st_bp_plain(det, priors, dec.tables(), T, cfg)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref[0]).any())
    _assert_same(got, ref)


@pytest.mark.parametrize("code_name,L", [("steane", 0), ("[[72, 12, 6]]", 0),
                                         ("[[72, 12, 6]]", 3), ("[[144, 12, 12]]", 0)])
@pytest.mark.parametrize("case", ["sum-product", "min-sum", "min-sum-alpha-offset"])
def test_k7_matches_plain(cuda, code_name, L, case):
    cfg = dataclasses_replace(BP_CASES[case], schedule="layered", n_layers=L)
    B, p = 16384, 0.05
    H, syn_np = _syndromes(code_name, p, B, seed=14)
    dec = BPDecoder(H, cfg).to(cuda)
    syn = torch.from_numpy(syn_np).to(cuda)
    prior = torch.full((H.shape[1],), math.log((1 - p) / p), dtype=torch.float32, device=cuda)
    got = bp_layered_cuda(syn, prior, dec.tables(), cfg)
    ref = bp_layered_plain(syn, prior, dec.tables(), cfg)
    torch.cuda.synchronize()
    _hold_bp(got, ref, cfg.method, B)


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_k7_mixed_batch_of_early_and_late_samples(cuda, method):
    """Samples that converge at iteration 0 (zero syndromes), 1 or 2 (light
    errors) and samples that run all iterations (heavy errors), shuffled, in
    a batch that is no multiple of the warps per block."""
    cfg = BPConfig(max_iter=30, method=method, schedule="layered")
    H = get_code("[[144, 12, 12]]").Hx
    rng = np.random.default_rng(20)
    B = 8191
    p = rng.choice([0.0, 0.01, 0.25], size=B, p=[0.3, 0.4, 0.3])
    errors = (rng.random((B, H.shape[1])) < p[:, None]).astype(np.int64)
    syn = torch.from_numpy(((errors @ H.T) % 2).astype(np.uint8)).to(cuda)
    dec = BPDecoder(H, cfg).to(cuda)
    prior = torch.full((H.shape[1],), math.log(99.0), dtype=torch.float32, device=cuda)
    got = bp_layered_cuda(syn, prior, dec.tables(), cfg)
    ref = bp_layered_plain(syn, prior, dec.tables(), cfg)
    torch.cuda.synchronize()
    _hold_bp(got, ref, method, B)
    iters = got[2].cpu().numpy()
    for it in (0, 1, 2, 29):
        assert (iters == it).sum() > 10, f"no samples stop at iteration {it}"
    assert int((~got[1]).sum()) > 100


def test_k7_propagates_nan_from_degree_one_checks(cuda):
    H = np.zeros((6, 12), np.uint8)
    H[np.arange(6), 2 * (np.arange(6) // 2)] = 1
    cfg = BPConfig(max_iter=10, method="min-sum", offset=0.1, clip_llr=8.0, schedule="layered")
    dec = BPDecoder(H, cfg).to(cuda)
    rng = np.random.default_rng(9)
    syn = torch.from_numpy((rng.random((256, 6)) < 0.5).astype(np.uint8)).to(cuda)
    prior = torch.full((12,), 2.0, device=cuda)
    got = bp_layered_cuda(syn, prior, dec.tables(), cfg)
    ref = bp_layered_plain(syn, prior, dec.tables(), cfg)
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref[0]).any())
    _assert_same(got, ref)


def test_osd_on_the_144_space_time_matrix_launches_k4_not_k2(cuda):
    Hst = space_time_matrix(get_code("[[144, 12, 12]]").Hx, 12)
    osd = OSDDecoder(Hst)
    assert osd.elimination == "transform"
    rng = np.random.default_rng(15)
    B = 32
    e = (rng.random((B, Hst.shape[1])) < 0.01).astype(np.int64)
    syn = torch.from_numpy(((e @ Hst.T) % 2).astype(np.int8))
    llrs = torch.from_numpy(rng.normal(4.0, 3.0, (B, Hst.shape[1])).astype(np.float32))
    hard = (llrs < 0).to(torch.int8)
    ref = osd(syn, llrs, hard)
    osd_cuda.eliminate_rows_cuda.launches = 0
    osd_transform_cuda.eliminate_transform_cuda.launches = 0
    got = osd.to(cuda)(syn.to(cuda), llrs.to(cuda), hard.to(cuda))
    torch.cuda.synchronize()
    assert osd_transform_cuda.eliminate_transform_cuda.launches == 1
    assert osd_cuda.eliminate_rows_cuda.launches == 0
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("case", ["space-time", "layered"])
def test_new_paths_on_card_match_cpu_engine(cuda, case):
    if case == "space-time":
        cfg = EngineConfig(bp=MIN_SUM, osd=OSDConfig(), channel="space-time", n_rounds=3,
                           batch_size=256)
        p = 0.01
    else:
        cfg = EngineConfig(bp=dataclasses_replace(MIN_SUM, schedule="layered"), osd=OSDConfig(),
                           batch_size=512)
        p = 0.06
    code = get_code("[[72, 12, 6]]")
    got = counters_to_dict(MonteCarloEngine(code, cfg, device=cuda).run_rate(p, 512, seed=2))
    ref = counters_to_dict(MonteCarloEngine(code, cfg, device="cpu").run_rate(p, 512, seed=2))
    assert ref["BPs_fault"] > 0
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _k4_wide_system(m: int, B: int, seed: int):
    """A random wide system of m rows (columns of weight 1-3, n = 4 m + 13:
    a last partial panel), per-sample column orders, and residuals: half a
    few columns early in the sample's order (the b-exit takes them at a
    panel boundary), half a random error's."""
    rng = np.random.default_rng(seed)
    n = 4 * m + 13
    H = np.zeros((m, n), np.uint8)
    for j in range(n):
        H[rng.choice(m, size=rng.integers(1, 4), replace=False), j] = 1
    order = np.argsort(rng.random((B, n)), axis=1)
    e = (rng.random((B, n)) < 0.01).astype(np.int64)
    for s in range(0, B, 2):
        e[s] = 0
        e[s, order[s, rng.choice(64, size=rng.integers(1, 4), replace=False)]] = 1
    resid = (e @ H.T) % 2
    resid[resid.sum(1) == 0, 0] = 1
    return H, order, resid


# (m, B): m_words 5, 14 (the [[72]] DEM's 432), 27 (H_st's 864), 29 (the
# [[90]] DEM's 900) and 34 (the [[108]] DEM's 1,080: past 1,024 rows, K4's
# one-block-an-SM instance), up to 1,248 rows, the most whose T fits a
# block's shared memory, and m = 256, a multiple of 32; one sample, one
# wave of the [[72]] DEM's failures and several waves
K4_SHAPES = [(160, 1), (160, 716), (432, 1), (432, 716), (432, 4096), (864, 1), (864, 716),
             (256, 33), (256, 716), (900, 949), (1080, 1), (1080, 962), (1248, 33)]


@pytest.mark.parametrize("b_exit", [False, True])
@pytest.mark.parametrize("m,B", K4_SHAPES)
def test_k4_matches_plain_at_every_geometry(cuda, m, B, b_exit):
    """K4's panels bit for bit against the plain version at each launch
    geometry its launcher picks from m and B."""
    H, order_np, resid_np = _k4_wide_system(m, B, seed=31 + m + B)
    h_rank = OSDDecoder(H).h_rank  # (OSD-0 would take K2's rows for some of these)
    Hc = torch.from_numpy(osd_transform_cuda.pack_columns(H)).to(cuda)
    order = torch.from_numpy(order_np).to(cuda)
    resid = torch.from_numpy(resid_np.astype(np.int32)).to(cuda)
    got = eliminate_transform_cuda(order, resid, Hc, h_rank, b_exit)
    ref = eliminate_transform_plain(order, resid, Hc, h_rank, b_exit)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if b_exit and B > 1:
        assert bool((got[2] < h_rank).any())


@pytest.mark.parametrize("b_exit", [False, True])
def test_k4_matches_plain_on_the_full_rank_space_time_matrix(cuda, b_exit):
    """H_st of [[144,12,12]] at T = 12 has rank m = 864: the rank row is
    clamped at m - 1 once every row holds a pivot."""
    Hst = space_time_matrix(get_code("[[144, 12, 12]]").Hx, 12)
    osd = OSDDecoder(Hst).to(cuda)
    assert osd.elimination == "transform" and osd.h_rank == Hst.shape[0]
    rng = np.random.default_rng(32)
    B = 48
    e = (rng.random((B, Hst.shape[1])) < 0.01).astype(np.int64)
    resid = torch.from_numpy(((e @ Hst.T) % 2).astype(np.int32)).to(cuda)
    order = torch.from_numpy(np.argsort(rng.random((B, Hst.shape[1])), axis=1)).to(cuda)
    got = eliminate_transform_cuda(order, resid, osd.Hc, osd.h_rank, b_exit)
    ref = eliminate_transform_plain(order, resid, osd.Hc, osd.h_rank, b_exit)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if not b_exit:
        assert bool((got[2] == Hst.shape[0]).all())


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_k1_mixed_batch_of_early_and_late_samples(cuda, method):
    """Samples that converge at iteration 0 (zero syndromes), 1 or 2 (light
    errors) and samples that run all iterations (heavy errors), shuffled, in
    a batch that is no multiple of the warps a block."""
    cfg = BPConfig(max_iter=30, method=method)
    H = get_code("[[144, 12, 12]]").Hx
    rng = np.random.default_rng(24)
    B = 8191
    p = rng.choice([0.0, 0.01, 0.25], size=B, p=[0.3, 0.4, 0.3])
    errors = (rng.random((B, H.shape[1])) < p[:, None]).astype(np.int64)
    syn = torch.from_numpy(((errors @ H.T) % 2).astype(np.uint8)).to(cuda)
    dec = BPDecoder(H, cfg).to(cuda)
    prior = torch.full((H.shape[1],), math.log(99.0), dtype=torch.float32, device=cuda)
    got = bp_flooding_cuda(syn, prior, dec.tables(), cfg)
    ref = bp_flooding_plain(syn, prior, dec.tables(), cfg)
    torch.cuda.synchronize()
    _hold_bp(got, ref, method, B)
    iters = got[2].cpu().numpy()
    for it in (0, 1, 2, 29):
        assert (iters == it).sum() > 10, f"no samples stop at iteration {it}"
    assert int((~got[1]).sum()) > 100


@pytest.mark.parametrize("B", [1, 31, 33, 50_001])  # 50,001: no multiple of any grid
@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_k1_batch_sizes(cuda, B, method):
    """Fewer samples than warps on one SM, one warp short of and one past a
    warp's 32 lanes of samples, and more samples than the persistent grid's
    warps, every sample taken once from the work counter; the counter starts
    at 0 on every call (two calls on one stream agree)."""
    cfg = BPConfig(max_iter=50, method=method)
    H, syn_np = _syndromes("[[144, 12, 12]]", 0.05, B, seed=25)
    dec = BPDecoder(H, cfg).to(cuda)
    syn = torch.from_numpy(syn_np).to(cuda)
    prior = torch.full((H.shape[1],), math.log(19.0), dtype=torch.float32, device=cuda)
    got = bp_flooding_cuda(syn, prior, dec.tables(), cfg)
    again = bp_flooding_cuda(syn, prior, dec.tables(), cfg)
    ref = bp_flooding_plain(syn, prior, dec.tables(), cfg)
    torch.cuda.synchronize()
    _assert_same(got, again)
    _hold_bp(got, ref, method, B)


@pytest.mark.parametrize("code_name", ["steane", "[[72, 12, 6]]", "[[144, 12, 12]]",
                                       "[[288, 12, 18]]"])
@pytest.mark.parametrize("case", list(BP_CASES))
def test_k1_per_sample_priors(cuda, code_name, case):
    """Priors (B, n), a slice of the warp's shared memory each, and priors
    (n,) that differ by variable, shared once a block with the first
    iteration's table, against the plain version in every configuration."""
    cfg = BP_CASES[case]
    B = 4099
    H, syn_np = _syndromes(code_name, 0.04, B, seed=26)
    dec = BPDecoder(H, cfg).to(cuda)
    syn = torch.from_numpy(syn_np).to(cuda)
    rng = np.random.default_rng(27)
    priors = torch.from_numpy(rng.uniform(1.5, 4.5, (B, H.shape[1])).astype(np.float32)).to(cuda)
    for pr in (priors, priors[0]):
        got = bp_flooding_cuda(syn, pr, dec.tables(), cfg)
        ref = bp_flooding_plain(syn, pr, dec.tables(), cfg)
        torch.cuda.synchronize()
        _hold_bp(got, ref, cfg.method, B)


def test_cli_on_the_card_matches_the_cpu_run(cuda, tmp_path):
    """The experiments CLI on the card against the same run on the CPU:
    min-sum (exact arithmetic), so every counter is identical; code
    capacity (K1, K2) and the [[72]] DEM (K3, K4)."""
    from qldpc_tpu_torch.experiments.cli import main
    from qldpc_tpu_torch.experiments.results_io import load_results

    runs = {
        "study": ["--codes", "[[72, 12, 6]]", "--error-rates", "0.03", "0.06",
                  "--trials", "4096", "--batch-size", "2048"],
        "complete-bposd": ["--codes", "[[72, 12, 6]]", "--error-rates", "0.002",
                           "--trials", "512", "--batch-size", "256"],
    }
    for preset, args in runs.items():
        out = {}
        for device in ("cuda", "cpu"):
            path = tmp_path / f"{preset}-{device}"
            assert main(["run", preset, *args, "--set", "bp_method=min-sum", "--device", device,
                         "--out", str(path), "--no-checkpoint", "--quiet"]) == 0
            out[device] = load_results(path / f"{preset}.npz")["[[72, 12, 6]]"]
        assert out["cuda"].keys() == out["cpu"].keys()
        for p, d in out["cpu"].items():
            assert d["BPs_fault"] > 0
            for k in d:
                assert np.array_equal(out["cuda"][p][k], d[k]), (preset, p, k)


def test_checkpoint_resume_on_the_card(cuda, tmp_path):
    from qldpc_tpu_torch.mc import CheckpointManager

    eng = MonteCarloEngine(get_code("[[144, 12, 12]]"),
                           EngineConfig(bp=BPConfig(max_iter=50), batch_size=4096), device=cuda)
    ref = counters_to_dict(eng.run_rate(0.05, 5 * 4096, seed=2))

    class Stop(Exception):
        pass

    mgr = CheckpointManager(tmp_path)
    save = mgr.save

    def save_then_stop(engine, p, seed, counters, next_batch):
        save(engine, p, seed, counters, next_batch)
        if next_batch == 3:
            raise Stop

    mgr.save = save_then_stop
    with pytest.raises(Stop):
        mgr.run_rate(eng, 0.05, 5 * 4096, 2)
    got = counters_to_dict(CheckpointManager(tmp_path).run_rate(eng, 0.05, 5 * 4096, 2))
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k


def _flipped_case(H, B, seed, p=0.05):
    """Syndromes with one flipped bit each, and the plain BP's min-sum
    posteriors: systems mostly outside H's image, where OSD-e searches."""
    rng = np.random.default_rng(seed)
    e = (rng.random((B, H.shape[1])) < p).astype(np.int64)
    syn = (e @ H.T) % 2
    syn[np.arange(B), rng.integers(0, H.shape[0], B)] ^= 1
    syn = torch.from_numpy(syn.astype(np.int8))
    res = BPDecoder(H, BPConfig(max_iter=8, method="min-sum"))(
        syn, torch.full((H.shape[1],), math.log((1 - p) / p)))
    return syn, res.llrs, res.hard


@pytest.mark.parametrize("case", ["rows-72-order7", "transform-wide-order3"])
def test_osde_on_the_card_equals_the_cpu(cuda, case):
    """OSD-e on the card (K2's two loaders, or K4, then the search's float64
    costs) gives the CPU's solutions bit for bit."""
    if case.startswith("rows"):
        H, order, B = get_code("[[72, 12, 6]]").Hx, 7, 256
    else:
        rng = np.random.default_rng(8)
        H = np.zeros((40, 700), np.uint8)
        for j in range(700):
            H[rng.choice(40, size=rng.integers(1, 4), replace=False), j] = 1
        H[-6:] = H[:6] ^ H[6:12]
        order, B = 3, 128
    syn, llrs, hard = _flipped_case(H, B, seed=3)
    cpu = OSDDecoder(H, OSDConfig(order=order))
    card = OSDDecoder(H, OSDConfig(order=order)).to(cuda)
    assert card.elimination == ("rows" if case.startswith("rows") else "transform")
    ref = cpu(syn, llrs, hard)
    got = card(syn.to(cuda), llrs.to(cuda), hard.to(cuda)).cpu()
    osd0 = OSDDecoder(H, OSDConfig(order=0))(syn, llrs, hard)
    assert bool((got != osd0).any(1).any())  # the search ran and moved some
    assert torch.equal(got, ref)


@pytest.mark.parametrize("method", ["min-sum", "sum-product"])
def test_estimate_alpha_on_the_card_equals_the_cpu(cuda, method):
    """Min-sum messages are exact: the same alpha; sum-product's tanh/atanh
    may round otherwise on the card: within 1e-6 relative."""
    from qldpc_tpu_torch.decoders.alvarado import estimate_alpha

    H = get_code("[[72, 12, 6]]").Hx
    got = estimate_alpha(H, 0.05, trials=4096, seed=2, method=method, device=cuda)
    ref = estimate_alpha(H, 0.05, trials=4096, seed=2, method=method, device="cpu")
    if method == "min-sum":
        assert got == ref
    else:
        assert abs(got - ref) <= 1e-6 * abs(ref)


# K8, the sampler's counter stream (ops/threefry_cuda.py): bit for bit the
# plain int64 counter_uniform, compared as int32 views

K8_SHAPES = [
    (65536, 144),  # code capacity, [[144]]
    (37, 216),     # [[144]] phenomenological, n + m
    (1024, 66981),  # the [[144]] DEM, odd stride
    (1, 66981),
    (4097, 1),
    (1, 1),
    (512, 2592),   # [[144]] space-time at T = 12: T*n + T*m
    (37, 2592),
]
K8_KEYS = {"fold-in": tuple(rng.fold_in(rng.fold_in(rng.key(12345), 11), 2).tolist()),
           "bit31": (0x80000001, 0xFFFFFFFE)}


def _k8_same(got, want):
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("key", list(K8_KEYS))
@pytest.mark.parametrize("batch,stride", K8_SHAPES)
def test_k8_matches_plain_bit_for_bit(cuda, batch, stride, key):
    k = torch.tensor(K8_KEYS[key], dtype=torch.int64)
    got = threefry_cuda.counter_uniform_cuda(k, 7, batch, stride, cuda)
    want = rng.counter_uniform_plain(k, 7, batch, stride, device=cuda)
    torch.cuda.synchronize()
    _k8_same(got, want)


def test_k8_matches_the_cpu_plain_version(cuda):
    k = torch.tensor(K8_KEYS["bit31"], dtype=torch.int64)
    got = rng.counter_uniform(k, 3, 129, 145, device=cuda).cpu()
    _k8_same(got, rng.counter_uniform(k, 3, 129, 145))


@pytest.mark.parametrize("stride", [144, 66981])
def test_k8_counter_wraps_past_2_to_the_32(cuda, stride):
    """first_sample * P and the rows after it pass 2^32."""
    P = (stride + 1) // 2
    first = 2**32 // P - 5
    k = torch.tensor(K8_KEYS["bit31"], dtype=torch.int64)
    batch = 65536 if stride == 144 else 64
    got = threefry_cuda.counter_uniform_cuda(k, first, batch, stride, cuda)
    _k8_same(got, rng.counter_uniform_plain(k, first, batch, stride, device=cuda))


def test_k8_counts_its_launches_and_draws(cuda):
    k = rng.key(5)
    before = profiling.counts().get("sample.kernel_draws", 0)
    for i in range(3):
        launches = threefry_cuda.counter_uniform_cuda.launches
        with profiling.batch():
            rng.counter_uniform(k, 33 * i, 33, 145, device=cuda)
        assert threefry_cuda.counter_uniform_cuda.launches == launches + 1
    assert profiling.counts()["sample.kernel_draws"] == before + 3 * 33 * 145
    # outside a batch the draws are not counted, the launch is
    launches = threefry_cuda.counter_uniform_cuda.launches
    rng.counter_uniform(k, 0, 33, 145, device=cuda)
    assert threefry_cuda.counter_uniform_cuda.launches == launches + 1
    assert profiling.counts()["sample.kernel_draws"] == before + 3 * 33 * 145


K8_ENGINES = {
    "code-capacity": dict(),
    "phenomenological": dict(channel="phenomenological"),
    "space-time": dict(channel="space-time", n_rounds=12),
}


def _k8_engine_samples(make, key, p):
    """One ``_sample`` call on the card and on the CPU at one key: equal
    errors, syndromes and priors, through one K8 launch."""
    launches = threefry_cuda.counter_uniform_cuda.launches
    got = make("cuda")._sample(key, p)
    assert threefry_cuda.counter_uniform_cuda.launches == launches + 1
    ref = make("cpu")._sample(key, p)
    assert bool(got[0].any())  # some errors drawn
    for name, g, r in zip(("errors", "syndromes", "priors"), got, ref):
        assert g.device.type == "cuda", name
        assert torch.equal(g.cpu(), r), name


@pytest.mark.parametrize("case", list(K8_ENGINES))
def test_k8_engine_samples_match_the_cpu(cuda, case):
    cfg = EngineConfig(bp=MIN_SUM, osd=None, batch_size=257, **K8_ENGINES[case])
    code = get_code("[[144, 12, 12]]")
    key = rng.fold_in(rng.fold_in(rng.key(9), 3), 1)
    _k8_engine_samples(lambda dev: MonteCarloEngine(code, cfg, device=dev), key, 0.03)


def test_k8_dem_engine_samples_match_the_cpu(cuda):
    dem = parametric_memory_dem(get_code("[[72, 12, 6]]"), basis="z", rounds=6)
    cfg = DEMEngineConfig(bp=MIN_SUM, osd=None, batch_size=129)
    key = rng.fold_in(rng.fold_in(rng.key(9), 3), 1)
    _k8_engine_samples(lambda dev: DEMEngine(dem, cfg, device=dev), key, 0.003)
