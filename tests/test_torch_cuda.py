"""The CUDA kernels against their plain torch versions, on the card.

These need an NVIDIA GPU and nvcc, and skip without them. On the card run
them with ``python -m pytest tests/test_torch_cuda.py -q``. The tolerances
are those of chip_smoke.py: K1 may differ in decision (converged,
iterations, hard) on at most 1 lane in 10^4, with posteriors within rtol =
atol = 1e-5 on the other lanes; K2 is bit-identical.
"""

import math

import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code
from qldpc_tpu_torch.decoders import BPConfig, BPDecoder, OSDConfig, OSDDecoder
from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine, counters_to_dict
from qldpc_tpu_torch.ops.bp_cuda import bp_flooding_cuda, bp_flooding_plain
from qldpc_tpu_torch.ops.osd_cuda import (
    eliminate_rows_cuda,
    eliminate_rows_plain,
    pack_rows,
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
    A = pack_rows(osd.H[:, order].permute(1, 0, 2))
    b = torch.from_numpy(syn_np.astype(np.int32)).to(cuda)
    for max_rank in (None, osd.h_rank):
        got = eliminate_rows_cuda(A, b, osd.n, max_rank)
        ref = eliminate_rows_plain(A, b, osd.n, max_rank)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


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
