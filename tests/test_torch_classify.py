"""The classification kernel K9 against the plain ``_classify``, on the card.

These need an NVIDIA GPU and nvcc, and skip without them; on the card run
them with ``python -m pytest tests/test_torch_classify.py -q --noconftest``.
K9 (``ops/classify_cuda.py``) must give the plain version's ``Counters``
field by field, exactly: on batches of every channel (code capacity,
doubled, phenomenological, space time over T > 1 rounds), of a small
memory DEM and of the [[144,12,12]] DEM's 66,981 mechanisms, under BP + OSD-0
and BP alone, with the valid mask whole and partial, an odd batch, an OSD
overflow added, residual weights past the last bin, and a grid that steps
over the batch. A card engine launches K9 once a batch, with the local batch
counted in ``classify.kernel_samples``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from qldpc_tpu_torch.codes import get_code
from qldpc_tpu_torch.decoders import BPConfig
from qldpc_tpu_torch.decoders.bp import BPResult
from qldpc_tpu_torch.mc import DEMEngine, DEMEngineConfig, EngineConfig, MonteCarloEngine
from qldpc_tpu_torch.mc.metrics import HIST_BINS, Counters
from qldpc_tpu_torch.noise.circuit import parametric_memory_dem
from qldpc_tpu_torch.ops import classify_cuda
from qldpc_tpu_torch.utils import profiling, rng

pytestmark = pytest.mark.cuda

MS = BPConfig(max_iter=20, method="min-sum")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _code_engine(dev, code="[[144, 12, 12]]", batch=4099, **kw):
    cfg = EngineConfig(**{"bp": MS, "batch_size": batch, **kw})
    return MonteCarloEngine(get_code(code), cfg, device=dev)


def _dem_engine(dev, code="[[72, 12, 6]]", rounds=6, batch=257, **kw):
    dem = parametric_memory_dem(get_code(code), basis="z", rounds=rounds)
    cfg = DEMEngineConfig(**{"bp": BPConfig(max_iter=30), "batch_size": batch, **kw})
    return DEMEngine(dem, cfg, device=dev)


# name -> (engine on the device, p)
ENGINES = {
    "code-capacity": (lambda d: _code_engine(d), 0.05),
    "doubled": (lambda d: _code_engine(d, channel="doubled"), 0.03),
    "phenomenological": (lambda d: _code_engine(d, channel="phenomenological",
                                                syndrome_flip_rate=0.01), 0.03),
    "space-time-72-T6": (lambda d: _code_engine(d, "[[72, 12, 6]]", batch=1023,
                                                channel="space-time", n_rounds=6), 0.01),
    "space-time-144-T12": (lambda d: _code_engine(
        d, batch=2048, channel="space-time", bp=BPConfig(max_iter=100)), 0.004),
    "bp-only": (lambda d: _code_engine(d, osd=None), 0.05),
    "space-time-bp-only": (lambda d: _code_engine(d, "[[72, 12, 6]]", batch=512, osd=None,
                                                  channel="space-time", n_rounds=3), 0.02),
    "overflow": (lambda d: _code_engine(d, osd_fraction=0.01), 0.06),
    "dem-72": (lambda d: _dem_engine(d), 0.002),
    "dem-144": (lambda d: _dem_engine(d, "[[144, 12, 12]]", 12, batch=64), 0.003),
    "dem-bp-only": (lambda d: _dem_engine(d, osd=None), 0.002),
}


def _batch(eng, p, seed=7):
    errors, syn, priors = eng._sample(rng.fold_in(rng.key(seed), 1), p)
    res = eng._decode(syn, priors, float(np.float32(eng.config.bp.alpha)))
    if eng.osd is None:
        return errors, res.hard, syn, res, 0
    final, overflow = eng._post_process(syn, res)
    return errors, final, syn, res, overflow


def _same(got: Counters, want: Counters):
    torch.cuda.synchronize()
    for name, g, w in zip(Counters._fields, got, want):
        assert g.device == w.device and torch.equal(g, w), name


@pytest.mark.parametrize("name", list(ENGINES))
def test_k9_matches_plain(cuda, name):
    make, p = ENGINES[name]
    eng = make(cuda)
    errors, final, syn, res, overflow = _batch(eng, p)
    B = errors.shape[0]
    if name == "overflow":
        assert overflow > 0
    masks = [torch.ones(B, dtype=torch.bool, device=cuda),
             torch.arange(B, device=cuda) % 5 != 2,
             torch.arange(B, device=cuda) < B // 3]
    for valid in masks:
        before = classify_cuda.classify_cuda.launches
        got = eng._classify(errors, final, syn, res, valid, overflow=overflow)
        assert classify_cuda.classify_cuda.launches == before + 1
        _same(got, eng._classify_plain(errors, final, syn, res, valid, overflow=overflow))
    assert int(got.logical_errors) + int(got.degeneracies) > 0


@pytest.mark.parametrize("name", ["code-capacity", "space-time-72-T6", "dem-72"])
def test_k9_grid_steps_over_the_batch(cuda, name, monkeypatch):
    """A grid of one multiprocessor's blocks (at most 8, 64 groups): each
    group of threads takes sample after sample."""
    make, p = ENGINES[name]
    eng = make(cuda)
    errors, final, syn, res, overflow = _batch(eng, p)
    valid = torch.ones(errors.shape[0], dtype=torch.bool, device=cuda)
    want = eng._classify_plain(errors, final, syn, res, valid)
    monkeypatch.setattr(eng, "_k9", dataclasses.replace(eng._k9, sm_count=1))
    _same(eng._classify(errors, final, syn, res, valid), want)


@pytest.mark.parametrize("name", ["code-capacity", "dem-144"])
def test_k9_clamps_heavy_residuals(cuda, name):
    """Residual weights from 0 to the whole row, most past the last bin."""
    eng = ENGINES[name][0](cuda)
    B, n = 999, eng.n_vars
    g = torch.Generator(device=cuda).manual_seed(3)
    p = torch.linspace(0.0, 1.0, B, device=cuda)[:, None]
    errors = (torch.rand(B, n, generator=g, device=cuda) < p).to(torch.int8)
    final = (torch.rand(B, n, generator=g, device=cuda) < 0.02).to(torch.int8)
    syn = eng._syndrome(errors)
    syn[::7] = eng._syndrome(final)[::7]  # some corrections reproduce the syndrome
    conv = torch.rand(B, generator=g, device=cuda) < 0.5
    iters = torch.randint(0, 100, (B,), generator=g, device=cuda, dtype=torch.int32)
    res = BPResult(final, conv, torch.zeros(1, device=cuda), iters)
    valid = torch.rand(B, generator=g, device=cuda) < 0.9
    want = eng._classify_plain(errors, final, syn, res, valid, overflow=5)
    assert int(sum(h[-1] for h in want[-4:])) > 0
    _same(eng._classify(errors, final, syn, res, valid, overflow=5), want)


@pytest.mark.parametrize("name", ["code-capacity", "dem-72"])
@pytest.mark.parametrize("shift", [1, 3, 7])
def test_k9_reads_rows_at_any_offset(cuda, name, shift):
    """The batch's arrays starting ``shift`` bytes into their buffers (the
    syndrome ``shift + 2``): K9's aligned words then straddle the rows'
    starts and ends."""
    make, p = ENGINES[name]
    eng = make(cuda)
    errors, final, syn, res, _ = _batch(eng, p)

    def moved(x, k):
        buf = torch.empty(x.numel() + k, dtype=x.dtype, device=cuda)
        buf[k:] = x.flatten()
        return buf[k:].view(x.shape)

    valid = torch.ones(errors.shape[0], dtype=torch.bool, device=cuda)
    want = eng._classify_plain(errors, final, syn, res, valid)
    got = eng._classify(moved(errors, shift), moved(final, shift), moved(syn, shift + 2), res,
                        valid)
    _same(got, want)
    with pytest.raises(ValueError, match="same offset modulo 8"):
        eng._classify(moved(errors, shift), final, syn, res, valid)


def test_k9_on_an_empty_batch_adds_the_overflow(cuda):
    eng = ENGINES["code-capacity"][0](cuda)
    z = torch.zeros(0, eng.n_vars, dtype=torch.int8, device=cuda)
    res = BPResult(z, torch.zeros(0, dtype=torch.bool, device=cuda), z,
                   torch.zeros(0, dtype=torch.int32, device=cuda))
    syn = torch.zeros(0, eng.m_checks, dtype=torch.int8, device=cuda)
    got = eng._classify(z, z, syn, res, res.converged, overflow=4)
    torch.cuda.synchronize()
    assert int(got.osd_overflow) == 4 and int(sum(x.sum() for x in got)) == 4


@pytest.mark.parametrize("name", ["code-capacity", "space-time-72-T6", "dem-72"])
def test_k9_launches_once_a_batch(cuda, name):
    """``run_rate`` over three batches, the last partial: three launches,
    ``classify.kernel_samples`` the local batch each, and the counters of
    the CPU engine."""
    make, p = ENGINES[name]
    eng = make(cuda)
    B = eng.local_batch
    trials = 2 * B + B // 2
    launches = classify_cuda.classify_cuda.launches
    before = profiling.counts()
    got = eng.run_rate(p, trials, seed=11)
    after = profiling.counts()
    assert classify_cuda.classify_cuda.launches - launches == 3
    assert after["classify.kernel_samples"] - before.get("classify.kernel_samples", 0) == 3 * B
    assert after["batches"] - before["batches"] == 3
    assert int(got.trials) == trials
    cpu = make("cpu").run_rate(p, trials, seed=11)
    if name != "dem-72":  # float32 BP rounds apart on the DEM; counters held elsewhere
        for field, a, b in zip(Counters._fields, got, cpu):
            assert torch.equal(a, b), field


def test_k9_wrapper_refuses_a_wrong_batch(cuda):
    eng = ENGINES["code-capacity"][0](cuda)
    errors, final, syn, res, _ = _batch(eng, 0.05)
    valid = torch.ones(errors.shape[0], dtype=torch.bool, device=cuda)
    k = eng._k9
    with pytest.raises(ValueError, match="contiguous"):
        classify_cuda.classify_cuda(k, errors[:, :-1], final, syn, res.converged,
                                    res.iterations, valid)
    with pytest.raises(ValueError, match="bits in bytes"):
        classify_cuda.classify_cuda(k, errors.float(), final, syn, res.converged,
                                    res.iterations, valid)
    with pytest.raises(ValueError, match="int32"):
        classify_cuda.classify_cuda(k, errors, final, syn, res.converged,
                                    res.iterations.long(), valid)
    assert HIST_BINS == 128
