"""The classification kernel K9 (ops/classify_cuda.py) without a card.

K9 reads two tables of the decoding problem, each variable's check list
and each qubit's logicals as a bitmask, and folds the data rounds by
position (variable ``t*n + j`` is qubit j in round t). The tables must be
exact, and ``_k9_model``, K9's algorithm written out in torch from those
tables (each set bit of the correction XORs its check list into the check
bitmap, each set bit of the residual and of the errors flips its qubit, the
logical test XORs the set qubits' bitmasks, the counts and bins summed per
sample as K9's first thread of a group sums them), must equal the engine's
plain ``_classify`` on every channel. The card tests
(``tests/test_torch_classify.py``) hold the kernel itself to the plain
version.
"""

import json

import numpy as np
import pytest
import torch

from qldpc_tpu_torch.codes import get_code
from qldpc_tpu_torch.decoders import BPConfig
from qldpc_tpu_torch.decoders.bp import BPResult
from qldpc_tpu_torch.mc import DEMEngine, DEMEngineConfig, EngineConfig, MonteCarloEngine
from qldpc_tpu_torch.mc.metrics import HIST_BINS, Counters
from qldpc_tpu_torch.noise import spacetime as st
from qldpc_tpu_torch.noise.circuit import parametric_memory_dem
from qldpc_tpu_torch.ops import classify_cuda
from qldpc_tpu_torch.utils import profiling, rng

torch.set_num_threads(2)

MS = BPConfig(max_iter=10, method="min-sum")


def _tables(eng):
    """K9's tables of a CPU engine's decoding problem, as a card engine
    builds them."""
    if isinstance(eng, DEMEngine):
        H, L, n, T = eng.dem.H, eng.dem.L, eng.n_vars, 0
    else:
        code = eng.code
        H = code.Hx if eng.config.basis == "x" else code.Hz
        L = code.Lx if eng.config.basis == "x" else code.Lz
        n, T = eng.n_qubits, eng.n_rounds
        if T:
            H = st.space_time_matrix(H, T)
    return classify_cuda.classify_tables(H, L, n, T, eng.distance, "cpu")


def _k9_model(t, errors, final, syn, conv, iters, valid, overflow=0, bp_only=False):
    """K9's algorithm, sample by sample in torch, from its tables."""
    B = errors.shape[0]
    e, f = errors.to(torch.int64) & 1, final.to(torch.int64) & 1
    ptr, idx = t.col_ptr.long(), t.col_idx.long()
    var_of_edge = torch.repeat_interleave(torch.arange(t.n_vars), ptr[1:] - ptr[:-1])
    checks = torch.zeros(B, t.m, dtype=torch.int64)  # the check bitmap: XORs of check lists
    checks.index_add_(1, idx, f[:, var_of_edge])
    bad = ((checks & 1) != syn.to(torch.int64)).any(1)
    data = t.n * t.T
    qubit = torch.arange(data) % t.n  # variable t*n + j is qubit j
    rq = torch.zeros(B, t.n, dtype=torch.int64).index_add_(1, qubit, (e ^ f)[:, :data]) & 1
    eq = torch.zeros(B, t.n, dtype=torch.int64).index_add_(1, qubit, e[:, :data]) & 1
    bits = (t.lmask[:, None] >> torch.arange(64)) & 1  # (n, 64): qubit j's logicals
    lm = (rq @ bits) & 1  # XOR of the set qubits' bitmasks, bit by bit
    mis = (errors != final).any(1)
    rw, ew = rq.sum(1), eq.sum(1)
    c = [0] * 13
    hist = torch.zeros(4, HIST_BINS, dtype=torch.int64)
    for s in range(B):
        if not bool(valid[s]):
            continue
        cv, vec = bool(conv[s]), bool(lm[s].any())
        logical = vec or (bp_only and not cv)
        low = 2 * int(ew[s]) < t.distance
        degenerate = not logical and bool(mis[s])
        for k, x in enumerate((1, logical, vec, cv, not cv, not bp_only and not cv,
                               logical and low, logical and not low, degenerate,
                               degenerate and not bool(bad[s]), logical and not cv)):
            c[k] += int(x)
        c[12] += int(iters[s])
        b = min(int(rw[s]), HIST_BINS - 1)
        if degenerate:
            hist[0 if cv else 1, b] += 1
        if logical:
            hist[2 if cv else 3, b] += 1
    c[11] = overflow
    return Counters(*(torch.tensor(x) for x in c), *hist.unbind())


def _batch(eng, p, seed=1):
    """One batch of the engine's stages: (errors, final, syn, bp_res, overflow)."""
    errors, syn, priors = eng._sample(rng.fold_in(rng.key(seed), 3), p)
    res = eng._decode(syn, priors, float(np.float32(eng.config.bp.alpha)))
    if eng.osd is None:
        return errors, res.hard, syn, res, 0
    final, overflow = eng._post_process(syn, res)
    return errors, final, syn, res, overflow


def _same(got: Counters, want: Counters):
    for name, g, w in zip(Counters._fields, got, want):
        assert torch.equal(g, w), name


def _cc(channel="code-capacity", **kw):
    cfg = EngineConfig(bp=MS, channel=channel, batch_size=kw.pop("batch_size", 96), **kw)
    return MonteCarloEngine(get_code("[[72, 12, 6]]"), cfg, device="cpu")


def _dem(**kw):
    dem = parametric_memory_dem(get_code("steane"), basis="z", rounds=3)
    cfg = DEMEngineConfig(bp=BPConfig(max_iter=5, method="min-sum"), batch_size=64, **kw)
    return DEMEngine(dem, cfg, device="cpu")


ENGINES = {
    "code-capacity": (lambda: _cc(), 0.06),
    "doubled": (lambda: _cc("doubled"), 0.03),
    "phenomenological": (lambda: _cc("phenomenological", syndrome_flip_rate=0.02), 0.03),
    "space-time": (lambda: _cc("space-time", n_rounds=3, batch_size=64), 0.03),
    "space-time-bp-only": (lambda: _cc("space-time", n_rounds=2, osd=None, batch_size=64),
                           0.03),
    "bp-only": (lambda: _cc(osd=None, batch_size=97), 0.06),
    "overflow": (lambda: _cc(osd_fraction=0.02), 0.08),
    "dem": (lambda: _dem(), 0.01),
    "dem-bp-only": (lambda: _dem(osd=None), 0.01),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_k9_model_matches_plain_classify(name):
    make, p = ENGINES[name]
    eng = make()
    errors, final, syn, res, overflow = _batch(eng, p)
    B = errors.shape[0]
    tables = _tables(eng)
    masks = {"all": torch.ones(B, dtype=torch.bool),
             "partial": torch.arange(B) % 3 != 1}
    if name == "overflow":
        assert overflow > 0
    for mask in masks.values():
        want = eng._classify(errors, final, syn, res, mask, overflow=overflow)
        got = _k9_model(tables, errors, final, syn, res.converged, res.iterations, mask,
                        overflow, bp_only=eng.osd is None)
        _same(got, want)
    assert int(want.logical_errors) + int(want.degeneracies) > 0


def test_k9_model_clamps_heavy_residuals():
    """Residual weights from 0 to past the last bin, on the DEM's mechanisms."""
    eng = _dem()
    tables = _tables(eng)
    assert tables.n > HIST_BINS
    g = torch.Generator().manual_seed(5)
    B = 64
    p = torch.linspace(0.0, 0.9, B)[:, None]
    errors = (torch.rand(B, tables.n_vars, generator=g) < p).to(torch.int8)
    final = (torch.rand(B, tables.n_vars, generator=g) < 0.02).to(torch.int8)
    syn = eng._syndrome(errors)
    conv = torch.rand(B, generator=g) < 0.5
    iters = torch.randint(0, 50, (B,), generator=g, dtype=torch.int32)
    bp_res = BPResult(final, conv, torch.zeros(B, tables.n_vars), iters)
    valid = torch.ones(B, dtype=torch.bool)
    want = eng._classify(errors, final, syn, bp_res, valid)
    rw = ((errors ^ final) & 1).sum(1)
    assert int(rw.max()) >= HIST_BINS and int(want.hist_osd_error[-1]) > 0
    _same(_k9_model(tables, errors, final, syn, conv, iters, valid), want)


def _dense_columns(H):
    return [np.nonzero(np.asarray(H)[:, v] % 2)[0] for v in range(H.shape[1])]


@pytest.mark.parametrize("name", ["code-capacity", "space-time", "dem"])
def test_k9_tables_are_exact(name):
    eng = ENGINES[name][0]()
    t = _tables(eng)
    if name == "dem":
        H, L = eng.dem.H, eng.dem.L
    else:
        H = eng.code.Hx if not eng.n_rounds else st.space_time_matrix(eng.code.Hx, eng.n_rounds)
        L = eng.code.Lx
    assert (t.m, t.n_vars) == H.shape and t.distance == eng.distance
    ptr, idx = t.col_ptr.numpy(), t.col_idx.numpy()
    assert t.col_ptr.dtype == t.col_idx.dtype == torch.int32 and ptr[0] == 0
    for v, want in enumerate(_dense_columns(H)):
        assert np.array_equal(idx[ptr[v]:ptr[v + 1]], want), v
    assert ptr[-1] == len(idx) == int((np.asarray(H) % 2).sum())
    lm = t.lmask.numpy().view(np.uint64)
    assert lm.shape == (t.n,) and L.shape[0] <= 64
    for i in range(64):
        want = L[i] % 2 if i < L.shape[0] else np.zeros(t.n, np.uint64)
        assert np.array_equal((lm >> np.uint64(i)) & np.uint64(1), want.astype(np.uint64)), i


@pytest.mark.parametrize("n,T,n_vars", [(72 * 3, 1, 72 * 3), (72, 3, 72 * 3 + 36 * 3),
                                         (7, 4, 7 * 4 + 3 * 4)])
def test_k9_folds_variable_t_n_plus_j_into_qubit_j(n, T, n_vars):
    """Each data variable alone, through the engines' fold: it lands on
    qubit ``v % n``; the variables past ``n * T`` reach no qubit."""
    eye = torch.eye(n_vars, dtype=torch.int32)
    folded = st.fold_data_correction(eye, n, T) if T > 1 else eye[:, :n]
    for v in range(n_vars):
        want = torch.zeros(n, dtype=torch.int32)
        if v < n * T:
            want[v % n] = 1
        assert torch.equal(folded[v], want), v


def test_k9_tables_refuse_what_k9_does_not_hold():
    H = np.eye(4, dtype=np.uint8)
    with pytest.raises(ValueError, match="at most 64 logicals"):
        classify_cuda.classify_tables(H, np.ones((65, 4), np.uint8), 4, 0, 0, "cpu")
    with pytest.raises(ValueError, match="do not fit"):
        classify_cuda.classify_tables(H, np.ones((1, 4), np.uint8), 4, 2, 0, "cpu")


@pytest.mark.parametrize("n_vars,want", [
    (144, (1, 1)),    # code capacity: a warp a sample, a word a lane
    (249, (1, 1)),
    (250, (1, 4)),
    (2592, (1, 4)),   # [[144]] space time, T = 12
    (4096, (1, 4)),
    (4097, (8, 4)),
    (66981, (8, 4)),  # the [[144]] DEM: the block
])
def test_k9_launch_shape(n_vars, want):
    assert classify_cuda.launch_shape(n_vars) == want


@pytest.mark.parametrize("start", range(8))
def test_k9_one_word_a_lane_covers_the_rows_it_is_chosen_for(start):
    n = classify_cuda.ONE_WORD_MAX_VARS
    assert len(_row_words(start, n)) <= 32
    assert max(len(_row_words(s, n + 1)) for s in range(8)) > 32


def _row_words(start: int, length: int):
    """K9's ``row``: the aligned 8-byte words over a row of ``length``
    bytes at address ``start``, each (first, inside): the row offset of its
    byte 0 and the mask of its bytes in the row."""
    first_word = start & ~7
    words = ((start + length - 1) & ~7) - first_word
    lead = start - first_word
    out = []
    for q in range(words // 8 + 1):
        lo = 8 * q - lead
        keep = (1 << 64) - 1
        if lo < 0:
            keep = (keep << 8 * -lo) & ((1 << 64) - 1)
        if lo + 8 > length:
            keep &= ((1 << 64) - 1) >> 8 * (lo + 8 - length)
        out.append((lo, keep))
    return out


@pytest.mark.parametrize("length", [1, 8, 9, 144, 2592, 66981])
@pytest.mark.parametrize("start", [0, 1, 7, 66981 * 3])
def test_k9_words_cover_each_byte_of_a_row_once(start, length):
    seen = np.zeros(length, np.int64)
    for lo, keep in _row_words(start, length):
        for b in range(8):
            if keep >> 8 * b & 0xFF:
                assert keep >> 8 * b & 0xFF == 0xFF and 0 <= lo + b < length
                seen[lo + b] += 1
    assert (seen == 1).all()


def test_k9_wrapper_refuses_what_it_does_not_take():
    eng = _cc()
    errors, final, syn, res, _ = _batch(eng, 0.06)
    t = _tables(eng)
    valid = torch.ones(errors.shape[0], dtype=torch.bool)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        classify_cuda.classify_cuda(t, errors, final, syn, res.converged, res.iterations, valid)


def test_classify_takes_k9_on_a_card_only(monkeypatch, tmp_path):
    """On a card ``_classify`` hands the batch, the valid mask, the overflow
    and BP-only to K9 with the engine's tables, inside the fold's span at
    space time; on the CPU it is the plain version."""
    calls = []

    def fake(tables, errors, final, syn, conv, iters, valid, overflow, bp_only):
        calls.append((tables, valid, overflow, bp_only))
        return "kernel"

    monkeypatch.setattr(classify_cuda, "classify_cuda", fake)
    eng = ENGINES["space-time-bp-only"][0]()
    errors, final, syn, res, _ = _batch(eng, 0.03)
    valid = torch.ones(errors.shape[0], dtype=torch.bool)
    plain = eng._classify(errors, final, syn, res, valid, overflow=3)
    assert not calls and int(plain.osd_overflow) == 3
    eng._k9 = _tables(eng)
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert eng._classify(errors, final, syn, res, valid, overflow=3) == "kernel"
    assert calls == [(eng._k9, valid, 3, True)]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names.count("qldpc.classify.fold") == 1


def test_plain_path_counts_no_kernel_samples():
    eng = _cc()
    before = profiling.counts().get("classify.kernel_samples", 0)
    eng.run_rate(0.06, 2 * 96, seed=2)
    assert profiling.counts().get("classify.kernel_samples", 0) == before


def test_a_rate_s_last_partial_batch_counts_its_samples_only():
    """``run_batch``'s valid mask: every sample of a full batch (one mask
    kept by the engine), the leading ones of the last."""
    eng = _cc(batch_size=64)
    full = eng.run_rate(0.06, 128, seed=3)
    part = eng.run_rate(0.06, 128 + 21, seed=3)
    assert int(full.trials) == 128 and int(part.trials) == 149
    assert int(part.bp_faults) >= int(full.bp_faults)
