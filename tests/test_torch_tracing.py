"""The engine's own spans and counters (``utils.profiling``): the spans a
profiled ``run_rate`` shows, counters that a profiler leaves unchanged, and
the counts of host syncs, K4g lanes and the factored loop's blocks and
lanes against what each batch does."""

import json

import pytest
import torch

from qldpc_tpu_torch.codes import get_code
from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
from qldpc_tpu_torch.decoders import osd as osd_module
from qldpc_tpu_torch.mc import DEMEngine, DEMEngineConfig, EngineConfig, MonteCarloEngine
from qldpc_tpu_torch.mc.metrics import Counters
from qldpc_tpu_torch.ops import osd_factored_cuda
from qldpc_tpu_torch.noise.circuit import parametric_memory_dem
from qldpc_tpu_torch.utils import profiling

torch.set_num_threads(2)

STAGES = ["qldpc.sample", "qldpc.bp", "qldpc.osd", "qldpc.classify"]


def _cc_engine(batch=64):
    """[[72]] code capacity, OSD-0 by rows."""
    cfg = EngineConfig(bp=BPConfig(max_iter=10, method="min-sum"), batch_size=batch)
    eng = MonteCarloEngine(get_code("[[72, 12, 6]]"), cfg, device="cpu")
    assert eng.osd.elimination == "rows"
    return eng


def _st_engine():
    """[[72]] space time over three rounds, BP(100) sum-product + OSD-0."""
    cfg = EngineConfig(bp=BPConfig(max_iter=100, method="sum-product"), channel="space-time",
                       n_rounds=3, batch_size=64)
    return MonteCarloEngine(get_code("[[72, 12, 6]]"), cfg, device="cpu")


def _past_the_block(monkeypatch, code="steane", rounds=3):
    """A memory DEM past K4's block with a column budget of rank(H): OSD-0
    takes the route ``factored+transform``, and at [[72]] over two rounds
    some samples run out of the factored budget."""
    monkeypatch.setattr(osd_module, "SMEM_LIMIT", 0)
    monkeypatch.setattr(osd_module, "BUDGET_SLACK", 0)
    dem = parametric_memory_dem(get_code(code), basis="z", rounds=rounds)
    cfg = DEMEngineConfig(bp=BPConfig(max_iter=5, method="min-sum"),
                          osd=OSDConfig(max_elim_cols=1), batch_size=64)
    eng = DEMEngine(dem, cfg, device="cpu")
    assert eng.osd.elimination == "factored+transform"
    return eng


@pytest.fixture
def factored_dem(monkeypatch):
    return _past_the_block(monkeypatch)


def _profiled(call, tmp_path):
    """Run ``call`` under torch.profiler; its program spans (name, start,
    end), in the order they open."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("cat") == "user_annotation"
             and e.get("ph") == "X" and e["name"].startswith("qldpc.")]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


def _inside(spans, outer):
    _, lo, hi = outer
    return [s for s in spans if s is not outer and lo <= s[1] and s[2] <= hi]


def _same(a: Counters, b: Counters) -> None:
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_registry_keeps_counts_inside_a_batch_only():
    before = profiling.counts()
    profiling.count("test.x", 5)  # outside a batch: dropped
    with profiling.batch():
        profiling.count("test.x", 2)
        with profiling.batch():  # a nested scope is the same batch
            profiling.count("test.x")
    after = profiling.counts()
    assert after.get("test.x", 0) - before.get("test.x", 0) == 3
    assert after["batches"] - before["batches"] == 1
    assert profiling.span("x") is profiling.span("y")  # no profiler: one no-op context


@pytest.mark.parametrize("on_batch", [False, True])
def test_a_profiled_run_shows_each_batch_and_its_stages(factored_dem, tmp_path, on_batch):
    eng = factored_dem
    extra = {"on_batch": lambda *_: None} if on_batch else {}
    spans = _profiled(lambda: eng.run_rate(0.006, 128, seed=5, **extra), tmp_path)
    batches = [s for s in spans if s[0] == "qldpc.batch"]
    assert len(batches) == 2
    assert all(s[0] == "qldpc.batch" or any(_inside([s], b) for b in batches)
               for s in spans)
    for b in batches:
        within = _inside(spans, b)
        top = [s for s in within if not any(_inside([s], o) for o in within if o is not s)]
        assert [s[0] for s in top] == ["qldpc.key", *STAGES, "qldpc.counters"]
        osd = next(s for s in top if s[0] == "qldpc.osd")
        assert {s[0] for s in _inside(within, osd)} == {"qldpc.osd.factored",
                                                        "qldpc.osd.transform"}
        sample = next(s for s in top if s[0] == "qldpc.sample")
        assert [s[0] for s in _inside(within, sample)] == ["qldpc.sample.priors"]


def test_counters_are_the_same_with_and_without_a_profiler(factored_dem, tmp_path):
    eng = factored_dem
    plain = eng.run_rate(0.006, 192, seed=9)
    got = []
    _profiled(lambda: got.append(eng.run_rate(0.006, 192, seed=9)), tmp_path)
    _same(plain, got[0])
    cc = _cc_engine()
    plain = cc.run_rate(0.06, 128, seed=2)
    _profiled(lambda: got.append(cc.run_rate(0.06, 128, seed=2)), tmp_path)
    _same(plain, got[1])
    st = _st_engine()  # its own spans open inside sample and classify
    plain = st.run_rate(0.03, 192, seed=8)
    assert int(plain.osd_invocations) > 0
    _profiled(lambda: got.append(st.run_rate(0.03, 192, seed=8)), tmp_path)
    _same(plain, got[2])


def test_host_syncs_a_code_capacity_batch_are_its_sites():
    """Rows route: the sampler's p and the prior copied to the device, the
    failure count, its ``nonzero``, the overflow copied to the device, and
    with ``on_batch`` the 17 counter fields copied to the host."""
    eng = _cc_engine()
    faults = []

    def on_batch(b, n_batches, total):
        faults.append(int(total.bp_faults))

    for extra in ({"on_batch": on_batch}, {}):
        before = profiling.counts()
        eng.run_rate(0.06, 3 * 64, seed=4, **extra)
        after = profiling.counts()
        n = after["batches"] - before["batches"]
        assert n == 3
        fields = len(Counters._fields) if extra else 0
        assert after["host_syncs"] - before["host_syncs"] == n * (5 + fields)
    # every batch has BP failures, so every batch reads its nonzero
    assert min(b - a for a, b in zip([0] + faults, faults)) > 0


def test_k4g_lanes_are_the_samples_past_the_factored_budget(monkeypatch):
    eng = _past_the_block(monkeypatch, "[[72, 12, 6]]", rounds=2)
    past = []
    eliminate = osd_module.eliminate_factored

    def recorded(*args):
        out = eliminate(*args)
        past.append(int(out[3].sum()))  # overflow
        return out

    monkeypatch.setattr(osd_module, "eliminate_factored", recorded)
    before = profiling.counts()
    eng.run_rate(0.01, 2 * 64, seed=11)
    after = profiling.counts()
    assert len(past) == 2 and sum(past) > 0
    assert after["osd.k4g_lanes"] - before.get("osd.k4g_lanes", 0) == sum(past)


class _FactoredLoop:
    """Records what the factored elimination's loop does, through its first
    kernel (K5a's plain version, a call a block with the block's running
    samples): the blocks and the running samples of each OSD call."""

    def __init__(self, monkeypatch):
        self.calls = []
        y, eliminate = osd_factored_cuda.factored_y_plain, osd_module.eliminate_factored

        def y_recorded(P, lanes, *args):
            self.calls[-1].append(int(lanes.numel()))
            return y(P, lanes, *args)

        def eliminate_recorded(*args):
            self.calls.append([])
            return eliminate(*args)

        monkeypatch.setattr(osd_factored_cuda, "factored_y_plain", y_recorded)
        monkeypatch.setattr(osd_module, "eliminate_factored", eliminate_recorded)

    def blocks(self) -> int:
        return sum(len(c) for c in self.calls)

    def lanes(self) -> int:
        return sum(sum(c) for c in self.calls)


def _delta(before: dict, after: dict, name: str) -> int:
    return after.get(name, 0) - before.get(name, 0)


def test_factored_blocks_and_lanes_are_the_loop_s_own(factored_dem, monkeypatch):
    loop = _FactoredLoop(monkeypatch)
    before = profiling.counts()
    factored_dem.run_rate(0.006, 3 * 64, seed=12)
    after = profiling.counts()
    assert len(loop.calls) == 3 and all(loop.calls)  # every batch reaches the loop
    assert _delta(before, after, "osd.factored_blocks") == loop.blocks()
    assert _delta(before, after, "osd.factored_lanes") == loop.lanes()
    # a block takes the samples still running: never more than the block before
    assert all(a >= b for c in loop.calls for a, b in zip(c, c[1:]))


def test_factored_counts_are_the_same_with_and_without_a_profiler(factored_dem, tmp_path):
    names = ("osd.factored_blocks", "osd.factored_lanes", "host_syncs")
    got = []
    for profiled in (False, True):
        before = profiling.counts()
        if profiled:
            _profiled(lambda: factored_dem.run_rate(0.006, 2 * 64, seed=13), tmp_path)
        else:
            factored_dem.run_rate(0.006, 2 * 64, seed=13)
        after = profiling.counts()
        got.append([_delta(before, after, n) for n in names])
    assert got[0] == got[1] and got[0][0] > 0


def test_host_syncs_a_factored_batch_are_its_sites(factored_dem, monkeypatch):
    """The priors' two copies, the failure count, its ``nonzero``, K4g's
    ``nonzero`` and the overflow's copy a batch (6), and in the loop a
    block's ``nonzero`` and three mask reads (4), and the ``nonzero`` that
    finds no sample left where the loop ends before its last block: the
    factored counters add none."""
    loop = _FactoredLoop(monkeypatch)
    eng = factored_dem
    nb = -(-min(eng.osd.max_cols, eng.osd.n) // osd_factored_cuda.BLOCK_COLS)
    before = profiling.counts()
    eng.run_rate(0.006, 3 * 64, seed=14)
    after = profiling.counts()
    batches = after["batches"] - before["batches"]
    assert batches == 3 and len(loop.calls) == batches
    in_loop = sum(4 * len(c) + (len(c) < nb) for c in loop.calls)
    assert _delta(before, after, "host_syncs") == 6 * batches + in_loop


def _batches_and_inner(spans):
    """Each ``qldpc.batch`` span with the names of the spans inside it."""
    return [(b, _inside(spans, b)) for b in spans if b[0] == "qldpc.batch"]


def test_space_time_spans_lie_inside_their_stages(tmp_path):
    """``qldpc.sample.detectors`` inside ``qldpc.sample`` and
    ``qldpc.classify.fold`` inside ``qldpc.classify``, once each batch."""
    eng = _st_engine()
    spans = _profiled(lambda: eng.run_rate(0.03, 3 * 64, seed=6), tmp_path)
    batches = _batches_and_inner(spans)
    assert len(batches) == 3
    for _, within in batches:
        for outer, inner in (("qldpc.sample", "qldpc.sample.detectors"),
                             ("qldpc.classify", "qldpc.classify.fold")):
            stage = [s for s in within if s[0] == outer]
            assert len(stage) == 1
            assert [s[0] for s in within if s[0] == inner] == [inner]
            assert [s[0] for s in _inside(within, stage[0]) if s[0] == inner] == [inner]


def test_code_capacity_opens_neither_space_time_span(tmp_path):
    eng = _cc_engine()
    spans = _profiled(lambda: eng.run_rate(0.06, 2 * 64, seed=3), tmp_path)
    names = {s[0] for s in spans}
    assert "qldpc.sample" in names and "qldpc.classify" in names
    assert not names & {"qldpc.sample.detectors", "qldpc.classify.fold"}


@pytest.mark.parametrize("kind", ["space-time", "code-capacity"])
def test_host_syncs_a_batch_are_unchanged_by_the_space_time_spans(kind, tmp_path):
    """Space time: p's and q's copies, the priors' copy, the failure count,
    its ``nonzero``, the overflow's copy (6); code capacity: p's copy, the
    prior's, the failure count, its ``nonzero``, the overflow's (5). The
    same under a profiler, where the spans open."""
    eng, p, sites = (_st_engine(), 0.03, 6) if kind == "space-time" else (_cc_engine(), 0.06, 5)
    for profiled in (False, True):
        before = profiling.counts()
        if profiled:
            _profiled(lambda: eng.run_rate(p, 2 * 64, seed=4), tmp_path)
        else:
            eng.run_rate(p, 2 * 64, seed=4)
        after = profiling.counts()
        assert after["batches"] - before["batches"] == 2
        assert after["host_syncs"] - before["host_syncs"] == 2 * sites
