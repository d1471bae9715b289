"""The port's engines over torch.distributed: N processes against one, and
against the JAX engine on a mesh of the same shape.

Worker processes (tests/torch_dist_worker.py, started as subprocesses by
``parallel.smoke.launch``: gloo over a ``file://`` store, a timeout on the
group and on every process) run each case at 2 and 4 ranks on the CPU. Each
rank draws its slice of one global counter stream, so the counters at every
world size must equal one process's, and the JAX engine's on ``make_mesh(N)``
(conftest.py's virtual CPU devices). The cases run min-sum BP, exact
arithmetic in both packages, at error rates where both draw the same priors
(test_torch_engine.py, test_torch_dem_engine.py), and 100 trials in batches
of 64, so the last batch is cut inside the second rank's slice. The OSD
capacity is per shard: with ``osd_fraction=0.5`` the overflow depends on the
world size, and equals the JAX engine's at each.
"""

import functools

import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code as jax_code
from qldpc_tpu.decoders import BPConfig as JaxBPConfig
from qldpc_tpu.decoders.osd import OSDConfig as JaxOSDConfig
from qldpc_tpu.mc import DEMEngine as JaxDEMEngine
from qldpc_tpu.mc import DEMEngineConfig as JaxDEMEngineConfig
from qldpc_tpu.mc import EngineConfig as JaxEngineConfig
from qldpc_tpu.mc import MonteCarloEngine as JaxEngine
from qldpc_tpu.mc import counters_to_dict as jax_counters_to_dict
from qldpc_tpu.noise.circuit import parametric_memory_dem as jax_parametric_dem
from qldpc_tpu.parallel import make_mesh as jax_mesh
from qldpc_tpu_torch.decoders.alvarado import estimate_alpha
from qldpc_tpu_torch.codes import get_code
from qldpc_tpu_torch.mc import CheckpointManager, counters_to_dict
from qldpc_tpu_torch.parallel import Mesh, make_mesh, smoke

torch.set_num_threads(2)

WORKER = "tests/torch_dist_worker.py"
TIMEOUT = 240  # seconds, for a whole multi-process job

C72 = "[[72, 12, 6]]"
MS = dict(method="min-sum", batch=64, trials=100)
CASES = {
    "steane-code-capacity": dict(MS, code="steane", channel="code-capacity", max_iter=20,
                                 rates=[0.06], seed=3),
    "72-code-capacity": dict(MS, code=C72, channel="code-capacity", max_iter=30,
                             rates=[0.05], seed=3),
    "72-osd-overflow": dict(MS, code=C72, channel="code-capacity", max_iter=30,
                            rates=[0.12], seed=3, osd_fraction=0.5),
    "72-phenomenological": dict(MS, code=C72, channel="phenomenological", max_iter=30,
                                q=0.01, rates=[0.03], seed=1),
    "72-space-time": dict(MS, code=C72, channel="space-time", n_rounds=2, max_iter=20,
                          rates=[0.01], seed=2),
    "steane-dem": dict(MS, code="steane", channel="dem", rounds=3, max_iter=30,
                       rates=[0.006], seed=4),
}
RATE_CASE = dict(MS, name="steane-rate-sharded", code="steane", channel="code-capacity",
                 max_iter=20, rates=[0.03, 0.05, 0.07], seed=5, rate_shards=2)
CKPT_CASE = dict(MS, code=C72, channel="code-capacity", max_iter=30, rates=[0.05], seed=6,
                 trials=256, stop_after=2)
ALPHA = dict(code="steane", p=0.08, method="min-sum", seed=2)


def _cases():
    return [dict(c, name=name) for name, c in CASES.items()]


@pytest.fixture(scope="module")
def one_rank():
    runs = smoke.run_cases(_cases() + [RATE_CASE], "cpu", meshes=lambda r: Mesh())
    return {r["name"]: r for r in runs}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two-ranks")
    # a checkpoint written by one process, stopped after CKPT_CASE's batches
    eng = smoke.build_engine(CKPT_CASE, "cpu", Mesh())
    p, trials, seed = CKPT_CASE["rates"][0], CKPT_CASE["trials"], CKPT_CASE["seed"]
    total = eng.run_rate(p, CKPT_CASE["stop_after"] * CKPT_CASE["batch"], seed=seed)
    CheckpointManager(tmp / "one").save(eng, p, seed, total, CKPT_CASE["stop_after"])
    job = dict(cases=_cases(), checkpoint=CKPT_CASE, ckpt_dir=str(tmp / "two"),
               resume_dir=str(tmp / "one"), alpha=ALPHA)
    ranks = smoke.launch(2, job, TIMEOUT, script=WORKER)
    return ranks, tmp


@pytest.fixture(scope="module")
def four_ranks():
    return smoke.launch(4, dict(cases=_cases() + [RATE_CASE]), TIMEOUT, script=WORKER)


@functools.cache
def _jax_counters(name: str, devices: int, rate_shards: int = 1) -> list[dict]:
    c = {**smoke.CASE_DEFAULTS, **(RATE_CASE if name == RATE_CASE["name"] else CASES[name])}
    kw = dict(bp=JaxBPConfig(max_iter=c["max_iter"], method=c["method"]),
              osd=JaxOSDConfig(order=0), batch_size=c["batch"], osd_fraction=c["osd_fraction"])
    mesh = jax_mesh(devices, rate_shards=rate_shards)
    code = jax_code(c["code"])
    if c["channel"] == "dem":
        eng = JaxDEMEngine(jax_parametric_dem(code, basis="z", rounds=c["rounds"]),
                           JaxDEMEngineConfig(**kw), mesh=mesh, name=c["code"])
    else:
        eng = JaxEngine(code, JaxEngineConfig(channel=c["channel"], n_rounds=c["n_rounds"],
                                              syndrome_flip_rate=c["q"], **kw), mesh=mesh)
    if rate_shards > 1:
        runs = eng.run_rates_sharded(c["rates"], c["trials"], seed=c["seed"])
    else:
        runs = [eng.run_rate(p, c["trials"], seed=c["seed"] + i) for i, p in enumerate(c["rates"])]
    return [{k: np.asarray(v).tolist() for k, v in jax_counters_to_dict(x).items()} for x in runs]


def _by_name(rank_results: list, name: str) -> list[list[dict]]:
    """Each rank's per-rate counters of one case."""
    return [next(r for r in res["cases"] if r["name"] == name)["per_rate"]
            for res in rank_results]


def _assert_equal(got: list[dict], ref: list[dict], label: str) -> None:
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{label}: {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_counters_equal_at_every_world_size_and_the_jax_engine(name, one_rank, two_ranks,
                                                                four_ranks):
    """Every rank at 2 equals the JAX engine on make_mesh(2); where the OSD
    capacity does not bind, that is one process's counters, and 4 ranks
    give them too (the overflow case is held at 1, 2 and 4 below)."""
    one = one_rank[name]["per_rate"]
    assert one[0]["trials"] == 100
    jax2 = _jax_counters(name, 2)
    for r, got in enumerate(_by_name(two_ranks[0], name)):
        _assert_equal(got, jax2, f"rank {r} of 2 vs JAX on make_mesh(2)")
    if name != "72-osd-overflow":
        _assert_equal(one, jax2, "1 process vs JAX on make_mesh(2)")
        for r, got in enumerate(_by_name(four_ranks, name)):
            _assert_equal(got, one, f"rank {r} of 4 vs 1 process")


def test_osd_capacity_is_per_shard(one_rank, two_ranks, four_ranks):
    """At osd_fraction 0.5 each rank's capacity is half its own slice; the
    overflow at each world size is the JAX engine's on that mesh."""
    case = CASES["72-osd-overflow"]
    for n in (1, 2, 4):
        eng = smoke.build_engine(case, "cpu", Mesh(world_size=n, batch_shards=n))
        assert (eng.local_batch, eng.k_osd) == (64 // n, 32 // n)
    name = "72-osd-overflow"
    runs = {1: [one_rank[name]["per_rate"]], 2: _by_name(two_ranks[0], name),
            4: _by_name(four_ranks, name)}
    for n, ranks in runs.items():
        ref = _jax_counters(name, n)
        assert ref[0]["osd_overflow"] > 0
        for r, got in enumerate(ranks):
            _assert_equal(got, ref, f"rank {r} of {n} vs JAX on make_mesh({n})")


def test_rate_sharded_sweep_pads_and_matches_run_rate(one_rank, four_ranks):
    """4 ranks on a (rate 2, mc 2) mesh over 3 rates (padded to 4): every
    rank gets every rate's counters, equal to per-rate run_rate and to the
    JAX run_rates_sharded on make_mesh(4, rate_shards=2)."""
    name = RATE_CASE["name"]
    one = one_rank[name]["per_rate"]
    assert [d["trials"] for d in one] == [100, 100, 100]
    eng = smoke.build_engine(RATE_CASE, "cpu", Mesh())
    per_rate = [smoke.jsonable(counters_to_dict(eng.run_rate(p, 100, seed=RATE_CASE["seed"] + i)))
                for i, p in enumerate(RATE_CASE["rates"])]
    _assert_equal(one, per_rate, "1-process sweep vs run_rate")
    _assert_equal(_jax_counters(name, 4, rate_shards=2), per_rate, "JAX run_rates_sharded")
    for r, got in enumerate(_by_name(four_ranks, name)):
        _assert_equal(got, per_rate, f"rank {r} of 4")


def test_checkpointed_run_resumes_and_only_rank_0_writes(two_ranks):
    ranks, tmp = two_ranks
    eng = smoke.build_engine(CKPT_CASE, "cpu", Mesh())
    p, trials, seed = CKPT_CASE["rates"][0], CKPT_CASE["trials"], CKPT_CASE["seed"]
    whole = smoke.jsonable(counters_to_dict(eng.run_rate(p, trials, seed=seed)))
    r0, r1 = (r["checkpoint"] for r in ranks)
    assert r0["saves"] == [1, 2, 3, 4, 3, 4] and r1["saves"] == []
    assert r0["stopped_at"] == r1["stopped_at"] == CKPT_CASE["stop_after"]
    for r in (r0, r1):
        # resumed at 2 ranks, from a 2-rank and from a 1-process checkpoint
        _assert_equal([r["resumed"]], [whole], "resumed")
        _assert_equal([r["from_one_process"]], [whole], "resumed from one process's")
    assert sorted(f.name for f in (tmp / "two").iterdir()) == [
        CheckpointManager(tmp / "two")._path(eng, p, seed).name]


def test_every_rank_fits_the_same_alpha(two_ranks):
    alphas = [r["alpha"] for r in two_ranks[0]]
    ref = estimate_alpha(get_code(ALPHA["code"]).Hx, ALPHA["p"], method=ALPHA["method"],
                         seed=ALPHA["seed"], device="cpu")
    assert alphas == [ref, ref]


def test_mesh_of_a_lone_process():
    mesh = make_mesh()
    assert mesh == Mesh() and mesh.shape == {"mc": 1}
    with pytest.raises(ValueError, match="must divide"):
        make_mesh(rate_shards=2)


def test_batch_must_split_evenly():
    with pytest.raises(ValueError, match="must divide evenly"):
        smoke.build_engine(dict(CASES["steane-code-capacity"], batch=63), "cpu",
                           Mesh(world_size=2, batch_shards=2))
