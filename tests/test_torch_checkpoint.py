"""The port's ``CheckpointManager``: a run interrupted after k batches and
resumed gives the counters of an uninterrupted run, on code capacity,
space-time and the Steane DEM; and a checkpoint the JAX ``CheckpointManager``
wrote resumes on the port (and the other way round) to the JAX engine's
uninterrupted counters.

The engines key batch b of rate p as fold_in(fold_in(key(seed), hash(p) %
2**31), b) on every path, so a resumed run draws what an uninterrupted one
draws. The cross-package cases run min-sum without alpha, where BP is exact
arithmetic in both packages, so their counters must be identical.
"""

import numpy as np
import pytest
import torch

from qldpc_tpu.codes import get_code as jax_code
from qldpc_tpu.decoders import BPConfig as JaxBPConfig
from qldpc_tpu.decoders.osd import OSDConfig as JaxOSDConfig
from qldpc_tpu.mc import CheckpointManager as JaxCheckpointManager
from qldpc_tpu.mc import DEMEngine as JaxDEMEngine
from qldpc_tpu.mc import DEMEngineConfig as JaxDEMEngineConfig
from qldpc_tpu.mc import EngineConfig as JaxEngineConfig
from qldpc_tpu.mc import MonteCarloEngine as JaxEngine
from qldpc_tpu.mc import counters_to_dict as jax_counters_to_dict
from qldpc_tpu.noise.circuit import parametric_memory_dem as jax_parametric_dem
from qldpc_tpu.parallel import make_mesh
from qldpc_tpu_torch.codes import get_code
from qldpc_tpu_torch.convert import (
    code_from_reference,
    dem_engine_config_from_reference,
    dem_from_reference,
    engine_config_from_reference,
)
from qldpc_tpu_torch.decoders import BPConfig
from qldpc_tpu_torch.mc import (
    CheckpointManager,
    DEMEngine,
    DEMEngineConfig,
    EngineConfig,
    MonteCarloEngine,
    counters_to_dict,
)
from qldpc_tpu_torch.noise.circuit import parametric_memory_dem

torch.set_num_threads(2)

MS = BPConfig(max_iter=20, method="min-sum")


class Interrupted(Exception):
    pass


def _interrupt_after(manager, k: int):
    """Make ``manager`` raise once it has saved the counters of batch k."""
    save = manager.save

    def save_then_stop(engine, p, seed, counters, next_batch):
        save(engine, p, seed, counters, next_batch)
        if next_batch == k:
            raise Interrupted

    manager.save = save_then_stop
    return manager


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def _engine(kind: str):
    if kind == "code-capacity":
        return MonteCarloEngine(get_code("[[72, 12, 6]]"), EngineConfig(bp=MS, batch_size=64),
                                device="cpu")
    if kind == "space-time":
        cfg = EngineConfig(bp=MS, channel="space-time", n_rounds=2, batch_size=64)
        return MonteCarloEngine(get_code("[[72, 12, 6]]"), cfg, device="cpu")
    dem = parametric_memory_dem(get_code("steane"), basis="z", rounds=3)
    return DEMEngine(dem, DEMEngineConfig(bp=MS, batch_size=64), device="cpu", name="steane")


RATES = {"code-capacity": 0.05, "space-time": 0.02, "steane-dem": 0.005}


@pytest.mark.parametrize("kind", list(RATES))
def test_resumed_run_equals_uninterrupted(kind, tmp_path):
    eng, p, trials, seed = _engine(kind), RATES[kind], 300, 4  # 5 batches, the last short
    ref = counters_to_dict(eng.run_rate(p, trials, seed=seed))
    with pytest.raises(Interrupted):
        _interrupt_after(CheckpointManager(tmp_path), 2).run_rate(eng, p, trials, seed)
    manager = CheckpointManager(tmp_path)
    partial, next_batch = manager.load(eng, p, seed)
    assert next_batch == 2 and int(partial.trials) == 128
    assert all(x.dtype == torch.int64 and x.device.type == "cpu" for x in partial)
    got = counters_to_dict(manager.run_rate(eng, p, trials, seed))
    assert _same(got, ref)
    # a finished run resumes to the same counters without drawing again
    assert manager.load(eng, p, seed)[1] == 5
    assert _same(counters_to_dict(manager.run_rate(eng, p, trials, seed)), ref)


def test_on_batch_sees_the_running_counters():
    eng = _engine("code-capacity")
    seen = []
    total = eng.run_rate(0.05, 200, seed=1,
                         on_batch=lambda b, nb, c: seen.append((b, nb, c)))
    assert [(b, nb) for b, nb, _ in seen] == [(0, 4), (1, 4), (2, 4), (3, 4)]
    assert [int(c.trials) for _, _, c in seen] == [64, 128, 192, 200]
    assert all(x.device.type == "cpu" and x.dtype == torch.int64 for x in seen[-1][2])
    assert _same(counters_to_dict(seen[-1][2]), counters_to_dict(total))
    # start_batch with the counters of the batches before it
    resumed = eng.run_rate(0.05, 200, seed=1, start_batch=2, init=seen[1][2])
    assert _same(counters_to_dict(resumed), counters_to_dict(total))


def test_sweep_and_dem_run_resume(tmp_path):
    eng = _engine("code-capacity")
    ref = eng.sweep([0.03, 0.06], trials=150, seed=2)
    with pytest.raises(Interrupted):
        eng.sweep([0.03, 0.06], trials=150, seed=2,
                  checkpoint=_interrupt_after(CheckpointManager(tmp_path / "cc"), 1))
    got = eng.sweep([0.03, 0.06], trials=150, seed=2,
                    checkpoint=CheckpointManager(tmp_path / "cc"))
    assert all(_same(a, b) for a, b in zip(got.per_rate, ref.per_rate))

    dem = _engine("steane-dem")
    ref = dem.run(200, seed=3, p=0.006)
    with pytest.raises(Interrupted):
        dem.run(200, seed=3, p=0.006,
                checkpoint=_interrupt_after(CheckpointManager(tmp_path / "dem"), 1))
    assert _same(dem.run(200, seed=3, p=0.006, checkpoint=CheckpointManager(tmp_path / "dem")),
                 ref)


def _jax_and_port(kind: str):
    ms = JaxBPConfig(max_iter=20, method="min-sum")
    if kind == "code-capacity":
        code = jax_code("[[72, 12, 6]]")
        cfg = JaxEngineConfig(bp=ms, osd=JaxOSDConfig(order=0), batch_size=64)
        return (JaxEngine(code, cfg, mesh=make_mesh(1)),
                MonteCarloEngine(code_from_reference(code), engine_config_from_reference(cfg),
                                 device="cpu"))
    dem = jax_parametric_dem(jax_code("steane"), basis="z", rounds=3)
    cfg = JaxDEMEngineConfig(bp=ms, osd=JaxOSDConfig(order=0), batch_size=64)
    return (JaxDEMEngine(dem, cfg, mesh=make_mesh(1), name="steane"),
            DEMEngine(dem_from_reference(dem), dem_engine_config_from_reference(cfg),
                      device="cpu", name="steane"))


@pytest.mark.parametrize("kind", ["code-capacity", "steane-dem"])
def test_jax_checkpoint_resumes_on_the_port(kind, tmp_path):
    jax_eng, port = _jax_and_port(kind)
    p, trials, seed = RATES[kind], 300, 5
    ref = jax_counters_to_dict(jax_eng.run_rate(p, trials, seed=seed))
    jax_mgr = _interrupt_after(JaxCheckpointManager(tmp_path / "jax"), 2)
    with pytest.raises(Interrupted):
        jax_mgr.run_rate(jax_eng, p, trials, seed)
    port_mgr = CheckpointManager(tmp_path / "jax")
    assert port_mgr._path(port, p, seed) == jax_mgr._path(jax_eng, p, seed)
    assert port_mgr.load(port, p, seed)[1] == 2
    got = counters_to_dict(port_mgr.run_rate(port, p, trials, seed))
    assert _same(got, {k: np.asarray(v) for k, v in ref.items()})

    # and the other way round: the port's checkpoint resumes on JAX
    with pytest.raises(Interrupted):
        _interrupt_after(CheckpointManager(tmp_path / "port"), 3).run_rate(port, p, trials, seed)
    back = jax_counters_to_dict(JaxCheckpointManager(tmp_path / "port").run_rate(
        jax_eng, p, trials, seed))
    assert _same({k: np.asarray(v) for k, v in back.items()},
                 {k: np.asarray(v) for k, v in ref.items()})
