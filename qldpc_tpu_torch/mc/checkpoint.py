"""Mid-sweep checkpointing of Monte-Carlo counters.

Port of qldpc_tpu/mc/checkpoint.py over the port's int64 ``Counters``: the
partial counter bundle of each (code, channel, error rate, seed) is saved
after every batch and a run resumes from the last completed batch. The file
name and the npz schema (``meta`` holding ``{"next_batch": b}`` as JSON, one
array per ``Counters`` field) are the JAX package's, so a checkpoint either
package wrote resumes in the other.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from qldpc_tpu_torch.mc.metrics import Counters, zeros_counters

__all__ = ["CheckpointManager"]


@dataclasses.dataclass
class CheckpointManager:
    directory: str | Path
    every_n_batches: int = 1

    def __post_init__(self):
        self.directory = Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    def _path(self, engine, p: float, seed: int) -> Path:
        safe = (
            f"{engine.code.name}_{engine.config.channel}_p{p:.8g}_s{seed}".replace(
                " ", ""
            ).replace("/", "-")
        )
        return self.directory / f"{safe}.npz"

    def load(self, engine, p: float, seed: int) -> tuple[Counters, int]:
        """The saved counters (CPU int64) and the next batch, or zeros and 0."""
        path = self._path(engine, p, seed)
        if not path.exists():
            return zeros_counters(), 0
        d = np.load(path, allow_pickle=True)
        meta = json.loads(str(d["meta"]))
        fields = {k: torch.from_numpy(np.asarray(d[k], dtype=np.int64))
                  for k in Counters._fields}
        return Counters(**fields), int(meta["next_batch"])

    def save(self, engine, p: float, seed: int, counters: Counters, next_batch: int):
        path = self._path(engine, p, seed)
        arrays = {k: np.asarray(v.cpu(), dtype=np.int64) for k, v in counters._asdict().items()}
        np.savez(path, meta=json.dumps({"next_batch": next_batch}), **arrays)

    def run_rate(
        self, engine, p: float, trials: int, seed: int, alpha=None
    ) -> Counters:
        """Drive ``engine.run_rate`` with resume and periodic saves."""
        total, start = self.load(engine, p, seed)

        def on_batch(b, n_batches, running):
            if (b + 1) % self.every_n_batches == 0 or b + 1 == n_batches:
                self.save(engine, p, seed, running, b + 1)

        return engine.run_rate(
            p, trials, seed=seed, start_batch=start, init=total,
            on_batch=on_batch, alpha=alpha,
        )
