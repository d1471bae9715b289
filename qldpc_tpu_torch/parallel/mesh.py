"""Process meshes for the Monte-Carlo engines over ``torch.distributed``.

Port of qldpc_tpu/parallel/mesh.py. JAX shards one program over a device
mesh; here each device runs its own process (``torchrun``, or the
processes ``parallel.smoke`` starts), and a :class:`Mesh` says where the
process sits in the grid:

- ``rate_shards == 1``: a 1-D mesh, every process takes a slice of each
  sample batch (the ``BATCH_AXIS``);
- ``rate_shards > 1``: a 2-D ``(rate, mc)`` mesh. The error-rate grid is
  split into ``rate_shards`` contiguous blocks, one per rate group, and each
  group batch-shards over its processes (``MonteCarloEngine.run_rates_sharded``).
  Process ``r`` sits at ``(r // batch_shards, r % batch_shards)``, the JAX
  layout of ``devices.reshape(rate_shards, -1)``.

Every process of a batch group draws its slice of one global counter-mode
stream, so the counters reduced over the group are those of one process
running the whole batch. The backend is gloo on the host for every device: a
rate moves about a hundred int64 counters, which no device collective would
speed up, and gloo also serves several processes sharing one card.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

__all__ = [
    "BATCH_AXIS", "RATE_AXIS", "Mesh", "init_distributed", "make_mesh", "rank_device",
]

BATCH_AXIS = "mc"
RATE_AXIS = "rate"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the process grid. The default is the 1 x 1
    mesh of a process that runs alone."""

    rank: int = 0  # in the world
    world_size: int = 1
    batch_rank: int = 0  # in the batch group
    batch_shards: int = 1  # processes in a batch group
    rate_index: int = 0  # this process's rate group
    rate_shards: int = 1
    batch_group: object = None  # the batch group's ProcessGroup (None: the world)

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes, as ``dict(jax.sharding.Mesh.shape)`` gives them."""
        if self.rate_shards == 1:
            return {BATCH_AXIS: self.batch_shards}
        return {RATE_AXIS: self.rate_shards, BATCH_AXIS: self.batch_shards}

    def reduce_batch(self, tensors) -> list[torch.Tensor]:
        """Sum int64 tensors over the batch group; the sums come back on the
        CPU, in order."""
        if self.batch_shards == 1:
            return [x.cpu() for x in tensors]
        return _all_reduce(tensors, self.batch_group)

    def reduce_world(self, tensors) -> list[torch.Tensor]:
        """Sum int64 tensors over every process; the sums come back on the
        CPU, in order."""
        if self.world_size == 1:
            return [x.cpu() for x in tensors]
        return _all_reduce(tensors, None)


def _all_reduce(tensors, group) -> list[torch.Tensor]:
    """One all-reduce of the tensors packed into a flat CPU buffer."""
    flat = torch.cat([x.reshape(-1).to("cpu", torch.int64) for x in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = [], 0
    for x in tensors:
        out.append(flat[at:at + x.numel()].view(x.shape))
        at += x.numel()
    return out


def init_distributed(init_method: str = "env://", timeout_s: float = 300.0,
                     rank: int | None = None, world_size: int | None = None) -> None:
    """Join the process group with the gloo backend and a timeout after
    which a collective that waits for a missing process raises. Under
    ``torchrun`` the defaults read everything from the environment; with a
    ``file://`` store give ``rank`` and ``world_size`` (or set ``RANK`` and
    ``WORLD_SIZE``)."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def make_mesh(rate_shards: int = 1) -> Mesh:
    """The mesh over every process of the group, as the JAX ``make_mesh()``
    takes every device; the 1 x 1 mesh in a process that has not joined a
    group. Every process must call it, in the same order: each rate group's
    ``ProcessGroup`` is created collectively."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rate_shards < 1 or world % rate_shards:
        raise ValueError(f"rate_shards={rate_shards} must divide {world} processes")
    per = world // rate_shards
    group = None
    if 1 < rate_shards < world:
        for r in range(rate_shards):
            g = dist.new_group(list(range(r * per, (r + 1) * per)))
            if r == rank // per:
                group = g
    return Mesh(rank=rank, world_size=world, batch_rank=rank % per, batch_shards=per,
                rate_index=rank // per, rate_shards=rate_shards, batch_group=group)


def rank_device() -> torch.device:
    """This process's card: ``cuda:{LOCAL_RANK % device_count}``, so N
    processes on an N-card host take one card each and several processes on
    one card share it. Raises without a card."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "rank_device: torch finds no CUDA device; pass device='cpu' to run "
            "the plain torch versions on the CPU"
        )
    return torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0)) % n}")
