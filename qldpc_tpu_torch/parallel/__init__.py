from .mesh import BATCH_AXIS, RATE_AXIS, Mesh, init_distributed, make_mesh, rank_device

__all__ = ["BATCH_AXIS", "RATE_AXIS", "Mesh", "init_distributed", "make_mesh", "rank_device"]
