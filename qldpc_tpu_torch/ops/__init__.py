from qldpc_tpu.ops.tanner import TannerGraph

__all__ = ["TannerGraph"]
