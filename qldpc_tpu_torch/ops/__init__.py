from .tanner import TannerGraph

__all__ = ["TannerGraph"]
