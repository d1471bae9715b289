# Copied from qldpc_tpu/codes/__init__.py: the port keeps its own copy and imports nothing of qldpc_tpu.
from . import gf2
from .bb import bb_block, make_bb_code, shift_matrix
from .css import CSSCode
from .registry import ALL_CODE_NAMES, BB_CODE_DEFS, BB_CODE_NAMES, get_code, make_steane

__all__ = [
    "gf2",
    "CSSCode",
    "make_bb_code",
    "bb_block",
    "shift_matrix",
    "get_code",
    "make_steane",
    "ALL_CODE_NAMES",
    "BB_CODE_NAMES",
    "BB_CODE_DEFS",
]
