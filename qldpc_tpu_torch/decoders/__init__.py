from .bp import BPConfig, BPDecoder, BPResult
from .osd import OSDConfig, OSDDecoder

__all__ = ["BPConfig", "BPDecoder", "BPResult", "OSDConfig", "OSDDecoder"]
