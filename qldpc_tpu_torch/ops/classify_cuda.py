"""Classification on the card: the CUDA kernel K9.

K9 (``csrc/classify.cu``) replaces no Pallas kernel: the JAX package's
qldpc_tpu/mc/engine.py ``_classify`` is XLA code. It computes
``MonteCarloEngine._classify_plain``'s ``Counters`` of a batch in one launch
(after one zeroing of its output), every field the same integer; its header
says what bounds it on the card and how the design answers.

``classify_tables`` builds what K9 reads of the decoding problem, once an
engine: each variable's check list (the column CSR of the decoding matrix:
H, H_st or the DEM's H) and each qubit's logicals as a bitmask (bit i: row i
of L). The fold over rounds is implicit: variable ``t*n + j`` of the data
part is qubit j in round t (``noise/spacetime.py:fold_data_correction``).

``MonteCarloEngine._classify`` is the entry point: the plain torch version
for the CPU, K9 on a card, never a fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from qldpc_tpu_torch._build import KernelLibrary
from qldpc_tpu_torch.mc.metrics import HIST_BINS, Counters
from qldpc_tpu_torch.utils.profiling import count

__all__ = ["ClassifyTables", "classify_tables", "launch_shape", "classify_cuda"]

_THREADS = 256  # K9_THREADS
_FIELDS = 13  # the scalar counters ahead of the four histograms
# rows up to this many variables take a warp a sample, longer ones the block
WARP_MAX_VARS = 4096
# rows up to this many variables lie in at most 32 aligned 8-byte words at any
# offset, a word a lane: one word a thread a step; longer ones four
ONE_WORD_MAX_VARS = 249
_MAX_LOGICALS = 64

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = KernelLibrary(
    "classify.cu",
    {"classify_launch": [_vp] * 10 + [_i] * 7 + [_ll, _i, _i, _i, _vp]},
)


@dataclasses.dataclass(frozen=True)
class ClassifyTables:
    """What K9 reads of a decoding problem: ``m`` checks, ``n_vars``
    variables of which the first ``n * T`` are ``n`` qubits over ``T``
    rounds (T = 1: every variable is a qubit), and the distance."""

    col_ptr: torch.Tensor  # (n_vars + 1,) int32
    col_idx: torch.Tensor  # (nnz,) int32: the checks of each variable, ascending
    lmask: torch.Tensor  # (n,) int64: bit i set where row i of L has the qubit
    m: int
    n_vars: int
    n: int
    T: int
    distance: int
    sm_count: int  # the device's multiprocessors, for the grid (0 on the CPU)


def classify_tables(H, L, n_qubits: int, n_rounds: int, distance: int,
                    device) -> ClassifyTables:
    """K9's tables for decoding matrix ``H`` (m, n_vars) and logicals ``L``
    (k, n_qubits), k <= 64, ``n_rounds`` rounds of ``n_qubits`` data qubits
    ahead of any other variables (0 or 1: none folded), on ``device``."""
    H = torch.as_tensor(np.asarray(H))
    L = np.asarray(L) % 2
    m, n_vars = H.shape
    T = max(int(n_rounds), 1)
    if n_qubits * T > n_vars or L.shape[1] != n_qubits:
        raise ValueError(f"{n_qubits} qubits x {T} rounds do not fit H {tuple(H.shape)} "
                         f"and L {L.shape}")
    if L.shape[0] > _MAX_LOGICALS:
        raise ValueError(f"K9 holds at most {_MAX_LOGICALS} logicals, got {L.shape[0]}")
    # torch's nonzero: a tenth of numpy's time on the [[144]] DEM's 115 MB
    checks, cols = (H & 1).nonzero().unbind(1)  # by check, then variable
    cols, order = torch.sort(cols, stable=True)  # by variable, checks ascending
    col_ptr = torch.zeros(n_vars + 1, dtype=torch.int64)
    col_ptr[1:] = torch.bincount(cols, minlength=n_vars).cumsum(0)
    weights = (L.astype(np.uint64) << np.arange(L.shape[0], dtype=np.uint64)[:, None]).sum(0)
    device = torch.device(device)
    return ClassifyTables(
        col_ptr=col_ptr.to(torch.int32).to(device),
        col_idx=checks[order].to(torch.int32).to(device),
        lmask=torch.from_numpy(weights.astype(np.uint64).view(np.int64)).to(device),
        m=m, n_vars=n_vars, n=n_qubits, T=T, distance=int(distance),
        sm_count=(torch.cuda.get_device_properties(device).multi_processor_count
                  if device.type == "cuda" else 0),
    )


def launch_shape(n_vars: int) -> tuple[int, int]:
    """K9's (warps a sample, words a thread a step): a warp for a row of
    at most ``WARP_MAX_VARS`` variables, else the block's 8; one word where
    the warp covers the row in one step, else four in flight. The grid
    (``csrc/classify.cu:launch``): as many blocks as the device holds at
    once, fewer for a small batch."""
    if n_vars > WARP_MAX_VARS:
        return _THREADS // 32, 4
    return 1, 1 if n_vars <= ONE_WORD_MAX_VARS else 4


def _bytes(t: torch.Tensor, name: str, shape: tuple) -> torch.Tensor:
    if t.dtype not in (torch.int8, torch.uint8, torch.bool):
        raise ValueError(f"{name} must hold bits in bytes (int8, uint8 or bool), got {t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {shape} tensor, got {tuple(t.shape)}")
    return t


def classify_cuda(tables: ClassifyTables, errors, final, syn, converged, iterations, valid,
                  overflow: int = 0, bp_only: bool = False) -> Counters:
    """Launch K9: the batch's ``Counters`` on the card, each field a view of
    one int64 buffer allocated anew every call. ``errors`` and ``final`` are
    (B, n_vars) bits, ``syn`` (B, m) bits, ``converged`` (B,) bool,
    ``iterations`` (B,) int32, ``valid`` (B,) bool, the samples that count,
    all on one CUDA device; ``overflow`` is added to ``osd_overflow``;
    ``bp_only`` counts every BP failure as a logical error and none as an
    OSD invocation."""
    device = errors.device
    if device.type != "cuda":
        raise ValueError("classify_cuda needs a CUDA device")
    B = errors.shape[0]
    t = tables
    if iterations.dtype != torch.int32 or tuple(iterations.shape) != (B,) or \
            not iterations.is_contiguous():
        raise ValueError("iterations must be a contiguous (B,) int32 tensor")
    args = [_bytes(errors, "errors", (B, t.n_vars)), _bytes(final, "final", (B, t.n_vars)),
            _bytes(syn, "syn", (B, t.m)), _bytes(converged, "converged", (B,)), iterations,
            _bytes(valid, "valid", (B,))]
    if any(a.device != device for a in args) or t.col_ptr.device != device:
        raise ValueError("the batch and the tables must lie on one device")
    if (errors.data_ptr() - final.data_ptr()) % 8:
        raise ValueError("errors and final must lie at the same offset modulo 8 bytes "
                         "(K9 reads both in aligned 8-byte words)")
    out = torch.empty(_FIELDS + 4 * HIST_BINS, dtype=torch.int64, device=device)
    _LIB.call(
        "classify_launch", out.data_ptr(), *(a.data_ptr() for a in args),
        t.col_ptr.data_ptr(), t.col_idx.data_ptr(), t.lmask.data_ptr(),
        B, t.n_vars, t.m, t.n, t.T, t.distance, int(bp_only), int(overflow),
        *launch_shape(t.n_vars), t.sm_count,
        torch.cuda.current_stream(device).cuda_stream,
    )
    classify_cuda.launches += 1
    count("classify.kernel_samples", B)
    return Counters(*out[:_FIELDS].unbind(), *out[_FIELDS:].view(4, HIST_BINS).unbind())


classify_cuda.launches = 0
