"""The sampler's kernel K8 (ops/threefry_cuda.py) without a card.

K8's arithmetic is the plain threefry2x32 on uint32 words; what the CPU can
hold is everything around it. ``_k8_model`` walks K8's grid as the kernel
does, block by block and thread by thread (``launch_shape``'s geometry, the
row's counter ``base + g*P`` wrapping mod 2^32, the step past 65,535
chunks, the odd stride's dropped word), computes each thread's pair with
``rng.threefry2x32`` and writes it where the kernel stores it; the result
must equal ``counter_uniform_plain`` bit for bit and every output word must
be written exactly once. The card tests (``tests/test_torch_cuda.py -k
k8``) hold the kernel itself to the plain version.
"""

import pytest
import torch

from qldpc_tpu_torch.ops import threefry_cuda
from qldpc_tpu_torch.utils import profiling, rng

torch.set_num_threads(2)

# (batch, stride): the code-capacity [[144]] row, [[144]]'s n + m, the
# [[144]] DEM's mechanisms (odd), one word, [[144]] space-time at T = 12
# (T*n + T*m), a row just past one chunk, batch 1 and odd batches
SHAPES = [(64, 144), (37, 216), (3, 66981), (300, 1), (5, 2592), (9, 514), (1, 145),
          (1, 2)]
KEYS = {"small": (0, 7), "bit31": (0x80000001, 0xFFFFFFFE)}


def _k8_model(k, first_sample, batch, stride):
    P = (stride + 1) // 2
    bx, gy, grid_x, grid_y = threefry_cuda.launch_shape(batch, P)
    assert 1 <= bx * gy <= threefry_cuda._THREADS and grid_y <= threefry_cuda._MAX_GRID_Y
    base = (first_sample * P) & 0xFFFFFFFF
    # every thread of the grid: block (bx_i, by_i), thread (tx, ty)
    bxi, byi, ty, tx = torch.meshgrid(
        torch.arange(grid_x), torch.arange(grid_y), torch.arange(gy), torch.arange(bx),
        indexing="ij")
    g = (bxi * gy + ty).reshape(-1)
    j0 = (byi * bx + tx).reshape(-1)
    live = g < batch
    g, j0 = g[live], j0[live]
    out = torch.full((batch * stride,), float("nan"))
    writes = torch.zeros(batch * stride, dtype=torch.int64)
    k0, k1 = (int(v) for v in k.tolist())
    step = grid_y * bx
    j = j0
    while True:
        run = j < P
        if not bool(run.any()):
            break
        gr, jr = g[run], j[run]
        row = (base + gr * P) & 0xFFFFFFFF
        x0, x1 = rng.threefry2x32(k0, k1, (row + jr) & 0xFFFFFFFF, torch.zeros_like(jr))
        for word, o in ((0, x0), (1, x1)):
            col = 2 * jr + word
            keep = col < stride
            at = gr[keep] * stride + col[keep]
            out[at] = (o[keep] >> 8).to(torch.float32) * (2.0**-24)
            writes.index_add_(0, at, torch.ones_like(at))
        j = j + step
    assert bool((writes == 1).all()), "a word written twice or never"
    return out.reshape(batch, stride)


@pytest.mark.parametrize("key", list(KEYS))
@pytest.mark.parametrize("batch,stride", SHAPES)
def test_k8_model_matches_plain(batch, stride, key):
    k = torch.tensor(KEYS[key], dtype=torch.int64)
    want = rng.counter_uniform_plain(k, 11, batch, stride)
    got = _k8_model(k, 11, batch, stride)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_k8_model_wraps_the_counter_past_2_to_the_32():
    k = torch.tensor(KEYS["bit31"], dtype=torch.int64)
    first = 2**32 // 72 - 3  # first_sample * 72 wraps within the batch
    want = rng.counter_uniform_plain(k, first, 16, 144)
    assert torch.equal(_k8_model(k, first, 16, 144), want)


def test_k8_model_steps_past_the_grid_limit(monkeypatch):
    """More chunks than the grid holds: the threads step by grid_y * bx."""
    monkeypatch.setattr(threefry_cuda, "_MAX_GRID_Y", 3)
    k = torch.tensor(KEYS["small"], dtype=torch.int64)
    assert threefry_cuda.launch_shape(2, 2001)[3] == 3
    assert torch.equal(_k8_model(k, 5, 2, 4001), rng.counter_uniform_plain(k, 5, 2, 4001))


@pytest.mark.parametrize("batch,pairs,want", [
    (65536, 72, (72, 3, 21846, 1)),      # code capacity: 3 rows a block, 216 threads
    (1024, 33491, (256, 1, 1024, 131)),  # the [[144]] DEM
    (512, 1296, (216, 1, 512, 6)),       # [[144]] space-time, T = 12
    (300, 1, (1, 256, 2, 1)),
    (4, 257, (129, 1, 4, 2)),
])
def test_k8_launch_shape(batch, pairs, want):
    assert threefry_cuda.launch_shape(batch, pairs) == want


def test_counter_uniform_takes_the_kernel_on_a_card_only(monkeypatch):
    calls = []

    def fake(k, first_sample, batch, stride, device):
        calls.append((first_sample, batch, stride, device))
        return "kernel"

    monkeypatch.setattr(threefry_cuda, "counter_uniform_cuda", fake)
    k = rng.key(3)
    assert rng.counter_uniform(k, 2, 4, 9, device="cuda") == "kernel"
    assert rng.counter_uniform(k, 2, 4, 9, device=torch.device("cuda", 0)) == "kernel"
    assert calls == [(2, 4, 9, torch.device("cuda")), (2, 4, 9, torch.device("cuda", 0))]
    # the CPU, named or by default, takes the plain int64 version
    want = rng.counter_uniform_plain(k, 2, 4, 9)
    assert torch.equal(rng.counter_uniform(k, 2, 4, 9), want)
    assert torch.equal(rng.counter_uniform(k, 2, 4, 9, device="cpu"), want)
    assert len(calls) == 2
    with pytest.raises(ValueError, match="unsupported device"):
        rng.counter_uniform(k, 2, 4, 9, device="meta")


def test_k8_wrapper_refuses_what_it_does_not_take():
    k = rng.key(3)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        threefry_cuda.counter_uniform_cuda(k, 0, 4, 9, "cpu")
    with pytest.raises(ValueError, match="stride"):
        threefry_cuda.counter_uniform_cuda(k, 0, 4, 0, "cuda")


def test_benchmark_set_up_finds_the_sampler_library():
    """The engines import K8's library, so a scan of the imported modules
    for kernel libraries (what a benchmark's set-up builds) finds it."""
    import sys

    import qldpc_tpu_torch.mc  # noqa: F401
    from qldpc_tpu_torch._build import KernelLibrary

    sources = {v.source.name for mod in list(sys.modules.values())
               if getattr(mod, "__name__", "").startswith("qldpc_tpu_torch.")
               for v in vars(mod).values() if isinstance(v, KernelLibrary)}
    assert "threefry_uniform.cu" in sources
    assert threefry_cuda._LIB.source.is_file()


def test_plain_path_counts_no_kernel_draws():
    before = profiling.counts().get("sample.kernel_draws", 0)
    with profiling.batch():
        rng.counter_uniform(rng.key(1), 0, 8, 144)
    assert profiling.counts().get("sample.kernel_draws", 0) == before
