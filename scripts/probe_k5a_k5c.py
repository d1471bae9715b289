"""Probe an earlier version of K5a (the factored Y product) and K5c (the
factored panel elimination) against the tree's own, on one CUDA device.

    mkdir -p tree_check/old
    git archive <commit> qldpc_tpu_torch/ops/csrc | tar -x -C tree_check/old
    python3 scripts/probe_k5a_k5c.py --old-csrc tree_check/old/qldpc_tpu_torch/ops/csrc

The earlier source is an input (``gf2_factored.cu`` with the C entry points
it had at 8b8d32d: K5c launched with a thread count); nothing of it is kept
in the package. On the inputs of ``chip_smoke.py``'s phase 12, one OSD call
of the factored elimination on the [[144,12,12]] DEM's BP(50) failures (B =
1,024, p = 0.002):

Every kernel is timed twice a launch, warm, on a fresh copy of its inputs:
between plain CUDA events around the launch (the host's launch work
included) and on the device alone (``chip_smoke.launch_ms``: the events
behind a spin kernel that lasts until the launch is queued).

  K5a  at every block, the earlier kernel whole, without its product (the
       column gather and P staging alone) and without its column gather (as
       if hoisted out of the kernel), and the tree's kernel, in turns (each
       variant, tree, tree, each variant reversed); the tree's output must
       equal the earlier kernel's bit for bit. Per block: the running samples
       A, the columns before the block scur, the mean set bits and nonzero
       words of a block column of H, and the density of the P rows read.
  K5c  the same with the earlier kernel whole, without its elimination pass
       (the candidate scan, block minimum and barriers alone) and with one
       barrier in place of the block minimum's two (bit-identical); each run
       on a fresh copy of the state. Per block also W's density; at block 0
       the tree's kernel with its launch geometry fixed (a text edit of the
       launcher) at several samples a block and warps a sample.
  host  where a small launch's time goes on the host (the wrapper, its
       ctypes call, the pieces of the wrapper), and events around one call
       against events around 20.
  engines  both earlier kernels swapped in against the tree's, in turns
       (earlier, tree, tree, earlier): the factored elimination's ms per OSD
       call with its host syncs, and the [[144]] DEM engine's steady
       trials/s at p = 0.002 (four batches of 1,024).

Prints the card's name and power limit first. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from qldpc_tpu_torch._build import KernelLibrary  # noqa: E402
from qldpc_tpu_torch.ops import dem_bp_cuda  # noqa: E402
from qldpc_tpu_torch.ops import osd_factored_cuda as ofc  # noqa: E402

_vp, _i = ctypes.c_void_p, ctypes.c_int
OLD_DECLARE = {
    "factored_y_launch": [_vp] * 5 + [_i] * 4 + [_vp],
    "factored_elim_launch": [_vp] * 7 + [_i] * 6 + [_vp],
}
OLD_ELIM_THREADS = 512
# text edits of the earlier source that make each variant
NO_PRODUCT = (("    for (int q = 0; q < KW; ++q) {\n        uint32_t x[32];",
               "    for (int q = 0; q < 0 && KW; ++q) {\n        uint32_t x[32];"),)
NO_GATHER = (("    for (int w = 0; w < mw; ++w) Ht[w * K + tid] = col[w];",
              "    for (int w = 0; w < 0 && mw; ++w) Ht[w * K + tid] = col[w];"),)
NO_ELIM = (("            for (int r = tid; r < m_pad; r += nt) {\n                if (r == p",
            "            for (int r = tid; r < 0 && m_pad; r += nt) {\n                if (r == p"),)
# the block minimum as a warp minimum, one atomicMin and one barrier; two
# slots, the next column's reset behind this column's closing barrier
ONE_BARRIER = (
    ("    __shared__ int s_min;\n", "    __shared__ int s_min;\n    __shared__ int s_mins[2];\n"),
    ("    __syncthreads();\n\n    for (int j = 0; j < K; ++j) {",
     "    if (tid == 0) s_mins[0] = s_mins[1] = 0x7fffffff;\n    __syncthreads();\n\n"
     "    for (int j = 0; j < K; ++j) {"),
    ("        const int p = block_min(first, s_warp, &s_min);",
     "        {\n            const int v = __reduce_min_sync(0xffffffffu, first);\n"
     "            if ((tid & 31) == 0) atomicMin(&s_mins[j & 1], v);\n"
     "            if (tid == 0) s_mins[(j + 1) & 1] = 0x7fffffff;\n        }\n"
     "        __syncthreads();\n        const int p = s_mins[j & 1];"),
)
VARIANTS = {"old": (), "old-no-product": NO_PRODUCT, "old-no-gather": NO_GATHER,
            "old-no-elim": NO_ELIM, "old-one-barrier": ONE_BARRIER}
Y_VARIANTS = ("old", "old-no-product", "old-no-gather")
ELIM_VARIANTS = ("old", "old-no-elim", "old-one-barrier")
# text edits of the tree's source: where the new kernels' time goes (their
# outputs are wrong and not compared)
TREE_VARIANTS = {
    # K5a: the supports and the P staging alone
    "tree-no-product": (("        if (s < scur) {\n            const uint32_t* row",
                         "        if (s < 0 && scur) {\n            const uint32_t* row"),),
    # K5c: W in and C out alone
    "tree-no-columns": (("            for (int i = 0; i < 32; ++i) {\n                __syncwarp();",
                         "            for (int i = 0; i < 0 && 32; ++i) {\n                __syncwarp();"),),
    # K5c: no update of the later columns (the pivot search, row p, b, piv)
    "tree-no-later": (("                    while (later) {", "                    while (0 && later) {"),),
}
TREE_Y_VARIANTS = ("tree-no-product",)
TREE_ELIM_VARIANTS = ("tree-no-columns", "tree-no-later")
# K5c's launch geometry fixed at (samples a block, warps a sample), timed at
# block 0 against the launcher's own choice (bit-identical)
ELIM_SHAPES = ((1, 1), (8, 1), (1, 4), (4, 4), (2, 8))
TREE_VARIANTS.update({
    f"tree-{s}x{g}": (("    const int group = A <= 2 * sms ? ELIM_GROUP : 1;",
                       f"    const int group = {g};"),
                      ("    const int samples = std::min(fit, (A + sms - 1) / sms);",
                       f"    const int samples = std::min(fit, {s});"))
    for s, g in ELIM_SHAPES})


def log(msg: str) -> None:
    print(msg, flush=True)


def variant(src: Path, out_dir: Path, name: str, edits) -> Path:
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{src.name}: {old!r} is not there once")
        text = text.replace(old, new)
    path = out_dir / f"{src.stem}_{name}.cu"
    path.write_text(text)
    return path


def build_variants(old_dir: Path, work: Path) -> dict:
    """The earlier kernels' variants and the tree's, built in parallel with
    the tree's own library; prints ptxas's report on the tree's kernels."""
    libs = {name: KernelLibrary(str(variant(old_dir / "gf2_factored.cu", work, name, edits)),
                                OLD_DECLARE) for name, edits in VARIANTS.items()}
    tree_src = ofc._LIB.source
    libs.update({name: KernelLibrary(str(variant(tree_src, work, name, edits)), ofc._LIB._declare)
                 for name, edits in TREE_VARIANTS.items()})
    report = KernelLibrary(str(variant(tree_src, work, "tree", ())), ofc._LIB._declare)
    with ThreadPoolExecutor(len(libs) + 2) as pool:
        list(pool.map(lambda lib: lib.build(), [*libs.values(), ofc._LIB, report]))
    for line in report.build_log.splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry", "stack")):
            log(f"  ptxas (tree): {line.strip()}")
    return libs


def tree_variant(name: str, lib, dev):
    """The tree's wrapper of K5a or K5c with ``lib`` in place of its own."""
    wrapper = ofc.factored_y_cuda if name in TREE_Y_VARIANTS else ofc.factored_panel_elim_cuda

    def run(*args):
        own = ofc._LIB
        ofc._LIB = lib
        try:
            return wrapper(*args)
        finally:
            ofc._LIB = own
    run.launches = 0
    return run


def old_y(lib, dev):
    def run(P, lanes, ids, Hc, scur):
        A, (B, s_max, mw) = lanes.shape[0], P.shape
        Y = torch.empty((A, scur, 4), dtype=torch.int32, device=dev)
        lib.call("factored_y_launch", P.data_ptr(), lanes.data_ptr(), ids.data_ptr(),
                 Hc.data_ptr(), Y.data_ptr(), A, s_max, mw, scur,
                 torch.cuda.current_stream(dev).cuda_stream)
        return Y
    run.launches = 0
    return run


def old_elim(lib, dev):
    def run(W, b, piv, C, lanes, ids, n, blk):
        A, m_pad, _ = W.shape
        prow = torch.empty((A, ofc.BLOCK_COLS), dtype=torch.int32, device=dev)
        lib.call("factored_elim_launch", W.data_ptr(), b.data_ptr(), piv.data_ptr(),
                 C.data_ptr(), lanes.data_ptr(), ids.data_ptr(), prow.data_ptr(), A, m_pad,
                 C.shape[1], n, blk, OLD_ELIM_THREADS, torch.cuda.current_stream(dev).cuda_stream)
        return prow
    run.launches = 0
    return run


def fresh_copy(args):
    return [x.clone() if torch.is_tensor(x) else x for x in args]


def timed_ms(fn, args, reps: int = 3):
    """``fn`` on a fresh copy of the tensors in ``args``: once to warm up
    (a kernel's module loads at its first launch), then, over ``reps``
    launches each, the mean ms between plain CUDA events around a launch
    (the host's launch work included) and the mean device ms
    (``chip_smoke.launch_ms``). Returns both with the last output and copy."""
    fn(*fresh_copy(args))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    total = dev = 0.0
    for _ in range(reps):
        fresh = fresh_copy(args)
        torch.cuda.synchronize()
        ev[0].record()
        fn(*fresh)
        ev[1].record()
        torch.cuda.synchronize()
        total += ev[0].elapsed_time(ev[1])
        fresh = fresh_copy(args)
        t, out = cs.launch_ms(lambda: fn(*fresh))
        dev += t
    return total / reps, dev / reps, out, fresh


def in_turns(kernels: dict, args) -> tuple[dict, dict, dict]:
    """Each kernel timed in turns (all, then all reversed): event ms, device
    ms, and the outputs of its last run."""
    ms, dev, outs = dict.fromkeys(kernels, 0.0), dict.fromkeys(kernels, 0.0), {}
    for name in [*kernels, *reversed(kernels)]:
        t, d, out, fresh = timed_ms(kernels[name], args)
        ms[name] += t / 2
        dev[name] += d / 2
        outs[name] = (out, fresh)
    return ms, dev, outs


def failures(dev):
    """(engine, order, resid) of the [[144]] DEM's BP(50) failures at p =
    0.002, as phase 12 of chip_smoke.py builds them."""
    from qldpc_tpu_torch.decoders import BPConfig

    eng = cs.dem_engine(dev, code=cs.DEM144_CODE, rounds=cs.DEM144_ROUNDS)
    prob, llr = eng.priors(0.002)
    rng = np.random.default_rng(3)
    mech = rng.random((cs.DEM_BATCH, eng.n_vars)) < prob.cpu().numpy()
    syn = eng._syndrome(torch.from_numpy(mech.astype(np.int8)).to(dev))
    kv, kc, _, kh = dem_bp_cuda.dem_bp_cuda(syn, llr, eng.bp.tables(), BPConfig(max_iter=50))
    resid = eng.osd._residual(syn[~kc], kh[~kc].to(torch.int32))
    order = torch.argsort(kv[~kc].abs(), dim=1, stable=True)
    return eng, order, resid


def probe_blocks(libs: dict, eng, order, resid, dev) -> None:
    osd = eng.osd
    log(f"K5a/K5c probe: {order.shape[0]} BP failures of {cs.DEM_BATCH} at the [[144]] DEM, "
        f"p = 0.002 (m_pad {osd.Hc.shape[1] * 32}, budget {osd.max_cols} columns)")
    tree_y, tree_elim = ofc.factored_y_cuda, ofc.factored_panel_elim_cuda
    ys = {**{k: old_y(libs[k], dev) for k in Y_VARIANTS}, "tree": tree_y,
          **{k: tree_variant(k, libs[k], dev) for k in TREE_Y_VARIANTS}}
    elims = {**{k: old_elim(libs[k], dev) for k in ELIM_VARIANTS}, "tree": tree_elim,
             **{k: tree_variant(k, libs[k], dev) for k in TREE_ELIM_VARIANTS}}
    shapes = {(s, g): tree_variant(f"tree-{s}x{g}", libs[f"tree-{s}x{g}"], dev)
              for s, g in ELIM_SHAPES}
    sums = {kernel: {kind: dict.fromkeys(names, 0.0) for kind in ("event", "device")}
            for kernel, names in (("K5a", ys), ("K5c", elims))}

    def record(kernel, ms, dev_ms) -> str:
        for k in ms:
            sums[kernel]["event"][k] += ms[k]
            sums[kernel]["device"][k] += dev_ms[k]
        return ("us (events, with the host's launch work): "
                + " ".join(f"{k} {v * 1e3:.1f}" for k, v in ms.items())
                + "; us (device): " + " ".join(f"{k} {v * 1e3:.1f}" for k, v in dev_ms.items()))

    def probed_y(P, lanes, ids, Hc, scur):
        A = lanes.shape[0]
        if scur:
            ms, dev_ms, outs = in_turns(ys, (P, lanes, ids, Hc, scur))
            same = torch.equal(outs["tree"][0], outs["old"][0])
            cols = Hc[ids.long()]  # (A, K, mw)
            bits = cs.popcount(cols) / cols.shape[0] / cols.shape[1]
            words = float((cols != 0).sum()) / cols.shape[0] / cols.shape[1]
            dens = cs.popcount(P[lanes.long(), :scur]) / (A * scur * P.shape[2] * 32)
            log(f"  K5a block {scur // ofc.BLOCK_COLS}: A={A} scur={scur} "
                + record("K5a", ms, dev_ms)
                + f"; tree == old {same}; a block column sets {bits:.2f} bits in "
                f"{words:.2f} words; P density {dens:.4f}")
            if not same:
                raise AssertionError(f"K5a at scur {scur}: the tree's kernel differs")
        return tree_y(P, lanes, ids, Hc, scur)

    def probed_elim(W, b, piv, C, lanes, ids, n, blk):
        A, m_pad, _ = W.shape
        ms, dev_ms, outs = in_turns(elims, (W, b, piv, C, lanes, ids, n, blk))
        ref = outs["old"]
        for name in ("tree", "old-one-barrier"):
            got = outs[name]
            same = torch.equal(got[0], ref[0]) and all(
                torch.equal(x, y) for x, y in zip(got[1][:4], ref[1][:4]))
            if not same:
                raise AssertionError(f"K5c block {blk}: {name} differs from the earlier kernel")
        valid = int((ref[0] < m_pad).sum())
        log(f"  K5c block {blk}: A={A} scur={blk * ofc.BLOCK_COLS} " + record("K5c", ms, dev_ms)
            + f"; tree == old == one-barrier True; W density "
            f"{cs.popcount(W) / W.numel() / 32:.4f}; pivots {valid / A:.1f} a sample")
        if blk == 0:
            for (samples, group), shaped in shapes.items():
                t, d, out, fresh = timed_ms(shaped, (W, b, piv, C, lanes, ids, n, blk))
                same = torch.equal(out, ref[0]) and all(
                    torch.equal(x, y) for x, y in zip(fresh[:4], ref[1][:4]))
                if not same:
                    raise AssertionError(f"K5c block 0: {samples} x {group} differs from the "
                                         f"earlier kernel")
                log(f"  K5c block 0, tree kernel at {samples} samples a block, {group} warps a "
                    f"sample: {t * 1e3:.1f} us (events), {d * 1e3:.1f} us (device), bit-identical")
        return tree_elim(W, b, piv, C, lanes, ids, n, blk)

    probed_y.launches = probed_elim.launches = 0
    ofc.factored_y_cuda, ofc.factored_panel_elim_cuda = probed_y, probed_elim
    try:
        ofc.eliminate_factored_cuda(order, resid, osd.Hc, osd.h_rank, osd.max_cols)
    finally:
        ofc.factored_y_cuda, ofc.factored_panel_elim_cuda = tree_y, tree_elim
    torch.cuda.synchronize()
    for kernel, kinds in sums.items():
        for kind, s in kinds.items():
            log(f"{kernel} summed over one OSD call (ms, {kind}): "
                + ", ".join(f"{k} {v:.4f}" for k, v in s.items()))


def probe_engines(libs: dict, eng, order, resid, dev) -> None:
    osd = eng.osd
    tree = (ofc.factored_y_cuda, ofc.factored_panel_elim_cuda)
    old = (old_y(libs["old"], dev), old_elim(libs["old"], dev))
    args = (order, resid, osd.Hc, osd.h_rank, osd.max_cols)
    cs.steady_rate(eng, 0.002, cs.DEM_BATCH)  # warm
    per_call, rates = {"earlier": [], "tree": []}, {"earlier": [], "tree": []}
    for name in ("earlier", "tree", "tree", "earlier"):
        ofc.factored_y_cuda, ofc.factored_panel_elim_cuda = old if name == "earlier" else tree
        try:
            per_call[name].append(cs.cuda_ms(lambda: ofc.eliminate_factored_cuda(*args), reps=3))
            rates[name].append(cs.steady_rate(eng, 0.002, 4 * cs.DEM_BATCH))
        finally:
            ofc.factored_y_cuda, ofc.factored_panel_elim_cuda = tree
    log(f"factored elimination on {order.shape[0]} [[144]] DEM failures, ms per OSD call with "
        f"its host syncs, in turns: " + ", ".join(
            f"{k} {' / '.join(f'{v:.3f}' for v in vs)}" for k, vs in per_call.items()))
    log(f"[[144]] DEM engine p=0.002, four batches of {cs.DEM_BATCH}, trials/s in turns: "
        + ", ".join(f"{k} {' / '.join(f'{v:.1f}' for v in vs)}" for k, vs in rates.items()))


def probe_host(dev) -> None:
    """Where a small launch's time goes on the host: K5a at A = 1, scur =
    128 (10 us of device time), 200 calls without a synchronize, through
    the wrapper, its ctypes call alone and the pieces of the wrapper; then
    CUDA events around one call after a synchronize and around 20 calls."""
    import time

    mw, K = 54, ofc.BLOCK_COLS
    P = torch.zeros((1, 2 * K, mw), dtype=torch.int32, device=dev)
    lanes = torch.zeros(1, dtype=torch.int32, device=dev)
    ids = torch.ones((1, K), dtype=torch.int32, device=dev)
    Hc = torch.ones((2, mw), dtype=torch.int32, device=dev)
    Y = torch.empty((1, K, 4), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    raw = ofc._LIB.lib.factored_y_launch
    ptrs = (P.data_ptr(), lanes.data_ptr(), ids.data_ptr(), Hc.data_ptr(), Y.data_ptr())
    pieces = {
        "wrapper": lambda: ofc.factored_y_cuda(P, lanes, ids, Hc, K),
        "_LIB.call": lambda: ofc._LIB.call("factored_y_launch", *ptrs, 1, 2 * K, mw, K, stream),
        "ctypes function": lambda: raw(*ptrs, 1, 2 * K, mw, K, stream),
        "_check_cuda": lambda: ofc._check_cuda(P, lanes, ids, Hc),
        "torch.empty": lambda: torch.empty((1, K, 4), dtype=torch.int32, device=dev),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
    }
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        log(f"host: {name} {(t1 - t0) / 200 * 1e6:.1f} us a call")
    for n in (1, 20):
        ms = sum(timed_ms(lambda *a: [ofc.factored_y_cuda(*a) for _ in range(n)],
                          (P, lanes, ids, Hc, K))[0] for _ in range(3)) / 3
        log(f"events around {n} K5a call(s) after a synchronize: {ms * 1e3 / n:.1f} us a call")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-csrc", type=Path, required=True)
    ap.add_argument("--only", choices=("blocks", "engines", "host"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k5a_k5c: needs a CUDA device", file=sys.stderr)
        return 1
    log(cs.card())
    dev = torch.device("cuda:0")
    work = ROOT / "tree_check" / "probe_src"
    work.mkdir(parents=True, exist_ok=True)
    libs = build_variants(args.old_csrc.resolve(), work)
    if args.only in (None, "host"):
        probe_host(dev)
    if args.only == "host":
        return 0
    eng, order, resid = failures(dev)
    if args.only in (None, "blocks"):
        probe_blocks(libs, eng, order, resid, dev)
    if args.only in (None, "engines"):
        probe_engines(libs, eng, order, resid, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
