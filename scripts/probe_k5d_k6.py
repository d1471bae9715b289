"""Probe an earlier version of K5d (the factored resolve) and K6 (space-time
BP) against the tree's own, on one CUDA device.

    mkdir -p tree_check/old
    git archive <commit> qldpc_tpu_torch/ops/csrc | tar -x -C tree_check/old
    python3 scripts/probe_k5d_k6.py --old-csrc tree_check/old/qldpc_tpu_torch/ops/csrc

The earlier sources are an input (``gf2_factored.cu`` and ``spacetime_bp.cu``
with the C entry points they had at d2a86bb); nothing of them is kept in the
package. On the inputs of ``chip_smoke.py``'s phases 12 and 15:

  K5d  one OSD call of the factored elimination on the [[144,12,12]] DEM's
       BP(50) failures (B = 1,024, p = 0.002). At every block the earlier
       kernel is timed whole, without its intra-block triangle, without its
       G.P product and without both (copies of its source with that loop cut
       out), and the tree's kernel beside it, in turns, each on a copy of the
       state; the tree's kernel must equal the earlier one bit for bit. Per
       block it prints the running samples, the columns before the block and
       the density of G, of D's strict lower triangle and of its inverse;
       at block 0 also the tree's kernel on 1, 132, 528 and all samples.
  K6   [[144,12,12]] at T = 12, p = 0.008, BP(100), sum-product and min-sum:
       both kernels on the batch of 512, on its non-converging lanes alone
       and on one such lane alone (ms per iteration of one sample), and
       whether they agree bit for bit; the tree's kernel at each cluster
       width and thread count given by --k6-shapes.
  engines  with each kernel swapped in, in turns (earlier, tree, tree,
       earlier): the space-time engine's steady trials/s at p = 0.004 and
       0.008 (four batches of 512), the factored elimination's ms per OSD
       call with its host syncs, and the [[144]] DEM engine's steady
       trials/s at p = 0.002 (four batches of 1,024).

Prints the card's name and power limit first. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import subprocess
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
from qldpc_tpu_torch.ops import spacetime_bp_cuda as stc  # noqa: E402

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_RESOLVE = {"factored_resolve_launch": [_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i, _vp]}
OLD_ST = {"st_bp_launch": [_vp] * 8 + [_i] * 7 + [_f, _i, _f, _i, _f, _f, _i, _f, _i, _i]
          + [_i, _i, _vp]}
# loops of the earlier K5d cut out by the variants
TRIANGLE = "for (int j2 = 0; j2 < K - 1; ++j2) {"
PRODUCT = "for (int t0 = 0; t0 < scur; t0 += TILE) {"


def log(msg: str) -> None:
    print(msg, flush=True)


def variant(src: Path, out_dir: Path, name: str, cuts: tuple[str, ...]) -> Path:
    text = src.read_text()
    for loop in cuts:
        if text.count(loop) != 1:
            raise RuntimeError(f"{src.name}: the loop {loop!r} is not there once")
        text = text.replace(loop, loop.replace("<", "< 0 &&", 1))
    path = out_dir / f"{src.stem}_{name}.cu"
    path.write_text(text)
    return path


def events_ms(fn, reps: int) -> float:
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def density(words: torch.Tensor, bits: int) -> float:
    return cs.popcount(words) / max(1, bits)


def lower_inverse_density(D: torch.Tensor) -> float:
    """D (A, K, K) 0/1 float, strict lower: density of (I + D)^-1 over GF(2),
    as the product (I + N)(I + N^2)(I + N^4)...; diagonal excluded."""
    A, K, _ = D.shape
    eye = torch.eye(K, device=D.device).expand(A, K, K)
    inv, power = eye + D, D
    for _ in range(6):
        power = torch.remainder(power @ power, 2)
        inv = torch.remainder(inv @ (eye + power), 2)
    return float((inv - eye).sum()) / (A * K * (K - 1) / 2)


def probe_k5d(old_dir: Path, work: Path, dev) -> None:
    src = old_dir / "gf2_factored.cu"
    libs = {
        "old": KernelLibrary(str(variant(src, work, "whole", ())), OLD_RESOLVE),
        "old-no-triangle": KernelLibrary(str(variant(src, work, "notri", (TRIANGLE,))), OLD_RESOLVE),
        "old-no-product": KernelLibrary(str(variant(src, work, "noprod", (PRODUCT,))), OLD_RESOLVE),
        "old-neither": KernelLibrary(str(variant(src, work, "neither", (TRIANGLE, PRODUCT))),
                                     OLD_RESOLVE),
    }
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        list(pool.map(lambda lib: lib.build(), [*libs.values(), ofc._LIB]))
    for line in ofc._LIB.build_log.splitlines():
        if "resolve" in line or ("registers" in line and "resolve" in ofc._LIB.build_log):
            log(f"  ptxas (tree K5d): {line.strip()}")

    eng = cs.dem_engine(dev, code=cs.DEM144_CODE, rounds=cs.DEM144_ROUNDS)
    osd = eng.osd
    prob, llr = eng.priors(0.002)
    rng = np.random.default_rng(3)
    mech = rng.random((cs.DEM_BATCH, eng.n_vars)) < prob.cpu().numpy()
    syn = eng._syndrome(torch.from_numpy(mech.astype(np.int8)).to(dev))
    from qldpc_tpu_torch.decoders import BPConfig

    kv, kc, ki, kh = dem_bp_cuda.dem_bp_cuda(syn, llr, eng.bp.tables(), BPConfig(max_iter=50))
    fail = ~kc
    resid = osd._residual(syn[fail], kh[fail].to(torch.int32))
    order = torch.argsort(kv[fail].abs(), dim=1, stable=True)
    log(f"K5d probe: {int(fail.sum())} BP failures of {cs.DEM_BATCH} at the [[144]] DEM, "
        f"p = 0.002 (m_pad {osd.Hc.shape[1] * 32}, budget {osd.max_cols} columns)")

    tree_resolve = ofc.factored_resolve_cuda
    sums = dict.fromkeys([*libs, "tree"], 0.0)

    def old_call(lib, P, C, lanes, prow, blk):
        B, s_max, mw = P.shape
        _, cw, m_pad = C.shape
        lib.call("factored_resolve_launch", P.data_ptr(), C.data_ptr(), lanes.data_ptr(),
                 prow.data_ptr(), lanes.shape[0], s_max, mw, cw, m_pad, blk,
                 torch.cuda.current_stream(dev).cuda_stream)

    def probed(P, C, lanes, prow, blk):
        K = ofc.BLOCK_COLS
        A, m_pad, scur = lanes.shape[0], C.shape[2], blk * K
        times, outs = {}, {}
        for name in [*libs, "tree", "tree", *reversed(libs)]:  # in turns
            Pc = P.clone()
            if name == "tree":
                fn = lambda: tree_resolve(Pc, C, lanes, prow, blk)  # noqa: E731
            else:
                fn = lambda lib=libs[name]: old_call(lib, Pc, C, lanes, prow, blk)  # noqa: E731
            ms = events_ms(fn, reps=3)
            times[name] = times.get(name, 0.0) + ms / 2
            outs[name] = Pc
        same = torch.equal(outs["tree"], outs["old"])
        for name, ms in times.items():
            sums[name] += ms
        pcl = prow.long().clamp(max=m_pad - 1)
        rows = torch.gather(C[lanes.long()], 2, pcl[:, None, :].expand(-1, C.shape[1], -1))
        rows = rows * (prow < m_pad)[:, None, :]
        g = density(rows[:, : scur // 32], A * K * scur) if scur else 0.0
        bits = ofc._unpack(rows[:, blk * 4: blk * 4 + 4].transpose(1, 2)).float()  # (A, K, K)
        D = torch.tril(bits, diagonal=-1)
        n_d = float(D.sum()) / (A * K * (K - 1) / 2)
        log(f"  block {blk}: A={A} scur={scur} " + " ".join(f"{k} {v:.4f}" for k, v in times.items())
            + f" ms; tree == old {same}; density G {g:.4f} N {n_d:.4f} "
            f"N^-1 {lower_inverse_density(D):.4f}")
        if not same:
            raise AssertionError(f"K5d block {blk}: the tree's kernel differs from the earlier one")
        if blk == 0:
            # how block 0's time grows with the samples it runs
            Pc = P.clone()
            for a in (1, 132, 528, A):
                ms = events_ms(lambda: tree_resolve(Pc, C, lanes[:a], prow[:a], blk), reps=5)
                log(f"  block 0, tree kernel on the first {a} samples: {ms:.4f} ms")
        tree_resolve(P, C, lanes, prow, blk)

    probed.launches = 0
    ofc.factored_resolve_cuda = probed
    try:
        ofc.eliminate_factored_cuda(order, resid, osd.Hc, osd.h_rank, osd.max_cols)
    finally:
        ofc.factored_resolve_cuda = tree_resolve
    torch.cuda.synchronize()
    log("K5d probe, summed over one OSD call (ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in sums.items()))


def earlier_k6(old_dir: Path, work: Path, dev):
    """The earlier K6 built from ``old_dir``, as a function with
    ``st_bp``'s arguments (its launch as the earlier wrapper made it)."""
    old = KernelLibrary(str(variant(old_dir / "spacetime_bp.cu", work, "old", ())), OLD_ST)
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda lib: lib.build(), [old, stc._LIB]))

    def old_st(det, priors, tables, T, cfg, alpha=None):
        alpha = cfg.alpha if alpha is None else alpha
        det = det.to(torch.uint8).contiguous()
        B, m, n = det.shape[0], tables.m, tables.n
        per = 4 * (2 * T * m * tables.dc + 5 * T * m + T * n) + T * n + 2 * T * m
        S = max(1, min(16, 72 * 1024 // per))
        values = torch.empty((B, T * (n + m)), dtype=torch.float32, device=dev)
        conv = torch.empty(B, dtype=torch.uint8, device=dev)
        iters = torch.empty(B, dtype=torch.int32, device=dev)
        old.call("st_bp_launch", det.data_ptr(), priors.data_ptr(), priors[T * n:].data_ptr(),
                 tables.check_var.data_ptr(), tables.var_edge.data_ptr(), values.data_ptr(),
                 conv.data_ptr(), iters.data_ptr(), B, T, m, n, tables.dc, tables.dv,
                 0 if cfg.method == "sum-product" else 1, float(alpha), int(alpha != 1.0),
                 float(cfg.offset), int(bool(cfg.offset)), float(cfg.damping),
                 float(1.0 - cfg.damping), int(cfg.damping != 1.0), float(cfg.clip_llr or 0.0),
                 int(cfg.clip_llr is not None), cfg.max_iter, S, 256,
                 torch.cuda.current_stream(dev).cuda_stream)
        return values, conv.bool(), iters, (values < 0).to(torch.int8)

    return old_st


def probe_engines(old_dir: Path, work: Path, dev) -> None:
    from unittest import mock

    from qldpc_tpu_torch.decoders import spacetime_bp as st_decoder

    old_st = earlier_k6(old_dir, work, dev)
    eng = cs.st_engine(dev)
    cs.steady_rate(eng, cs.ST_RATES[0], cs.ST_BATCH)  # warm
    for p in cs.ST_RATES:
        rates = {"earlier": [], "tree": []}
        for name in ("earlier", "tree", "tree", "earlier"):
            if name == "earlier":
                with mock.patch.object(st_decoder, "st_bp", old_st):
                    rates[name].append(cs.steady_rate(eng, p, 4 * cs.ST_BATCH))
            else:
                rates[name].append(cs.steady_rate(eng, p, 4 * cs.ST_BATCH))
        log(f"space-time engine {cs.ST_CODE} T={cs.ST_ROUNDS} p={p}, four batches of "
            f"{cs.ST_BATCH}, trials/s in turns: " + ", ".join(
                f"{k} {' / '.join(f'{v:.1f}' for v in vs)}" for k, vs in rates.items()))
    del eng

    lib = KernelLibrary(str(variant(old_dir / "gf2_factored.cu", work, "whole", ())), OLD_RESOLVE)
    lib.build()
    tree_resolve = ofc.factored_resolve_cuda

    def old_resolve(P, C, lanes, prow, blk):
        B, s_max, mw = P.shape
        _, cw, m_pad = C.shape
        lib.call("factored_resolve_launch", P.data_ptr(), C.data_ptr(), lanes.data_ptr(),
                 prow.data_ptr(), lanes.shape[0], s_max, mw, cw, m_pad, blk,
                 torch.cuda.current_stream(dev).cuda_stream)

    old_resolve.launches = 0
    eng = cs.dem_engine(dev, code=cs.DEM144_CODE, rounds=cs.DEM144_ROUNDS)
    osd = eng.osd
    from qldpc_tpu_torch.decoders import BPConfig

    prob, llr = eng.priors(0.002)
    rng = np.random.default_rng(3)
    mech = rng.random((cs.DEM_BATCH, eng.n_vars)) < prob.cpu().numpy()
    syn = eng._syndrome(torch.from_numpy(mech.astype(np.int8)).to(dev))
    kv, kc, _, kh = dem_bp_cuda.dem_bp_cuda(syn, llr, eng.bp.tables(), BPConfig(max_iter=50))
    resid = osd._residual(syn[~kc], kh[~kc].to(torch.int32))
    order = torch.argsort(kv[~kc].abs(), dim=1, stable=True)
    args = (order, resid, osd.Hc, osd.h_rank, osd.max_cols)
    cs.steady_rate(eng, 0.002, cs.DEM_BATCH)  # warm
    per_call, rates = {"earlier": [], "tree": []}, {"earlier": [], "tree": []}
    for name in ("earlier", "tree", "tree", "earlier"):
        ofc.factored_resolve_cuda = old_resolve if name == "earlier" else tree_resolve
        try:
            per_call[name].append(cs.cuda_ms(lambda: ofc.eliminate_factored_cuda(*args), reps=3))
            rates[name].append(cs.steady_rate(eng, 0.002, 4 * cs.DEM_BATCH))
        finally:
            ofc.factored_resolve_cuda = tree_resolve
    log(f"factored elimination on {order.shape[0]} [[144]] DEM failures, ms per OSD call with "
        f"its host syncs, in turns: " + ", ".join(
            f"{k} {' / '.join(f'{v:.3f}' for v in vs)}" for k, vs in per_call.items()))
    log(f"[[144]] DEM engine p=0.002, four batches of {cs.DEM_BATCH}, trials/s in turns: "
        + ", ".join(f"{k} {' / '.join(f'{v:.1f}' for v in vs)}" for k, vs in rates.items()))


def probe_k6(old_dir: Path, work: Path, dev, shapes: list[tuple[int, int]]) -> None:
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig
    from qldpc_tpu_torch.decoders.spacetime_bp import SpaceTimeBPDecoder
    from qldpc_tpu_torch.noise.spacetime import space_time_prior_llr

    old_st = earlier_k6(old_dir, work, dev)
    for line in stc._LIB.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas (tree K6): {line.strip()}")

    tunable = "_cluster" in inspect.signature(stc.st_bp_cuda).parameters
    H, T, B, p = get_code(cs.ST_CODE).Hx, cs.ST_ROUNDS, cs.ST_BATCH, 0.008
    det = torch.from_numpy(cs.st_detectors(H, T, p, B, seed=4)).to(dev)
    priors = space_time_prior_llr(H.shape[1], H.shape[0], T, p, device=dev)
    for method in ("sum-product", "min-sum"):
        cfg = BPConfig(max_iter=cs.ST_ITERS, method=method)
        tables = SpaceTimeBPDecoder(H, T, cfg).to(dev).tables()
        ref = old_st(det, priors, tables, T, cfg)
        got = stc.st_bp_cuda(det, priors, tables, T, cfg)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, ref))
        late = ~ref[1]
        log(f"K6 {method}: tree == earlier kernel, bit for bit on all {B} lanes: {same}; "
            f"{int(late.sum())} lanes do not converge in {cfg.max_iter} iterations")
        runs = {"batch": det, "late lanes": det[late].contiguous(), "one late lane":
                det[late][:1].contiguous()}
        kernels = {"earlier": lambda d: old_st(d, priors, tables, T, cfg),
                   "tree": lambda d: stc.st_bp_cuda(d, priors, tables, T, cfg)}
        if tunable:
            for C, threads in shapes:
                kernels[f"tree C={C} threads={threads}"] = (
                    lambda d, C=C, t=threads: stc.st_bp_cuda(d, priors, tables, T, cfg,
                                                             _cluster=C, _threads=t))
        for run, d in runs.items():
            order = [*kernels, *reversed(kernels)]
            ms = dict.fromkeys(kernels, 0.0)
            for name in order:
                ms[name] += events_ms(lambda: kernels[name](d), reps=10) / 2
            one = f" ({cfg.max_iter} iterations: " + ", ".join(
                f"{k} {v / cfg.max_iter * 1e3:.2f} us" for k, v in ms.items()) + " per iteration)"
            log(f"K6 {method} {run} ({d.shape[0]} lanes): " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in ms.items()) + (one if run == "one late lane" else ""))
        if tunable:
            for C, threads in shapes:
                out = stc.st_bp_cuda(det, priors, tables, T, cfg, _cluster=C, _threads=threads)
                torch.cuda.synchronize()
                log(f"K6 {method} C={C} threads={threads}: equal to the earlier kernel "
                    f"{all(torch.equal(a, b) for a, b in zip(out, ref))}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-csrc", type=Path, required=True)
    ap.add_argument("--only", choices=("k5d", "k6", "engines"))
    ap.add_argument("--k6-shapes", nargs="*", default=[],
                    help="cluster width x threads a CTA, e.g. 4x448 6x320")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k5d_k6: needs a CUDA device", file=sys.stderr)
        return 1
    log(cs.card())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    work = ROOT / "tree_check" / "probe_src"
    work.mkdir(parents=True, exist_ok=True)
    shapes = [tuple(int(x) for x in s.split("x")) for s in args.k6_shapes]
    if args.only in (None, "k5d"):
        probe_k5d(args.old_csrc.resolve(), work, dev)
    if args.only in (None, "k6"):
        probe_k6(args.old_csrc.resolve(), work, dev, shapes)
    if args.only in (None, "engines"):
        probe_engines(args.old_csrc.resolve(), work, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
