"""Probe an earlier version of K1 (flooding BP) and K4 (the transform GF(2)
elimination) against the tree's own, on one CUDA device.

    mkdir -p tree_check/old
    git archive <commit> qldpc_tpu_torch/ops/csrc | tar -x -C tree_check/old
    python3 scripts/probe_k1_k4.py --old-csrc tree_check/old/qldpc_tpu_torch/ops/csrc

The earlier sources are inputs (``bp_flooding.cu`` and
``gf2_transform_elim.cu`` with the C entry points they had at 9c51abd: K1
launched with samples a block and threads, K4 with one thread a row);
nothing of them is kept in the package. Every kernel is timed warm, in turns
(earlier, tree, tree, earlier), between plain CUDA events around a launch
(the host's launch work included) and on the device alone
(``chip_smoke.launch_ms``: the events behind a spin kernel that lasts until
the launch is queued), and the tree's outputs must equal the earlier
kernel's bit for bit:

  K1  [[144,12,12]] code capacity, BP(50) sum-product, 65,536 syndromes at
      p = 0.01 and 0.050119 (chip_smoke.py's phase 6 inputs), and min-sum
      at p = 0.050119; at each sum-product rate also 65,536 zero syndromes
      (a sample's fixed work), the batch in order of syndrome weight,
      heaviest first (the slow samples start first), the batch's samples
      that run 50 iterations alone, and one of them alone;
  K4  the [[72,12,6]] DEM's BP(50) failures at p = 0.002 (B = 1,024,
      phase 7's inputs), b-exit on and off, and the [[144,12,12]] space-time
      H_st's BP(100) failures at p = 0.008 (B = 512, phase 15's inputs);
      then the µs of one launch on the [[72]] failures walking k = 1 ... 6
      panels of 32 columns (the b-exit off, the columns cut to 32 k);
  engines  the earlier kernel swapped in against the tree's, in turns: the
      code-capacity engine (K1) at p = 0.01 and 0.050119, four batches of
      65,536; the [[72]] DEM engine (K4) at p = 0.002, four batches of
      1,024; the space-time engine (K4) at p = 0.008, four batches of 512.

``--only k1|k4|engines`` runs one part. ``--only variants`` builds the text
edits of ``K1_VARIANTS`` and ``K4_VARIANTS`` beside the tree and times them
in turns with it: K1 at both rates and on one sample that runs 50
iterations, K4 on the [[72]] and H_st failures with the b-exit, and
walking 1 and 4 panels. Prints the card's name and power limit first.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from qldpc_tpu_torch._build import KernelLibrary  # noqa: E402
from qldpc_tpu_torch.ops import bp_cuda  # noqa: E402
from qldpc_tpu_torch.ops import osd_transform_cuda as otc  # noqa: E402

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_K1_DECLARE = {"bp_flooding_launch": [
    _vp, _vp, _i, _vp, _vp, _vp, _vp, _vp,
    _i, _i, _i, _i, _i, _i,
    _f, _i, _f, _i, _f, _f, _i, _f, _i, _i,
    _i, _i, _vp]}
OLD_K1_THREADS, OLD_K1_SMEM_BUDGET, OLD_K1_MAX_SAMPLES = 256, 48 * 1024, 64
REPS = 5
K4_PANELS = (1, 2, 3, 4, 5, 6)
# --only variants: text edits of the tree's sources, built beside it. K1:
# other bounds on the blocks an SM its registers must allow, and the
# run-time-degree instance for the [[144]] code (bit-identical to the tree);
# K4: without the elimination (and so without the T update), or without the
# T update alone (where the time goes; outputs not compared)
K1_VARIANTS = {
    **{f"k1-mb{mb}": (("#define K1_MIN_BLOCKS 4", f"#define K1_MIN_BLOCKS {mb}"),) for mb in (5, 6)},
    "k1-generic": (("dc == 6 && dv == 3 ?", "false ?"),),
}
K4_VARIANTS = {
    "k4-no-elim": (("        if (warp == 0)\n            eliminate_panel(",
                    "        if (warp == 0 && lane == 0) { s_rank = rank; s_npiv = 0; }\n"
                    "        if (false)\n            eliminate_panel("),),
    "k4-no-update": (("        if (npiv == 0) continue;", "        if (npiv >= 0) continue;"),),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def build(old_dir: Path) -> dict:
    """The earlier kernels and the tree's (all the port's libraries, for the
    engines), built in parallel; prints ptxas's report on the tree's K1 and
    K4 and on the earlier ones."""
    from qldpc_tpu_torch.ops import (bp_layered_cuda, dem_bp_cuda, osd_cuda, osd_factored_cuda,
                                     spacetime_bp_cuda)

    old = {"K1": KernelLibrary(str(old_dir / "bp_flooding.cu"), OLD_K1_DECLARE),
           "K4": KernelLibrary(str(old_dir / "gf2_transform_elim.cu"), otc._LIB._declare)}
    tree = [m._LIB for m in (bp_cuda, otc, osd_cuda, dem_bp_cuda, osd_factored_cuda,
                             spacetime_bp_cuda, bp_layered_cuda)]
    with ThreadPoolExecutor(len(tree) + 2) as pool:
        list(pool.map(lambda lib: lib.build(), [*old.values(), *tree]))
    for name, lib in (("tree K1", bp_cuda._LIB), ("tree K4", otc._LIB),
                      ("earlier K1", old["K1"]), ("earlier K4", old["K4"])):
        for line in lib.build_log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry")):
                log(f"  ptxas ({name}): {line.strip()}")
    return old


def old_k1(lib):
    """The K1 wrapper of 9c51abd: S samples a block of 256 threads under 48 KB."""
    def run(syndromes, priors, tables, cfg, alpha=None):
        dev = syndromes.device
        alpha = cfg.alpha if alpha is None else alpha
        B, n, m, dc = syndromes.shape[0], tables.n, tables.m, tables.dc
        per_sample = 4 * (2 * m * dc + 2 * n) + n + m
        S = max(1, min(OLD_K1_MAX_SAMPLES, OLD_K1_SMEM_BUDGET // per_sample))
        syn = syndromes.to(torch.uint8).contiguous()
        priors = priors.contiguous()
        prior_stride = 0 if priors.dim() == 1 else n
        cv, ve = tables.check_var.contiguous(), tables.var_edge.contiguous()
        values = torch.empty((B, n), dtype=torch.float32, device=dev)
        conv = torch.empty(B, dtype=torch.uint8, device=dev)
        iters = torch.empty(B, dtype=torch.int32, device=dev)
        a = float(alpha)
        lib.call("bp_flooding_launch", syn.data_ptr(), priors.data_ptr(), prior_stride,
                 cv.data_ptr(), ve.data_ptr(), values.data_ptr(), conv.data_ptr(),
                 iters.data_ptr(), B, m, n, dc, tables.dv,
                 0 if cfg.method == "sum-product" else 1, a, int(a != 1.0),
                 float(cfg.offset), int(bool(cfg.offset)), float(cfg.damping),
                 float(1.0 - cfg.damping), int(cfg.damping != 1.0),
                 float(cfg.clip_llr or 0.0), int(cfg.clip_llr is not None), cfg.max_iter,
                 S, OLD_K1_THREADS, torch.cuda.current_stream(dev).cuda_stream)
        run.launches += 1
        return values, conv.bool(), iters, (values < 0).to(torch.int8)
    run.launches = 0
    return run


def k4_raw(lib, threads_of):
    """A K4 launch through ``lib`` on ``order``'s columns alone (they may be
    fewer than Hc's rows: the first 32 k of each sample's order)."""
    def run(order, b, Hc, h_rank, b_exit=False):
        dev = b.device
        B, n = order.shape
        m, mw = b.shape[1], Hc.shape[1]
        order32 = order.to(torch.int32).contiguous()
        b = b.to(torch.int32).contiguous().clone()
        T = torch.empty((B, m, mw), dtype=torch.int32, device=dev)
        rank = torch.empty(B, dtype=torch.int32, device=dev)
        piv = torch.empty((B, m), dtype=torch.int32, device=dev)
        lib.call("gf2_transform_elim_launch", order32.data_ptr(), Hc.data_ptr(), T.data_ptr(),
                 b.data_ptr(), rank.data_ptr(), piv.data_ptr(), B, m, mw, n, h_rank,
                 int(b_exit), threads_of(m, B), torch.cuda.current_stream(dev).cuda_stream)
        run.launches += 1
        return T, b, rank, piv
    run.launches = 0
    return run


def timed(fn, args, reps: int = REPS):
    """Warm, then the mean ms between plain events around a launch and the
    mean device ms over ``reps`` launches, and the last output."""
    fn(*args)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    total = dev = 0.0
    out = None
    for _ in range(reps):
        torch.cuda.synchronize()
        ev[0].record()
        fn(*args)
        ev[1].record()
        torch.cuda.synchronize()
        total += ev[0].elapsed_time(ev[1])
        t, out = cs.launch_ms(lambda: fn(*args))
        dev += t
    return total / reps, dev / reps, out


def in_turns(kernels: dict, args, reps: int = REPS):
    ms, dev, outs = dict.fromkeys(kernels, 0.0), dict.fromkeys(kernels, 0.0), {}
    for name in [*kernels, *reversed(kernels)]:
        t, d, out = timed(kernels[name], args, reps)
        ms[name] += t / 2
        dev[name] += d / 2
        outs[name] = out
    return ms, dev, outs


def same(a, b) -> bool:
    return all(torch.equal(x, y) if x.dtype != torch.float32 else
               torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b))


def fmt(d: dict, scale: float = 1.0, digits: int = 4) -> str:
    return ", ".join(f"{k} {v * scale:.{digits}f}" for k, v in d.items())


def probe_k1(old, dev) -> None:
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, BPDecoder

    H = get_code(cs.CODE).Hx
    kernels = {"earlier": old_k1(old["K1"]), "tree": bp_cuda.bp_flooding_cuda}
    for p, method in ((0.01, "sum-product"), (cs.REF_P, "sum-product"), (cs.REF_P, "min-sum")):
        cfg = BPConfig(max_iter=50, method=method)
        tables = BPDecoder(H, cfg).to(dev).tables()
        syn = torch.from_numpy(cs.sample(H, p, cs.K1_BATCH, seed=2)[1]).to(dev)
        prior = torch.full((H.shape[1],), math.log((1 - p) / p), dtype=torch.float32, device=dev)
        ms, dev_ms, outs = in_turns(kernels, (syn, prior, tables, cfg))
        ident = same(outs["tree"], outs["earlier"])
        iters = outs["tree"][2].to(torch.int64)
        b = cs.bp_bound(syn, prior, tables, iters, int(H.sum()))
        log(f"K1 {cs.CODE} BP(50) {method} p={p} B={cs.K1_BATCH}: ms (events) {fmt(ms)}; "
            f"ms (device) {fmt(dev_ms)}; bound {b['bound_ms']:.4f} ({b['bound_by']}); mean "
            f"iterations {iters.float().mean().item():.3f}, {int((iters == 49).sum())} at 50; "
            f"tree == earlier bit for bit {ident}")
        if not ident:
            raise AssertionError(f"K1 p={p} {method}: the tree's kernel differs from the earlier")
        if method == "sum-product":
            # where the time goes: the samples' fixed work (zero syndromes,
            # one iteration each), the batch's late samples alone and one
            late = syn[iters >= 49]
            heavy_first = syn[torch.argsort(syn.sum(1, dtype=torch.int32), descending=True,
                                            stable=True)]
            for what, x in (("zero syndromes", torch.zeros_like(syn)),
                            ("the same syndromes, heaviest first", heavy_first),
                            (f"its {late.shape[0]} samples at 50 iterations alone", late),
                            ("one of them alone", late[:1].contiguous())):
                ms, dev_ms, outs = in_turns(kernels, (x, prior, tables, cfg))
                if not same(outs["tree"], outs["earlier"]):
                    raise AssertionError(f"K1 p={p} on {what}: the tree's kernel differs")
                log(f"  K1 p={p} on {what}: ms (events) {fmt(ms)}; ms (device) {fmt(dev_ms)}; "
                    f"bit-identical True")


def dem_failures(dev):
    """(osd, order, resid) of the [[72]] DEM's BP(50) failures at p = 0.002."""
    from qldpc_tpu_torch.decoders import BPConfig
    from qldpc_tpu_torch.ops import dem_bp_cuda

    eng = cs.dem_engine(dev)
    prob, llr = eng.priors(0.002)
    rng = np.random.default_rng(3)
    mech = rng.random((cs.DEM_BATCH, eng.n_vars)) < prob.cpu().numpy()
    syn = eng._syndrome(torch.from_numpy(mech.astype(np.int8)).to(dev))
    kv, kc, _, kh = dem_bp_cuda.dem_bp_cuda(syn, llr, eng.bp.tables(), BPConfig(max_iter=50))
    resid = eng.osd._residual(syn[~kc], kh[~kc].to(torch.int32))
    return eng, resid, torch.argsort(kv[~kc].abs(), dim=1, stable=True)


def st_failures(dev):
    """(osd, order, resid) of the [[144]] T = 12 space-time BP(100)
    failures at p = 0.008, as phase 15 of chip_smoke.py builds them."""
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, OSDDecoder
    from qldpc_tpu_torch.decoders.spacetime_bp import SpaceTimeBPDecoder
    from qldpc_tpu_torch.noise.spacetime import space_time_matrix, space_time_prior_llr
    from qldpc_tpu_torch.ops.spacetime_bp_cuda import st_bp_cuda

    H, T, B, p = get_code(cs.ST_CODE).Hx, cs.ST_ROUNDS, cs.ST_BATCH, 0.008
    det = torch.from_numpy(cs.st_detectors(H, T, p, B, seed=4)).to(dev)
    priors = space_time_prior_llr(H.shape[1], H.shape[0], T, p, device=dev)
    cfg = BPConfig(max_iter=cs.ST_ITERS)
    kv, kc, _, kh = st_bp_cuda(det, priors, SpaceTimeBPDecoder(H, T, cfg).to(dev).tables(), T,
                               cfg)
    osd = OSDDecoder(space_time_matrix(H, T)).to(dev)
    resid = osd._residual(det[~kc], kh[~kc].to(torch.int32))
    return osd, resid, torch.argsort(kv[~kc].abs(), dim=1, stable=True)


def old_threads(m: int, B: int) -> int:
    return min(1024, -(-m // 32) * 32)


def probe_k4(old, dev, name, osd, resid, order) -> None:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B = order.shape[0]
    new_threads = lambda m, B: otc.launch_shape(m, B, sms)[0]  # noqa: E731
    kernels = {"earlier": k4_raw(old["K4"], old_threads), "tree": k4_raw(otc._LIB, new_threads)}
    for b_exit in (True, False):
        args = (order, resid, osd.Hc, osd.h_rank, b_exit)
        ms, dev_ms, outs = in_turns(kernels, args)
        ref = otc.eliminate_transform_cuda(*args)
        ident = same(outs["tree"], outs["earlier"]) and same(outs["tree"], ref)
        T, b, rank, piv = outs["tree"]
        cols = float((piv.max(dim=1).values.to(torch.int64) + 1).sum())
        panels = (piv.max(dim=1).values.to(torch.int64) // 32 + 1).float()
        bnd = cs.bound(cs.nbytes(order.to(torch.int32), resid, osd.Hc, T, b, rank, piv),
                       cols * osd.m * osd.m_words * 2)
        log(f"K4 {name} b_exit={b_exit}: B={B} m={osd.m} words {osd.m_words}, tree threads "
            f"{new_threads(osd.m, B)} (earlier {old_threads(osd.m, B)}); ms (events) {fmt(ms)}; "
            f"ms (device) {fmt(dev_ms)}; bound {bnd['bound_ms']:.5f} ({bnd['bound_by']}); mean "
            f"rank {rank.float().mean().item():.1f}, panels to the last pivot {panels.mean():.2f} "
            f"mean, {int(panels.max())} max; tree == earlier == wrapper bit for bit {ident}")
        if not ident:
            raise AssertionError(f"K4 {name} b_exit={b_exit}: the tree's kernel differs")


def probe_k4_panels(old, dev, osd, resid, order) -> None:
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    kernels = {"earlier": k4_raw(old["K4"], old_threads),
               "tree": k4_raw(otc._LIB, lambda m, B: otc.launch_shape(m, B, sms)[0])}
    for k in K4_PANELS:
        cut = order[:, :32 * k].contiguous()
        ms, dev_ms, outs = in_turns(kernels, (cut, resid, osd.Hc, osd.h_rank, False))
        ident = same(outs["tree"], outs["earlier"])
        log(f"K4 [[72]] DEM failures walking {k} panel(s), b-exit off: us a launch (events) "
            f"{fmt(ms, 1e3, 1)}; us (device) {fmt(dev_ms, 1e3, 1)}; bit-identical {ident}")
        if not ident:
            raise AssertionError(f"K4 at {k} panels: the tree's kernel differs")


def probe_engines(old, dev, dem_eng) -> None:
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
    from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine

    old_k4 = k4_raw(old["K4"], old_threads)
    cc = MonteCarloEngine(get_code(cs.CODE), EngineConfig(
        bp=BPConfig(max_iter=50), osd=OSDConfig(order=0), batch_size=cs.ENGINE_BATCH), device=dev)
    st = cs.st_engine(dev)
    cells = [("code capacity", cc, 0.01, 4 * cs.ENGINE_BATCH, bp_cuda, "bp_flooding_cuda",
              old_k1(old["K1"])),
             ("code capacity", cc, cs.REF_P, 4 * cs.ENGINE_BATCH, bp_cuda, "bp_flooding_cuda",
              old_k1(old["K1"])),
             ("[[72]] DEM", dem_eng, 0.002, 4 * cs.DEM_BATCH, otc, "eliminate_transform_cuda",
              old_k4),
             ("space-time", st, 0.008, 4 * cs.ST_BATCH, otc, "eliminate_transform_cuda", old_k4)]
    for name, eng, p, trials, module, attr, earlier in cells:
        tree = getattr(module, attr)
        cs.steady_rate(eng, p, trials // 4)  # warm
        rates = {"earlier": [], "tree": []}
        for turn in ("earlier", "tree", "tree", "earlier"):
            setattr(module, attr, earlier if turn == "earlier" else tree)
            try:
                rates[turn].append(cs.steady_rate(eng, p, trials))
            finally:
                setattr(module, attr, tree)
        log(f"{name} engine p={p}, {trials} trials, trials/s in turns: " + ", ".join(
            f"{k} {' / '.join(f'{v:.1f}' for v in vs)}" for k, vs in rates.items()))


def variant_libs(work: Path) -> dict:
    """The tree's K1 and K4 sources with each variant's edits, built in
    parallel; prints ptxas's report on each."""
    libs = {}
    for variants, lib in ((K1_VARIANTS, bp_cuda._LIB), (K4_VARIANTS, otc._LIB)):
        for name, edits in variants.items():
            text = lib.source.read_text()
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"{lib.source.name}: {old!r} is not there once")
                text = text.replace(old, new)
            path = work / f"{lib.source.stem}_{name}.cu"
            path.write_text(text)
            libs[name] = KernelLibrary(str(path), lib._declare)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs.values()))
    for name, lib in libs.items():
        for line in lib.build_log.splitlines():
            if any(k in line for k in ("registers", "spill")):
                log(f"  ptxas ({name}): {line.strip()}")
    return libs


def with_lib(module, wrapper, lib):
    """``wrapper`` of ``module`` run with ``lib`` in place of its own."""
    def run(*args, **kw):
        own = module._LIB
        module._LIB = lib
        try:
            return wrapper(*args, **kw)
        finally:
            module._LIB = own
    run.launches = 0
    return run


def probe_variants(old, libs: dict, dev, dem, st) -> None:
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, BPDecoder

    H = get_code(cs.CODE).Hx
    cfg = BPConfig(max_iter=50)
    tables = BPDecoder(H, cfg).to(dev).tables()
    k1 = {"earlier": old_k1(old["K1"]), "tree": bp_cuda.bp_flooding_cuda,
          **{k: with_lib(bp_cuda, bp_cuda.bp_flooding_cuda, libs[k]) for k in K1_VARIANTS}}
    for p in (0.01, cs.REF_P):
        syn = torch.from_numpy(cs.sample(H, p, cs.K1_BATCH, seed=2)[1]).to(dev)
        prior = torch.full((H.shape[1],), math.log((1 - p) / p), dtype=torch.float32, device=dev)
        iters = bp_cuda.bp_flooding_cuda(syn, prior, tables, cfg)[2]
        for what, x in ((f"B={cs.K1_BATCH}", syn),
                        ("one sample at 50 iterations", syn[iters >= 49][:1].contiguous())):
            ms, dev_ms, outs = in_turns(k1, (x, prior, tables, cfg), reps=3)
            for k in k1:
                if not same(outs[k], outs["earlier"]):
                    raise AssertionError(f"K1 variant {k} differs from the earlier kernel")
            log(f"K1 variants p={p} {what}: ms (device) {fmt(dev_ms)}; all bit-identical")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shape = lambda m, B: otc.launch_shape(m, B, sms)[0]  # noqa: E731
    k4 = {"earlier": k4_raw(old["K4"], old_threads), "tree": k4_raw(otc._LIB, shape),
          **{k: k4_raw(libs[k], shape) for k in K4_VARIANTS}}
    for sys_name, (osd, resid, order) in (("[[72]] DEM", dem), ("space-time H_st", st)):
        for what, args in (
                ("b-exit", (order, resid, osd.Hc, osd.h_rank, True)),
                ("1 panel", (order[:, :32].contiguous(), resid, osd.Hc, osd.h_rank, False)),
                ("4 panels", (order[:, :128].contiguous(), resid, osd.Hc, osd.h_rank, False))):
            ms, dev_ms, outs = in_turns(k4, args, reps=3)
            ident = same(outs["tree"], outs["earlier"])
            log(f"K4 variants {sys_name} failures, {what}: us (device) {fmt(dev_ms, 1e3, 1)}; "
                f"tree bit-identical {ident}")
            if not ident:
                raise AssertionError(f"K4 variants {sys_name} {what}: the tree differs")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-csrc", type=Path, required=True)
    ap.add_argument("--only", choices=("k1", "k4", "engines", "variants"),
                    help="one part; 'variants' builds and times the text edits above alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k1_k4: needs a CUDA device", file=sys.stderr)
        return 1
    log(cs.card())
    dev = torch.device("cuda:0")
    old = build(args.old_csrc.resolve())
    if args.only == "variants":
        work = ROOT / "tree_check" / "probe_src"
        work.mkdir(parents=True, exist_ok=True)
        libs = variant_libs(work)
        eng, resid, order = dem_failures(dev)
        probe_variants(old, libs, dev, (eng.osd, resid, order), st_failures(dev))
        return 0
    if args.only in (None, "k1"):
        probe_k1(old, dev)
    dem_eng = None
    if args.only in (None, "k4", "engines"):
        dem_eng, resid, order = dem_failures(dev)
    if args.only in (None, "k4"):
        probe_k4(old, dev, "[[72]] DEM failures p=0.002", dem_eng.osd, resid, order)
        probe_k4(old, dev, "[[144]] space-time H_st failures p=0.008", *st_failures(dev))
        probe_k4_panels(old, dev, dem_eng.osd, resid, order)
    if args.only in (None, "engines"):
        probe_engines(old, dev, dem_eng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
