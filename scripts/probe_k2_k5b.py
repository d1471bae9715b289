"""Probe an earlier version of K5b (the factored W product) and K2 (the row
GF(2) elimination) against the tree's own, on one CUDA device.

    mkdir -p tree_check/old
    git archive <commit> qldpc_tpu_torch/ops/csrc | tar -x -C tree_check/old
    python3 scripts/probe_k2_k5b.py --old-csrc tree_check/old/qldpc_tpu_torch/ops/csrc

The earlier sources are inputs (``gf2_factored.cu`` and ``gf2_elim.cu``
with the C entry points they had at 71bd0dc: K5b launched as now, K2 on
packed rows with a warp count); nothing of them is kept in the package.
Every kernel is timed warm, in turns (earlier, tree, tree, earlier), between
plain CUDA events around a launch (the host's launch work included) and on
the device alone (``chip_smoke.launch_ms``: the events behind a spin kernel
that lasts until the launch is queued), and the tree's outputs must equal
the earlier kernel's bit for bit:

  K5b  at every block of one OSD call of the factored elimination on the
       [[144,12,12]] DEM's BP(50) failures (B = 1,024, p = 0.002, the inputs
       of chip_smoke.py's phase 12): the earlier kernel whole, its variants
       (text edits of the earlier source: without the H prologue, without
       the Y accumulation, the C stream alone, the Y staging alone; their
       outputs are not compared), the tree's kernel and its variants
       (without the set-bit walk, without H's words, without C). Per block: the
       running samples A, the columns before the block scur, and C's
       density on the words the product reads: the share of (warp, word)
       pairs (32 rows, one coefficient word) holding a set bit, the mean set
       bits of a nonzero thread word, the mean of a nonzero pair's heaviest
       word (the length of a warp's set-bit walk) and the share of set bits;
  K2   the BP(50) failures of 65,536 [[144,12,12]] code-capacity syndromes
       at p = 0.050119 and at p = 0.01 (chip_smoke.py's phase 4 inputs at
       the first rate): the earlier kernel on packed rows, the tree's
       packed-rows entry and its ordered loader (the packed columns of H and
       each sample's order; (b, piv) must equal the packed-rows entry's),
       the ordered loader's variants (text edits of the tree's source:
       without the update of the columns and b, without the trade of two
       positions; outputs not compared),
       and the OSD-0 stage on the same failures as the decoder runs it: the
       earlier path (the permuted copy of H, ``pack_rows``, the earlier K2)
       against the tree's (the ordered loader);
  engines  in turns (earlier, tree, tree, earlier): the code-capacity
       engine with the earlier OSD path against the tree's at p = 0.01 and
       0.050119 (four batches of 65,536), and the [[144]] DEM engine with the
       earlier K5b against the tree's at p = 0.002 (four batches of 1,024).
       ``--rounds N`` runs the four turns N times and logs each side's
       mean and its spread (the largest less the smallest turn).

``--only k5b|k2|engines|variants`` runs one part; ``variants`` is the K5b
part with the earlier kernel and its variants alone (no tree kernel), with
the density and a breakdown of the earlier OSD-0 stage. Prints the card's
name and power limit first. Imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from qldpc_tpu_torch._build import KernelLibrary  # noqa: E402
from qldpc_tpu_torch.ops import dem_bp_cuda  # noqa: E402
from qldpc_tpu_torch.ops import osd_cuda  # noqa: E402
from qldpc_tpu_torch.ops import osd_factored_cuda as ofc  # noqa: E402

_vp, _i = ctypes.c_void_p, ctypes.c_int
OLD_W_DECLARE = {"factored_w_launch": [_vp] * 6 + [_i] * 5 + [_vp]}
OLD_K2_DECLARE = {"gf2_elim_launch": [_vp] * 3 + [_i] * 6 + [_vp]}
OLD_K2_SMEM_BUDGET, OLD_K2_MAX_WARPS = 48 * 1024, 8
REPS = 3
# text edits of the earlier K5b that take one part of it away
NO_H = (("        for (int kk = 0; kk < 32; ++kk)\n            word |= ((Hc[",
         "        for (int kk = 0; kk < 0; ++kk)\n            word |= ((Hc["),)
NO_Y = (("#pragma unroll\n        for (int i = 0; i < 32; ++i) {\n            const uint32_t mask",
         "#pragma unroll\n        for (int i = 0; i < 0; ++i) {\n            const uint32_t mask"),)
NO_C = (("    for (int sw = 0; sw < (scur >> 5); ++sw) {",
         "    for (int sw = 0; sw < 0 && scur; ++sw) {"),)
K5B_VARIANTS = {"earlier": (), "earlier-no-h": NO_H, "earlier-no-y": NO_Y,
                "earlier-c-stream": NO_H + NO_Y, "earlier-y-stage": NO_H + NO_C}
# text edits of the tree's K2 that take one part of a column step away
# (where its time goes; outputs not compared): the update of the columns
# and b, and the trade of two positions in the table
# text edits of the tree's K5b (where its time goes; outputs not compared):
# without the set-bit walk, without H's words, without C (its staging and
# walk)
K5B_TREE_VARIANTS = {
    "tree-no-walk": (("x; x &= x - 1u) {\n                    const uint4 v = ys",
                      "x && sw_n < 0; x &= x - 1u) {\n                    const uint4 v = ys"),),
    "tree-no-h": (("h[q] = k < K ? Hc[", "h[q] = k < 0 && K ? Hc["),),
    "tree-no-c": (("n_chunks = (sw_n + cwords - 1) / cwords;",
                   "n_chunks = 0 * ((sw_n + cwords - 1) / cwords);"),),
}
K2_VARIANTS = {
    "tree-no-elim": (("if (hit) unrolled<MW>", "if (hit && j < 0) unrolled<MW>"),),
    "tree-no-trade": (("if (ppos != (uint32_t)rank) {", "if (ppos != (uint32_t)rank && j < 0) {"),),
}


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


def build(old_dir: Path, work: Path, tree: bool) -> dict:
    """The earlier K5b and its variants, the earlier K2 and (``tree``) all
    the port's libraries, built in parallel; prints ptxas's report on the
    tree's K2 and K5 and on the earlier K2."""
    libs = {name: KernelLibrary(str(variant(old_dir / "gf2_factored.cu", work, name, edits)),
                                OLD_W_DECLARE) for name, edits in K5B_VARIANTS.items()}
    libs["earlier-k2"] = KernelLibrary(str(old_dir / "gf2_elim.cu"), OLD_K2_DECLARE)
    if tree:
        libs.update({name: KernelLibrary(str(variant(osd_cuda._LIB.source, work, name, edits)),
                                         osd_cuda._LIB._declare)
                     for name, edits in K2_VARIANTS.items()})
        libs.update({name: KernelLibrary(str(variant(ofc._LIB.source, work, name, edits)),
                                         ofc._LIB._declare)
                     for name, edits in K5B_TREE_VARIANTS.items()})
    todo = list(libs.values())
    if tree:
        from qldpc_tpu_torch.ops import (bp_cuda, bp_layered_cuda, osd_transform_cuda,
                                         spacetime_bp_cuda)
        todo += [m._LIB for m in (bp_cuda, osd_cuda, dem_bp_cuda, ofc, osd_transform_cuda,
                                  spacetime_bp_cuda, bp_layered_cuda)]
    with ThreadPoolExecutor(len(todo)) as pool:
        list(pool.map(lambda lib: lib.build(), todo))
    reports = [("earlier K2", libs["earlier-k2"])]
    if tree:
        reports += [("tree K2", osd_cuda._LIB), ("tree K5", ofc._LIB)]
    for name, lib in reports:
        for line in lib.build_log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry", "stack")):
                log(f"  ptxas ({name}): {line.strip()}")
    return libs


def old_w(lib, dev):
    """The K5b wrapper of 71bd0dc on ``lib``."""
    def run(C, lanes, ids, Hc, Y, scur):
        A, (B, cw, m_pad) = lanes.shape[0], C.shape
        W = torch.empty((A, m_pad, 4), dtype=torch.int32, device=dev)
        lib.call("factored_w_launch", C.data_ptr(), lanes.data_ptr(), ids.data_ptr(),
                 Hc.data_ptr(), Y.data_ptr(), W.data_ptr(), A, cw, m_pad, Hc.shape[1], scur,
                 torch.cuda.current_stream(dev).cuda_stream)
        return W
    run.launches = 0
    return run


def old_k2(lib):
    """The K2 wrapper of 71bd0dc: a warp a sample, up to 8 warps a block
    under 48 KB of shared memory."""
    def run(A, b, n, max_rank):
        dev = A.device
        B, m, nw = A.shape
        A = A.contiguous().clone()
        b = b.contiguous().clone()
        piv = torch.empty((B, m), dtype=torch.int32, device=dev)
        warps = max(1, min(OLD_K2_MAX_WARPS, OLD_K2_SMEM_BUDGET // (4 * (m * (nw | 1) + 2 * m))))
        lib.call("gf2_elim_launch", A.data_ptr(), b.data_ptr(), piv.data_ptr(), B, m, nw, n,
                 max_rank, warps, torch.cuda.current_stream(dev).cuda_stream)
        return A, b, piv
    run.launches = 0
    return run


def with_lib(module, wrapper, lib):
    """``wrapper`` of ``module`` run with ``lib`` in place of its own."""
    def run(*args):
        own = module._LIB
        module._LIB = lib
        try:
            return wrapper(*args)
        finally:
            module._LIB = own
    run.launches = 0
    return run


def timed(fn, args, reps: int = REPS):
    """``fn`` on a fresh copy of the tensors in ``args``: once to warm up,
    then, over ``reps`` launches each, the mean ms between plain CUDA events
    around a launch and the mean device ms. Returns both and the last output."""
    fresh = lambda: [x.clone() if torch.is_tensor(x) else x for x in args]  # noqa: E731
    fn(*fresh())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    total = dev = 0.0
    out = None
    for _ in range(reps):
        a = fresh()
        torch.cuda.synchronize()
        ev[0].record()
        fn(*a)
        ev[1].record()
        torch.cuda.synchronize()
        total += ev[0].elapsed_time(ev[1])
        a = fresh()
        t, out = cs.launch_ms(lambda: fn(*a))
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


def fmt(d: dict, scale: float = 1.0, digits: int = 4) -> str:
    return ", ".join(f"{k} {v * scale:.{digits}f}" for k, v in d.items())


_LUT = None


def bit_counts(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, as int16 of the same shape."""
    global _LUT
    if _LUT is None or _LUT.device != words.device:
        _LUT = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int16,
                            device=words.device)
    b = _LUT[words.contiguous().view(torch.uint8).long()]
    return b.view(*words.shape, 4).sum(-1, dtype=torch.int16)


def c_density(C, lanes, scur: int, chunk: int = 64) -> dict:
    """C's density on the words K5b reads at one block: (warp, word) pairs
    of 32 rows and one coefficient word."""
    pairs = nz_pairs = nz_words = set_bits = heavy = words = 0
    for a0 in range(0, lanes.shape[0], chunk):
        w = C[lanes[a0: a0 + chunk].long(), : scur // 32]  # (a, sw, m_pad)
        bits = bit_counts(w)
        warp = bits.view(*bits.shape[:2], -1, 32)
        top = warp.amax(-1)
        pairs += top.numel()
        nz_pairs += int((top > 0).sum())
        heavy += int(top.sum(dtype=torch.int64))
        nz_words += int((bits > 0).sum())
        set_bits += int(bits.sum(dtype=torch.int64))
        words += bits.numel()
    return dict(pair_share=nz_pairs / max(pairs, 1), bits_per_word=set_bits / max(nz_words, 1),
                walk=heavy / max(nz_pairs, 1), density=set_bits / max(32 * words, 1))


def dem144_failures(dev):
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


def probe_k5b(libs: dict, eng, order, resid, dev, with_tree: bool) -> None:
    osd = eng.osd
    log(f"K5b probe: {order.shape[0]} BP failures of {cs.DEM_BATCH} at the [[144]] DEM, "
        f"p = 0.002 (m_pad {osd.Hc.shape[1] * 32}, budget {osd.max_cols} columns)")
    tree_w = ofc.factored_w_cuda
    kernels = {k: old_w(libs[k], dev) for k in K5B_VARIANTS}
    if with_tree:
        kernels["tree"] = tree_w
        kernels.update({k: with_lib(ofc, tree_w, libs[k]) for k in K5B_TREE_VARIANTS})
    sums = {kind: dict.fromkeys(kernels, 0.0) for kind in ("event", "device")}
    dens_sum = dict(pairs=0.0, words=0.0, bits=0)

    def probed(C, lanes, ids, Hc, Y, scur):
        A = lanes.shape[0]
        ms, dev_ms, outs = in_turns(kernels, (C, lanes, ids, Hc, Y, scur))
        for k in sums["event"]:
            sums["event"][k] += ms[k]
            sums["device"][k] += dev_ms[k]
        same = not with_tree or torch.equal(outs["tree"], outs["earlier"])
        d = c_density(C, lanes, scur) if scur else dict(pair_share=0.0, bits_per_word=0.0,
                                                        walk=0.0, density=0.0)
        log(f"  K5b block {scur // ofc.BLOCK_COLS}: A={A} scur={scur} us (events): "
            f"{fmt(ms, 1e3, 1)}; us (device): {fmt(dev_ms, 1e3, 1)}; tree == earlier {same}; "
            f"C: nonzero (warp, word) pairs {d['pair_share']:.4f}, set bits a nonzero word "
            f"{d['bits_per_word']:.3f}, a nonzero pair's heaviest word {d['walk']:.3f}, bit "
            f"density {d['density']:.6f}")
        if not same:
            raise AssertionError(f"K5b at scur {scur}: the tree's kernel differs")
        return tree_w(C, lanes, ids, Hc, Y, scur)

    probed.launches = 0
    ofc.factored_w_cuda = probed
    try:
        ofc.eliminate_factored_cuda(order, resid, osd.Hc, osd.h_rank, osd.max_cols)
    finally:
        ofc.factored_w_cuda = tree_w
    torch.cuda.synchronize()
    for kind, s in sums.items():
        log(f"K5b summed over one OSD call (ms, {kind}): {fmt(s)}")


def cc_failures(dev, p: float, H):
    """The BP(50) failures of 65,536 code-capacity syndromes at p, as phase
    4 of chip_smoke.py takes them at p = 0.050119 (seed 0): syndromes,
    posteriors, hard decisions."""
    from qldpc_tpu_torch.decoders import BPConfig, BPDecoder
    from qldpc_tpu_torch.ops.bp_cuda import bp_flooding_cuda

    cfg = BPConfig(max_iter=50)
    dec = BPDecoder(H, cfg).to(dev)
    syn = torch.from_numpy(cs.sample(H, p, cs.K1_BATCH, seed=0)[1]).to(dev)
    prior = torch.full((H.shape[1],), math.log((1 - p) / p), dtype=torch.float32, device=dev)
    kv, kc, _, kh = bp_flooding_cuda(syn, prior, dec.tables(), cfg)
    fail = ~kc
    return syn[fail], kv[fail], kh[fail]


def earlier_forward(old_elim, H_dev):
    """OSDDecoder.forward of 71bd0dc's rows path with ``old_elim`` as K2:
    the (B, m, n) permuted copy of H, ``pack_rows``, the elimination."""
    def forward(self, syndromes, llrs, hard):
        dev = H_dev.device
        syndromes = torch.as_tensor(syndromes, device=dev)
        llrs = torch.as_tensor(llrs, device=dev)
        hard = torch.as_tensor(hard, device=dev).to(torch.int32)
        B, n = hard.shape
        resid = self._residual(syndromes, hard)
        order = torch.argsort(llrs.abs(), dim=1, stable=True)
        bidx = torch.arange(B, device=dev)[:, None]
        Hp = H_dev[:, order].permute(1, 0, 2)
        _, b, piv = old_elim(osd_cuda.pack_rows(Hp), resid, n, self.h_rank)
        tgt = torch.where(piv >= 0, piv, n).long()
        e_perm = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
        e_perm[bidx, tgt] = b
        corr = torch.zeros((B, n), dtype=torch.int32, device=dev)
        corr[bidx, order] = e_perm[:, :n]
        return (hard ^ corr).to(torch.int8)
    return forward


def earlier_stage_split(old_elim, osd, H_dev, syn, llrs, hard) -> str:
    """Device ms of each piece of the earlier rows path on these failures."""
    n = hard.shape[1]
    resid = osd._residual(syn, hard.to(torch.int32))
    order = torch.argsort(llrs.abs(), dim=1, stable=True)
    Hp = H_dev[:, order].permute(1, 0, 2)
    A = osd_cuda.pack_rows(Hp)
    pieces = {
        "residual": lambda: osd._residual(syn, hard.to(torch.int32)),
        "argsort": lambda: torch.argsort(llrs.abs(), dim=1, stable=True),
        "permuted copy": lambda: H_dev[:, order].permute(1, 0, 2),
        "pack_rows": lambda: osd_cuda.pack_rows(Hp),
        "earlier K2": lambda: old_elim(A, resid, n, osd.h_rank),
    }
    return ", ".join(f"{k} {cs.device_ms(fn, 3):.4f}" for k, fn in pieces.items())


def probe_k2(libs: dict, dev, with_tree: bool) -> None:
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import OSDDecoder

    H = get_code(cs.CODE).Hx
    H_dev = torch.from_numpy(H).to(dev)
    old = old_k2(libs["earlier-k2"])
    for p in (cs.REF_P, 0.01):
        syn, llrs, hard = cc_failures(dev, p, H)
        osd = OSDDecoder(H).to(dev)
        resid = osd._residual(syn, hard.to(torch.int32))
        order = torch.argsort(llrs.abs(), dim=1, stable=True)
        A = osd_cuda.pack_rows(H_dev[:, order].permute(1, 0, 2))
        n, m, B = osd.n, osd.m, order.shape[0]
        log(f"K2 on {B} BP failures at p={p} (m={m}, n={n}, rank {osd.h_rank}); the earlier "
            f"OSD-0 stage by piece, ms (device): "
            + earlier_stage_split(old, osd, H_dev, syn, llrs, hard))
        kernels = {"earlier": old}
        if with_tree:
            kernels["tree rows"] = osd_cuda.eliminate_rows_cuda
        ms, dev_ms, outs = in_turns(kernels, (A, resid, n, osd.h_rank))
        pivots = int((outs["earlier"][2] >= 0).sum())
        rows_bound = cs.bound(2 * cs.nbytes(A, resid) + cs.nbytes(outs["earlier"][2]),
                              pivots * m * A.shape[2])
        line = (f"  K2 packed rows: ms (events) {fmt(ms)}; ms (device) {fmt(dev_ms)}; bound "
                f"{rows_bound['bound_ms']:.5f} ({rows_bound['bound_by']})")
        if with_tree:
            same = all(torch.equal(x, y) for x, y in zip(outs["tree rows"], outs["earlier"]))
            log(line + f"; tree == earlier bit for bit {same}")
            if not same:
                raise AssertionError(f"K2 p={p}: the tree's packed-rows entry differs")
            Hc = osd.Hc
            ordered = {"ordered": osd_cuda.eliminate_ordered_cuda,
                       **{k: with_lib(osd_cuda, osd_cuda.eliminate_ordered_cuda, libs[k])
                          for k in K2_VARIANTS}}
            ms, dev_ms, outs2 = in_turns(ordered, (order, resid, Hc, osd.h_rank))
            same = all(torch.equal(x, y) for x, y in zip(outs2["ordered"], outs["earlier"][1:]))
            ob = cs.bound(cs.nbytes(Hc, order.to(torch.int32), resid, *outs2["ordered"]),
                          pivots * m * A.shape[2])
            log(f"  K2 ordered loader: ms (events) {fmt(ms)}; ms (device) {fmt(dev_ms)}; bound "
                f"{ob['bound_ms']:.5f} ({ob['bound_by']}); (b, piv) == the earlier kernel's "
                f"{same}")
            if not same:
                raise AssertionError(f"K2 p={p}: the ordered loader differs")
            stage = {"earlier": types.MethodType(earlier_forward(old, H_dev), osd),
                     "tree": osd.forward}
            ms, dev_ms, outs3 = in_turns({k: (lambda f: lambda *a: f(*a))(f)
                                          for k, f in stage.items()}, (syn, llrs, hard))
            same = torch.equal(outs3["tree"], outs3["earlier"])
            log(f"  OSD-0 stage on the failures: ms (events) {fmt(ms)}; ms (device) "
                f"{fmt(dev_ms)}; solutions identical {same}")
            if not same:
                raise AssertionError(f"OSD-0 p={p}: the tree's solutions differ")
        else:
            log(line)


def spread(rates: dict) -> str:
    """Each side's turns, mean and spread (largest less smallest)."""
    return ", ".join(f"{k} {' / '.join(f'{v:.1f}' for v in vs)} (mean {sum(vs) / len(vs):.1f}, "
                     f"spread {max(vs) - min(vs):.1f})" for k, vs in rates.items())


def probe_engines(libs: dict, dev, dem, rounds: int) -> None:
    from qldpc_tpu_torch.codes import get_code
    from qldpc_tpu_torch.decoders import BPConfig, OSDConfig
    from qldpc_tpu_torch.mc import EngineConfig, MonteCarloEngine

    code = get_code(cs.CODE)
    cc = MonteCarloEngine(code, EngineConfig(
        bp=BPConfig(max_iter=50), osd=OSDConfig(order=0), batch_size=cs.ENGINE_BATCH), device=dev)
    H_dev = torch.from_numpy(code.Hx).to(dev)
    earlier = types.MethodType(earlier_forward(old_k2(libs["earlier-k2"]), H_dev), cc.osd)
    for p in (0.01, cs.REF_P):
        cs.steady_rate(cc, p, cs.ENGINE_BATCH)  # warm
        rates = {"earlier": [], "tree": []}
        for turn in ("earlier", "tree", "tree", "earlier") * rounds:
            if turn == "earlier":
                cc.osd.forward = earlier
            try:
                rates[turn].append(cs.steady_rate(cc, p, 4 * cs.ENGINE_BATCH))
            finally:
                cc.osd.__dict__.pop("forward", None)
        log(f"code-capacity engine p={p}, {4 * cs.ENGINE_BATCH} trials, trials/s in turns: "
            + spread(rates))
    eng, order, resid = dem
    osd = eng.osd
    tree_w, old = ofc.factored_w_cuda, old_w(libs["earlier"], dev)
    args = (order, resid, osd.Hc, osd.h_rank, osd.max_cols)
    cs.steady_rate(eng, 0.002, cs.DEM_BATCH)  # warm
    per_call, rates = {"earlier": [], "tree": []}, {"earlier": [], "tree": []}
    for turn in ("earlier", "tree", "tree", "earlier") * rounds:
        ofc.factored_w_cuda = old if turn == "earlier" else tree_w
        try:
            per_call[turn].append(cs.cuda_ms(lambda: ofc.eliminate_factored_cuda(*args), reps=3))
            rates[turn].append(cs.steady_rate(eng, 0.002, 4 * cs.DEM_BATCH))
        finally:
            ofc.factored_w_cuda = tree_w
    log(f"factored elimination on {order.shape[0]} [[144]] DEM failures, ms per OSD call with "
        f"its host syncs, in turns: " + ", ".join(
            f"{k} {' / '.join(f'{v:.3f}' for v in vs)}" for k, vs in per_call.items()))
    log(f"[[144]] DEM engine p=0.002, four batches of {cs.DEM_BATCH}, trials/s in turns: "
        + spread(rates))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-csrc", type=Path, required=True)
    ap.add_argument("--only", choices=("k5b", "k2", "engines", "variants"),
                    help="one part; 'variants' runs the earlier kernels alone")
    ap.add_argument("--rounds", type=int, default=1,
                    help="times the engines' four turns are run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_k2_k5b: needs a CUDA device", file=sys.stderr)
        return 1
    log(cs.card())
    dev = torch.device("cuda:0")
    work = ROOT / "tree_check" / "probe_src"
    work.mkdir(parents=True, exist_ok=True)
    with_tree = args.only != "variants"
    libs = build(args.old_csrc.resolve(), work, with_tree)
    dem = None
    if args.only in (None, "k5b", "engines", "variants"):
        dem = dem144_failures(dev)
    if args.only in (None, "k5b", "variants"):
        probe_k5b(libs, *dem, dev, with_tree)
    if args.only in (None, "k2", "variants"):
        probe_k2(libs, dev, with_tree)
    if args.only in (None, "engines"):
        probe_engines(libs, dev, dem, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
